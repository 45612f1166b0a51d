"""mfu.train: the whole step's share (%) of the cards' bf16 peak: the
forward and backward operations of the traced window's clips, every
rank's (counted from the configuration's shapes,
``harness.flops.train_clip_flops``), over its seconds, over 989 TFLOP/s
a card of the cell."""

from benchmark.harness import flops


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    per_clip = flops.train_clip_flops(run.model, run.traffic)
    peak = flops.BF16_TENSOR_FLOPS * run.cell.chips
    return 100.0 * per_clip * tr.units["clips"] / tr.window_s / peak
