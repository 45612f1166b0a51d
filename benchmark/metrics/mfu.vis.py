"""mfu: the whole step's share (%) of the card's bf16 peak: the model
operations of the frames of the traced window (counted from the
configuration's shapes, ``harness.flops.frame_flops``) over its seconds,
over 989 TFLOP/s."""

from benchmark.harness import flops


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    per_frame = flops.frame_flops(run.traffic["kind"], run.model, run.traffic)
    return 100.0 * per_frame * tr.units["frames"] / tr.window_s / flops.BF16_TENSOR_FLOPS
