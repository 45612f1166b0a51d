"""msda_rows_roofline.vss: kernel B (`csrc/msda_rows.cu`)'s share (%) of its roofline: the
least time of one call at the main path's shape (``harness.flops.kernel_work``:
max(bytes / 3.35 TB/s, operations / the peak of their type), the frames
of one pixel-decoder call at the traffic's size) over the device time a
call, from the device trace (the time of its kernels over the pixel
decoder's calls times its layers)."""

import re

from benchmark.harness import flops

NAME = re.compile(r"\bmsda_rows(_mma)?_kernel\b")


def read(run):
    tr = run.attribution
    if tr is None:
        return None
    calls = tr.range_count("pixel_decoder") * run.model["pixel_decoder"]["num_layers"]
    kern = tr.kernels(lambda n: NAME.search(n) is not None)
    if not calls or not kern:
        return None
    p = run.model["pixel_decoder"]
    frames = tr.units["frames"] / tr.range_count("pixel_decoder")
    work = flops.kernel_work("msda_rows", frames, flops.level_shapes(run.traffic["height"],
                                                                 run.traffic["width"]),
                             p["hidden_dim"], p["num_heads"], p["num_points"], p["ffn_dim"])
    ms_per_call = sum(k.dur for k in kern) / 1e3 / calls
    return 100.0 * work["bound_ms"] / ms_per_call
