"""msda_sample_roofline.vss: kernel A (`csrc/msda_sample.cu`)'s share (%) of its roofline: the
least time of one call at the main path's shape (``harness.flops.kernel_work``:
max(bytes / 3.35 TB/s, operations / the peak of their type), the frames
of one pixel-decoder call at the traffic's size) over the device time a
call, from the device trace (the time of its kernels over the pixel
decoder's calls times its layers)."""

import re

from benchmark.harness import flops

NAME = re.compile(r"\bmsda_sample_kernel\b")


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
    work = flops.kernel_work("msda_sample", frames, flops.level_shapes(run.traffic["height"],
                                                                 run.traffic["width"]),
                             p["hidden_dim"], p["num_heads"], p["num_points"], p["ffn_dim"])
    ms_per_call = sum(k.dur for k in kern) / 1e3 / calls
    return 100.0 * work["bound_ms"] / ms_per_call
