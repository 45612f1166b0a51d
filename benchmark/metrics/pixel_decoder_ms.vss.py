"""pixel_decoder_ms.vss: device ms a frame of the kernels launched inside the
pixel_decoder's forward calls, from the device trace."""


def read(run):
    tr = run.attribution
    if tr is None or not tr.ops or not tr.range_count("pixel_decoder") or not tr.units.get("frames"):
        return None
    return tr.device_us_in("pixel_decoder") / 1e3 / tr.units["frames"]
