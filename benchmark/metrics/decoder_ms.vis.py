"""decoder_ms.vis: device ms a clip of the kernels launched inside the
decoder's forward calls (one call a clip), from the device trace."""


def read(run):
    tr = run.attribution
    if tr is None or not tr.ops or not tr.range_count("decoder"):
        return None
    return tr.device_us_in("decoder") / 1e3 / tr.range_count("decoder")
