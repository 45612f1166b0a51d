"""backbone_ms.vss: device ms a frame of the kernels launched inside the
backbone's forward calls, from the device trace."""


def read(run):
    tr = run.attribution
    if tr is None or not tr.ops or not tr.range_count("backbone") or not tr.units.get("frames"):
        return None
    return tr.device_us_in("backbone") / 1e3 / tr.units["frames"]
