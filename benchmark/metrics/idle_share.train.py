"""idle_share: the share (%) of the traced window in which no operation
ran on the device: 100 (1 - union of the device operations' intervals /
the traced window)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_us() * 1e-6 / tr.window_s)
