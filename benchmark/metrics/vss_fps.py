"""vss_fps: the frames of every video whose label maps came back in the
window, over the window's host-clock seconds."""


def read(run):
    return run.work["frames"] / run.window_s
