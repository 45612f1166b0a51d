"""vis_fps: the frames of every video whose results came back in the
window, over the window's host-clock seconds."""


def read(run):
    return run.work["frames"] / run.window_s
