"""train_clips_per_s: the global batch's clips of every step completed
in the window, over the window's host-clock seconds."""


def read(run):
    return run.work["clips"] / run.window_s
