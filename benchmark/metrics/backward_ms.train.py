"""backward_ms.train: the program's own CUDA-event split of the step
(``make_train_step(timings=)``, ``EVENTS``' ``backward_ms``), ms a step
over the window's steps."""


def read(run):
    ms = run.extra.get("program.backward_ms")
    steps = run.work.get("steps")
    return ms / steps if ms is not None and steps else None
