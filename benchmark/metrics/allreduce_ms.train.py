"""allreduce_ms.train: the gradients' all-reduce, ms a step: the program's
own CUDA-event split of the data-parallel step (``make_train_step(timings=)``,
``EVENTS``' ``allreduce_ms``, recorded where ``step.allreduce`` ends: both
label groups' flat float32 buffers summed over the ranks), rank 0's, over
the steps after set-up."""


def read(run):
    ms = run.extra.get("program.allreduce_ms")
    steps = run.work.get("steps")
    return ms / steps if ms is not None and steps else None
