"""collectives.train: device ms a step of the NCCL kernels in rank 0's
device trace (the gradient buffers' all-reduce, the criterion's global
counts, the contrastive columns gathered from every rank, the batch
shard's sizes and the logged losses), over the first traced part's
steps.  A kernel of a collective runs until every rank has reached it,
so its time holds the wait for the slowest rank as well as the
transfer."""


def read(run):
    tr = run.trace
    if tr is None or not tr.units.get("steps"):
        return None
    nccl = tr.kernels(lambda name: "nccl" in name.lower())
    if not nccl:
        return None
    return sum(o.dur for o in nccl) * 1e-3 / tr.units["steps"]
