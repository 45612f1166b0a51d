"""host_jv_ms.train: host-clock ms a step of the criterion's Hungarian
matching (one host copy of every layer's and video's costs and the JV
walks), timed around ``hungarian_batch`` where the criterion calls it."""


def read(run):
    s = run.extra.get("host_jv_s")
    steps = run.work.get("steps")
    return 1e3 * s / steps if s is not None and steps else None
