"""finish_ms.vis: host-clock ms of ``finish_vis`` (drain, fetch, RLE) a
video, the mean over the untraced part of the window."""


def read(run):
    spans = run.spans.get("finish_vis")
    return 1e3 * sum(spans) / len(spans) if spans else None
