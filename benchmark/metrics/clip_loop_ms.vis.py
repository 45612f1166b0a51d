"""clip_loop_ms.vis: host-clock ms of ``start_vis`` (the window encode
and every clip step of a video) a clip, over the untraced part of the
window."""


def read(run):
    spans = run.spans.get("start_vis")
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * run.extra["clips_per_video"])
