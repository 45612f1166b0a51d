"""Raw-video (.mp4) decoding helpers, host-side (the port's copy of
``univs_tpu/data/video.py``, which the port may not import).

The reference decodes mp4 inside its dataset mapper for the raw-video
datasets (custom_videos / InternVid / Pexels / MSR-VTT — reference:
univs/data/dataset_mapper_uni_vid.py:330-345).  Here decoding is a
plain cv2 read-through shared by the mappers and tools/demo.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def read_video_frames(
    path: str,
    indices: Optional[Sequence[int]] = None,
    max_frames: int = 10000,
) -> List[np.ndarray]:
    """Decode RGB frames from a video file.

    indices: frame indices to keep, in caller order, duplicates preserved
    (None = all up to max_frames).  Returns a list of HxWx3 uint8 arrays,
    one per requested index.  Indices beyond the end of the video repeat
    the last decoded frame (clip-tail semantics).
    """
    import cv2

    orig = None if indices is None else [int(i) for i in indices]
    want = None if orig is None else sorted(set(orig))
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    got = {}
    frames: List[np.ndarray] = []
    i = 0
    last = None
    while i < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        last = frame
        if want is None:
            frames.append(frame)
        elif i in want:
            got[i] = frame
            if len(got) == len(want):
                break
        i += 1
    cap.release()
    if want is None:
        if not frames:
            raise ValueError(f"no frames decoded from {path}")
        return frames
    if last is None:
        raise ValueError(f"no frames decoded from {path}")
    # Caller order, duplicates preserved — short videos legitimately request
    # e.g. [0, 1, 2, 2, 2] (replicate/clamp-to-T in the train mapper).
    return [got.get(i, last) for i in orig]


def video_num_frames(path: str, max_frames: int = 10000) -> int:
    """Frame count (cv2 metadata, falling back to a decode sweep)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if n > 0:
        return min(n, max_frames)
    return len(read_video_frames(path, None, max_frames))
