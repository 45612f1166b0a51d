"""Visualize saved video-segmentation results from a YTVIS-format JSON
(counterpart of the JAX package's ``tools/show_results.py``, with its
arguments and printed lines).

Equivalent of the reference's ``demo/show_mask_from_json_video.py`` (and
``show_mask_from_json.py`` for single frames): load a results list
[{video_id, score, category_id, segmentations[RLE per frame]}], join it
against the dataset's valid.json for file names, and write per-video
overlay videos for predictions above a confidence threshold.

    python -m univs_tpu_torch.tools.show_results --results out/results.json \\
        --dataset ytvis_2021_val --output viz/ --conf 0.3

Works from raw files too (no registry needed):

    python -m univs_tpu_torch.tools.show_results --results results.json \\
        --videos-json datasets/ovis/valid.json \\
        --image-root datasets/ovis/valid --output viz/

Host only (cv2, the RLE codec): no model runs, so there is no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np


def show_results(results_path: str, videos_json: str, image_root: str,
                 output: str, conf: float = 0.3, max_videos: int = 0) -> List[Tuple[str, int, int]]:
    """Render overlays; returns [(video_path, n_frames, n_kept)]."""
    import cv2

    from univs_tpu_torch.utils.rle import decode as rle_decode
    from univs_tpu_torch.utils.visualization import overlay_instances, write_video

    with open(results_path) as f:
        results = json.load(f)
    with open(videos_json) as f:
        videos = {v["id"]: v for v in json.load(f)["videos"]}
    by_vid = defaultdict(list)
    for r in results:
        by_vid[r["video_id"]].append(r)

    os.makedirs(output, exist_ok=True)
    written = []
    for vi, (vid, preds) in enumerate(sorted(by_vid.items())):
        if max_videos and vi >= max_videos:
            break
        info = videos.get(vid)
        if info is None:
            print(f"video_id {vid}: not in {videos_json}, skipped")
            continue
        kept = sorted((p for p in preds if p.get("score", 1.0) >= conf),
                      key=lambda p: -p.get("score", 1.0))
        frames_out = []
        for fi, fn in enumerate(info["file_names"]):
            img = cv2.imread(os.path.join(image_root, fn))
            assert img is not None, f"missing frame {fn}"
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            masks = []
            for p in kept:
                seg = p["segmentations"][fi]
                masks.append(rle_decode(seg) if seg is not None
                             else np.zeros(img.shape[:2], np.uint8))
            frames_out.append(overlay_instances(img, masks))
        out_path = os.path.join(output, f"video_{vid}.avi")
        write_video(frames_out, out_path)
        written.append((out_path, len(frames_out), len(kept)))
        print(f"wrote {out_path} ({len(frames_out)} frames, {len(kept)} preds >= {conf})")
    return written


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True, help="results.json (YTVIS format)")
    p.add_argument("--dataset", default=None,
                   help="registered dataset name (resolves valid.json + image root)")
    p.add_argument("--videos-json", default=None, help="explicit valid.json path")
    p.add_argument("--image-root", default=None, help="explicit frame root")
    p.add_argument("--output", default="viz")
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--max-videos", type=int, default=0, help="0 = all")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    videos_json, image_root = args.videos_json, args.image_root
    if args.dataset:
        from univs_tpu_torch.data.datasets import data_root, get_spec

        spec = get_spec(args.dataset)
        videos_json = os.path.join(data_root(), spec.json_path)
        image_root = os.path.join(data_root(), spec.image_root)
    assert videos_json and image_root, "--dataset or --videos-json/--image-root required"
    return show_results(args.results, videos_json, image_root, args.output,
                        conf=args.conf, max_videos=args.max_videos)


if __name__ == "__main__":
    main()
