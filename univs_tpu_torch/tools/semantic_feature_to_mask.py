"""Reconstruct segmentation masks from SAVED semantic-extraction features
(counterpart of the JAX package's ``tools/semantic_feature_to_mask.py``,
with its arguments, outputs and ``--device``) — the downstream consumer of
``SemanticExtractionDriver``'s output (reference:
semantic_feature_to_mask.py:30-150, the standalone
``ConvertSemanticFeatureToMask`` script).

    python -m univs_tpu_torch.tools.semantic_feature_to_mask features.npz \\
        --weights ckpt [--bank bank.npz] [--out output/semantic_masks] \\
        [--all] [--tiny]

``features.npz`` holds ``obj_tokens`` [T, C, Q] and ``mask_feats``
[T, h, w, C] (plus optionally ``cls_emb``) as produced by
``SemanticExtractionDriver.run`` + ``np.savez``.  ``--weights`` is read by
``load_params`` (a reference UniVS ``.pth``, a trainer checkpoint, a raw
state_dict).  Writes per-query mask grids as PNGs (cv2, when importable)
and a summary JSON of kept query indices + top classes.  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("features", help=".npz with obj_tokens + mask_feats")
    p.add_argument("--weights", default=None, help="reference .pth / trainer checkpoint")
    p.add_argument("--bank", default=None, help="category-bank .npz")
    p.add_argument("--out", default="output/semantic_masks")
    p.add_argument("--all", action="store_true",
                   help="keep every query (no confidence filter)")
    p.add_argument("--tiny", action="store_true", help="tiny test config")
    p.add_argument("--cls-thres", type=float, default=0.65)
    p.add_argument("--quality-thres", type=float, default=0.85)
    p.add_argument("--cls-start", type=int, default=1000)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


def write_grids(mask_logits: np.ndarray, out: str) -> None:
    """Per 10 queries one binary grid (queries x frames at stride T // 5),
    the reference's plot_masks layout (semantic_feature_to_mask.py:121-138)
    without matplotlib; nothing when cv2 is absent, as the JAX tool."""
    try:
        import cv2
    except Exception:
        cv2 = None
    n, T, h, w = mask_logits.shape
    for i in range(0, n, 10):
        chunk = mask_logits[i:i + 10, ::max(T // 5, 1)] > 0
        grid = chunk.transpose(0, 2, 1, 3).reshape(
            chunk.shape[0] * h, chunk.shape[1] * w).astype(np.uint8) * 255
        if cv2 is not None:
            cv2.imwrite(os.path.join(out, f"{i}.png"), grid)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from univs_tpu_torch.config import UniVSConfig, tiny_test_config
    from univs_tpu_torch.inference.fast_vis import semantic_features_to_masks
    from univs_tpu_torch.utils.checkpoint import load_params
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_test_config() if args.tiny else UniVSConfig()
    data = np.load(args.features)
    obj_tokens, mask_feats = data["obj_tokens"], data["mask_feats"]
    if args.bank:
        cls_emb = np.asarray(np.load(args.bank)["embs"], np.float32)
    elif "cls_emb" in data:
        cls_emb = np.asarray(data["cls_emb"], np.float32)
    else:
        raise SystemExit("need --bank or a cls_emb entry in the npz")
    if not args.weights:
        raise SystemExit("need --weights (a converted UniVS checkpoint)")
    params = load_params(args.weights, cfg)

    cls_logits, mask_logits, keep = semantic_features_to_masks(
        cfg, params, obj_tokens, mask_feats, cls_emb,
        apply_cls_thres=args.cls_thres,
        apply_mask_quality_thres=args.quality_thres,
        cls_start=args.cls_start,
        only_high_conf_masks=not args.all,
        device=device,
    )
    os.makedirs(args.out, exist_ok=True)
    write_grids(mask_logits, args.out)
    summary = {
        "kept_queries": [int(k) for k in keep],
        "top_class": [int(c) for c in cls_logits.max(1).argmax(-1)] if len(keep) else [],
        "shape": list(mask_logits.shape),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
