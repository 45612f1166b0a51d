"""Reference-compatible YAML config front-end (the port's copy of
``univs_tpu/config_io.py``, over the port's own ``config.py``).

The reference drives everything with yacs configs: five merged config
spaces, ``_BASE_`` YAML inheritance, and dotted CLI overrides
(reference: train_net.py:351-369, univs/config.py:4-160,
configs/univs/univs_r50_stage2.yaml:1).  This module lets a user bring
those exact YAML files to the port:

- :func:`load_yacs_yaml` — load a yacs-style YAML with recursive
  ``_BASE_`` merging and d2's tuple-literal string convention.
- :func:`config_from_yacs` — translate the merged key tree into a
  :class:`univs_tpu_torch.config.UniVSConfig` plus an ``extras`` dict
  (datasets, ratios, weights, output dir).  Unknown keys are collected,
  not silently dropped.
- :func:`apply_overrides` — ``a.b.c=value`` dotted overrides against
  the dataclass tree, accepting BOTH our lowercase paths
  (``decoder.num_queries=100``) and reference yacs keys
  (``MODEL.MASK_FORMER.NUM_OBJECT_QUERIES=100``).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import typing
from typing import Any, Dict, List, Optional, Tuple

from univs_tpu_torch.config import UniVSConfig


def _maybe_literal(v: Any) -> Any:
    """d2/yacs convention: YAML scalars like '(a, b)' are python tuples."""
    if isinstance(v, str) and len(v) > 1 and v[0] in "([" and v[-1] in ")]":
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yacs_yaml(path: str) -> Dict:
    """Load a yacs-style YAML file, resolving ``_BASE_`` recursively."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    base = d.pop("_BASE_", None)
    if base:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
        d = _deep_merge(load_yacs_yaml(base_path), d)
    return d


def _flatten(d: Dict, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = _maybe_literal(v)
    return out


def _swin_name(embed_dim: int) -> str:
    return {96: "swin_tiny", 128: "swin_base", 192: "swin_large"}.get(
        int(embed_dim), "swin_tiny"
    )


# flat yacs key -> our dotted dataclass path (None = recognized, consumed
# by a transform or deliberately without an equivalent in the config)
REF_KEY_MAP: Dict[str, Optional[str]] = {
    # backbone
    "MODEL.RESNETS.DEPTH": "backbone.resnet_depth",
    "MODEL.SWIN.EMBED_DIM": "backbone.swin_embed_dim",
    "MODEL.SWIN.DEPTHS": "backbone.swin_depths",
    "MODEL.SWIN.NUM_HEADS": "backbone.swin_num_heads",
    "MODEL.SWIN.WINDOW_SIZE": "backbone.swin_window_size",
    "MODEL.SWIN.DROP_PATH_RATE": "backbone.swin_drop_path_rate",
    "MODEL.SWIN.USE_CHECKPOINT": "backbone.swin_use_checkpoint",
    "MODEL.SWIN.OUT_FEATURES": "backbone.out_features",
    "MODEL.PIXEL_MEAN": "pixel_mean",
    "MODEL.PIXEL_STD": "pixel_std",
    # pixel decoder
    "MODEL.SEM_SEG_HEAD.CONVS_DIM": "pixel_decoder.hidden_dim",
    "MODEL.SEM_SEG_HEAD.MASK_DIM": "pixel_decoder.mask_dim",
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS": "pixel_decoder.num_layers",
    "MODEL.SEM_SEG_HEAD.COMMON_STRIDE": "pixel_decoder.common_stride",
    "MODEL.SEM_SEG_HEAD.LANG_DIM": "pixel_decoder.lang_dim",
    "MODEL.SEM_SEG_HEAD.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES":
        "pixel_decoder.transformer_in_features",
    "MODEL.SEM_SEG_HEAD.NUM_CLASSES": "decoder.num_classes",
    # decoder
    "MODEL.MASK_FORMER.HIDDEN_DIM": "decoder.hidden_dim",
    "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES": "decoder.num_queries",
    "MODEL.MASK_FORMER.NHEADS": "decoder.num_heads",
    "MODEL.MASK_FORMER.DIM_FEEDFORWARD": "decoder.ffn_dim",
    "MODEL.MASK_FORMER.PRE_NORM": "decoder.pre_norm",
    "MODEL.MASK_FORMER.ENFORCE_INPUT_PROJ": "decoder.enforce_input_project",
    "MODEL.UniVS.MASKDEC_SELF_ATTN_MASK_TYPE": "decoder.self_attn_mask_type",
    "MODEL.UniVS.POSITION_EMBEDDING_SINE3D": "decoder.position_embedding_sine3d",
    # prompts
    "MODEL.UniVS.NUM_POS_QUERIES": "prompt.num_max_instances",
    "MODEL.UniVS.VISUAL_PROMPT_PIXELS_PER_IMAGE": "prompt.num_dense_points_train",
    "MODEL.UniVS.VISUAL_PROMPT_ENCODER": "prompt.visual_prompt_enable",
    "MODEL.UniVS.TEXT_PROMPT_ENCODER": "prompt.text_prompt_enable",
    "MODEL.UniVS.TEST.NUM_PREV_FRAMES_MEMORY": "prompt.num_prev_frames_memory",
    # inference
    "INPUT.MIN_SIZE_TEST": "inference.min_size_test",
    "MODEL.MASK_FORMER.SIZE_DIVISIBILITY": "inference.size_divisibility",
    "MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD": "inference.object_mask_threshold",
    "MODEL.MASK_FORMER.TEST.OVERLAP_THRESHOLD": "inference.overlap_threshold",
    "MODEL.BoxVIS.TEST.APPLY_CLS_THRES": "inference.apply_cls_thres",
    "MODEL.BoxVIS.TEST.NUM_FRAMES_WINDOW": "inference.num_frames_window",
    "MODEL.BoxVIS.TEST.NUM_MAX_INST": "inference.max_num_instances",
    "MODEL.UniVS.TEST.CLIP_STRIDE": "inference.clip_stride",
    "MODEL.UniVS.TEST.DETECT_NEWLY_OBJECT_THRESHOLD": "inference.newly_entity_thres",
    "MODEL.UniVS.TEST.DETECT_NEWLY_INTERVAL_FRAMES":
        "inference.detect_newly_interval_frames",
    "MODEL.UniVS.TEST.VIDEO_UNIFIED_INFERENCE_QUERIES":
        "inference.video_unified_inference_queries",
    "MODEL.UniVS.TEST.ENABLED_PREV_VISUAL_PROMPTS_FOR_GROUNDING":
        "inference.enabled_prev_visual_prompts_for_grounding",
    "MODEL.UniVS.TEST.SEMANTIC_EXTRACTION.ENABLE":
        "inference.semantic_extraction_enable",
    "TEST.DETECTIONS_PER_IMAGE": "inference.detections_per_image",
    # train / solver / criterion
    "SOLVER.BASE_LR": "train.lr",
    "SOLVER.WEIGHT_DECAY": "train.weight_decay",
    "SOLVER.MAX_ITER": "train.max_iter",
    "SOLVER.WARMUP_ITERS": "train.warmup_iters",
    "SOLVER.WARMUP_FACTOR": "train.warmup_factor",
    "SOLVER.LR_SCHEDULER_NAME": "train.lr_scheduler",
    "SOLVER.STEPS": "train.lr_steps",
    "SOLVER.GAMMA": "train.lr_gamma",
    "SOLVER.POLY_LR_POWER": "train.poly_power",
    "SOLVER.BACKBONE_MULTIPLIER": "train.backbone_lr_multiplier",
    "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": "train.clip_gradients_value",
    "MODEL.MASK_FORMER.CLASS_WEIGHT": "train.class_weight",
    "MODEL.MASK_FORMER.MASK_WEIGHT": "train.mask_weight",
    "MODEL.MASK_FORMER.DICE_WEIGHT": "train.dice_weight",
    "MODEL.MASK_FORMER.REID_WEIGHT": "train.reid_weight",
    "MODEL.MASK_FORMER.TRAIN_NUM_POINTS": "train.num_points",
    "MODEL.MASK_FORMER.OVERSAMPLE_RATIO": "train.oversample_ratio",
    "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO": "train.importance_sample_ratio",
    "MODEL.MASK_FORMER.NO_OBJECT_WEIGHT": "train.no_object_weight",
    "MODEL.MASK_FORMER.DEEP_SUPERVISION": "train.deep_supervision",
    "MODEL.BoxVIS.BoxVIS_ENABLED": "train.boxvis_enabled",
    "MODEL.BoxVIS.EMA_ENABLED": "train.boxvis_ema_enabled",
    "MODEL.BoxVIS.PSEUDO_MASK_SCORE_THRESH": "train.pseudo_score_thresh",
    "INPUT.SAMPLING_FRAME_VIDEO_NUM": "train.num_frames_video",
}

# recognized keys consumed by transforms below (not 1:1 field maps)
_TRANSFORM_KEYS = {
    "MODEL.BACKBONE.NAME",
    "MODEL.MASK_FORMER.DEC_LAYERS",
    "MODEL.UniVS.PROMPT_SELF_ATTN_LAYERS",
    "INPUT.SAMPLING_FRAME_NUM",
    "SOLVER.AMP.ENABLED",
}

# extras surfaced to the caller rather than folded into UniVSConfig
_EXTRA_KEYS = {
    "DATASETS.TRAIN": "datasets_train",
    "DATASETS.TEST": "datasets_test",
    "DATASETS.DATASET_RATIO": "dataset_ratio",
    "MODEL.WEIGHTS": "weights",
    "MODEL.UniVS.CLIP_CLASS_EMBED_PATH": "class_embed_path",
    "OUTPUT_DIR": "output_dir",
}


def _field_types(obj) -> Dict[str, Any]:
    """Resolved field annotations (config.py uses string annotations
    via ``from __future__ import annotations``)."""
    import univs_tpu_torch.config as _cfg_mod

    return typing.get_type_hints(type(obj), vars(_cfg_mod))


def _coerce(value: Any, ftype: Any) -> Any:
    """Coerce a YAML/CLI value to the dataclass field's declared type."""
    origin = typing.get_origin(ftype)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if len(args) == 1:
            return _coerce(value, args[0])
        return value
    if isinstance(value, str):
        value = _maybe_literal(value)
    if origin in (tuple, Tuple) or ftype in (tuple,):
        if isinstance(value, str):
            value = ast.literal_eval(value)
        sub = typing.get_args(ftype)
        if sub and sub[-1] is not Ellipsis and len(sub) == len(value):
            return tuple(_coerce(v, t) for v, t in zip(value, sub))
        if sub:
            return tuple(_coerce(v, sub[0]) for v in value)
        return tuple(value)
    if ftype is bool or ftype == "bool":
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if ftype is int or ftype == "int":
        return int(value)
    if ftype is float or ftype == "float":
        return float(value)
    if ftype is str or ftype == "str":
        return str(value)
    return value


def set_by_path(cfg: UniVSConfig, path: str, value: Any) -> UniVSConfig:
    """Immutable dotted-path set with type coercion, e.g.
    ``set_by_path(cfg, 'decoder.num_queries', 100)``."""
    parts = path.split(".")

    def rec(obj, parts):
        types = _field_types(obj)
        name = parts[0]
        if name not in types:
            raise KeyError(
                f"unknown config field '{name}' on {type(obj).__name__} "
                f"(path {path!r}); known: {sorted(types)}"
            )
        if len(parts) == 1:
            return dataclasses.replace(obj, **{name: _coerce(value, types[name])})
        child = rec(getattr(obj, name), parts[1:])
        return dataclasses.replace(obj, **{name: child})

    return rec(cfg, parts)


def config_from_yacs(
    tree_or_path, base: Optional[UniVSConfig] = None
) -> Tuple[UniVSConfig, Dict[str, Any], List[str]]:
    """Translate a reference yacs config (path or merged dict) into
    (UniVSConfig, extras, unmapped_keys)."""
    tree = load_yacs_yaml(tree_or_path) if isinstance(tree_or_path, str) else tree_or_path
    flat = _flatten(tree)
    cfg = base or UniVSConfig()
    extras: Dict[str, Any] = {}
    unmapped: List[str] = []

    for key, value in flat.items():
        if key in _EXTRA_KEYS:
            extras[_EXTRA_KEYS[key]] = value
            continue
        target = REF_KEY_MAP.get(key)
        if target:
            cfg = set_by_path(cfg, target, value)
        elif key in _TRANSFORM_KEYS or key in REF_KEY_MAP:
            continue  # handled below / recognized no-op
        else:
            unmapped.append(key)

    # transforms with cross-key context
    if str(cfg.train.lr_scheduler).startswith("Warmup"):  # d2 class names
        cfg = set_by_path(cfg, "train.lr_scheduler", {
            "WarmupMultiStepLR": "multistep",
            "WarmupPolyLR": "poly",
            "WarmupCosineLR": "cosine",
        }.get(str(cfg.train.lr_scheduler), "multistep"))
    if "MODEL.MASK_FORMER.DEC_LAYERS" in flat:
        cfg = set_by_path(cfg, "decoder.num_layers", int(flat["MODEL.MASK_FORMER.DEC_LAYERS"]) - 1)
    bb = flat.get("MODEL.BACKBONE.NAME", "")
    if "swin" in str(bb).lower() or "Swin" in str(bb):
        cfg = set_by_path(cfg, "backbone.name", _swin_name(cfg.backbone.swin_embed_dim))
    elif "resnet" in str(bb).lower():
        cfg = set_by_path(cfg, "backbone.name", f"resnet{cfg.backbone.resnet_depth}")
    if "MODEL.UniVS.PROMPT_SELF_ATTN_LAYERS" in flat:
        v = int(flat["MODEL.UniVS.PROMPT_SELF_ATTN_LAYERS"])
        if v >= 0:  # -1 = ProCA at every layer (our default count)
            cfg = set_by_path(cfg, "decoder.num_prompt_self_attn_layers", v)
    if "INPUT.SAMPLING_FRAME_NUM" in flat:
        t = int(flat["INPUT.SAMPLING_FRAME_NUM"])
        cfg = cfg.replace(num_frames=t)
        cfg = set_by_path(cfg, "inference.num_frames", t)
    if flat.get("SOLVER.AMP.ENABLED"):
        cfg = cfg.replace(dtype="bfloat16")
    return cfg, extras, unmapped


def apply_overrides(cfg: UniVSConfig, opts: List[str]) -> UniVSConfig:
    """Apply ``key=value`` dotted overrides (our paths or yacs keys).

    Also accepts the d2 ``--opts KEY VALUE KEY VALUE`` pair form when
    the list has no '='."""
    if opts and "=" not in opts[0]:
        opts = [f"{k}={v}" for k, v in zip(opts[::2], opts[1::2])]
    for opt in opts:
        key, _, value = opt.partition("=")
        key = key.strip()
        if key in REF_KEY_MAP and REF_KEY_MAP[key]:
            cfg = set_by_path(cfg, REF_KEY_MAP[key], value)
        elif key == "MODEL.MASK_FORMER.DEC_LAYERS":
            cfg = set_by_path(cfg, "decoder.num_layers", int(value) - 1)
        elif key == "INPUT.SAMPLING_FRAME_NUM":
            cfg = cfg.replace(num_frames=int(value))
            cfg = set_by_path(cfg, "inference.num_frames", int(value))
        else:
            cfg = set_by_path(cfg, key, value)
    return cfg
