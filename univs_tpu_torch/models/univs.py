"""UniVS builders (counterpart of ``univs_tpu/models/univs.py``).

``UniVSModel`` holds the three parameterized parts under the flax tree's
top-level names (``backbone``, ``pixel_decoder``, ``decoder``), so a
JAX param tree converts onto it with ``utils.weights`` and the port's
own seeded init fills it without JAX.  The model builders are entry
points: they place the model on the card unless ``device="cpu"`` is
passed, and raise when no card is present.  The pixel decoder's input
channels are those of the backbone built (``out_channels``).  Casting to
the compute dtype keeps in float32 the parameters a module names in
``keep_float32`` (Swin's and PVT's LayerNorms and bias table, VLFuse's
gammas), which the JAX package holds and applies in float32.

``UniVSModel.forward`` is the training forward of the JAX package's
``UniVSModel.__call__`` (normalize -> backbone -> pixel decoder ->
decoder); for the sot task it samples the visual prompts from the
ground truth (``univs.py:103-130``).  Its random draws come from two
``DrawKey``s at the addresses of flax's ``make_rng("prompt")`` and
``make_rng("shuffle")``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from univs_tpu_torch.config import UniVSConfig
from univs_tpu_torch.models.backbones.resnet import build_backbone as _build_backbone
from univs_tpu_torch.models.decoder import UniVSDecoder, draw_shuffle_perms
from univs_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from univs_tpu_torch.prompts.visual_prompt import (
    TrainPromptDraw,
    broadcast_prompt_sample,
    draw_train_clip_prompts,
    sample_train_clip_prompts,
)
from univs_tpu_torch.structures import TextPrompts, VisualPrompts, make_visual_prompts
from univs_tpu_torch.utils.device import resolve_device


def compute_dtype_of(cfg: UniVSConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _place(module: nn.Module, cfg: UniVSConfig, device) -> nn.Module:
    """Move to ``device`` and cast floating tensors to the compute dtype,
    except those each module names in ``keep_float32``."""
    dtype = compute_dtype_of(cfg)
    module.to(device=resolve_device(device))
    for mod in module.modules():
        keep = getattr(mod, "keep_float32", ())
        for tensors in (mod._parameters, mod._buffers):
            for name, t in tensors.items():
                if t is not None and t.is_floating_point() and name not in keep:
                    t.data = t.data.to(dtype)
    return module.eval().requires_grad_(False)


def _pixel_decoder(cfg: UniVSConfig, in_channels) -> MSDeformAttnPixelDecoder:
    c = cfg.pixel_decoder
    return MSDeformAttnPixelDecoder(
        in_channels, hidden_dim=c.hidden_dim, mask_dim=c.mask_dim, num_layers=c.num_layers,
        num_heads=c.num_heads, num_points=c.num_points, ffn_dim=c.ffn_dim,
        transformer_in_features=c.transformer_in_features,
    )


def _decoder(cfg: UniVSConfig) -> UniVSDecoder:
    c = cfg.decoder
    return UniVSDecoder(
        hidden_dim=c.hidden_dim, num_queries=c.num_queries, num_layers=c.num_layers,
        num_heads=c.num_heads, ffn_dim=c.ffn_dim, pre_norm=c.pre_norm, mask_dim=c.mask_dim,
        text_emb_dim=c.clip_cls_emb_dim, self_attn_mask_type=c.self_attn_mask_type,
        num_max_frames=c.num_max_frames, l4p_fusion=c.l4p_fusion,
        temporal_query_shuffle=c.temporal_query_shuffle, remat_heads=c.remat_heads,
    )


def build_backbone(cfg: UniVSConfig, device=None) -> nn.Module:
    return _place(_build_backbone(cfg.backbone), cfg, device)


def build_pixel_decoder(cfg: UniVSConfig, device=None) -> MSDeformAttnPixelDecoder:
    with torch.device("meta"):  # the backbone's channels, no weights allocated
        channels = _build_backbone(cfg.backbone).out_channels
    return _place(_pixel_decoder(cfg, channels), cfg, device)


def build_decoder(cfg: UniVSConfig, device=None) -> UniVSDecoder:
    return _place(_decoder(cfg), cfg, device)


class UniVSModel(nn.Module):
    """backbone -> pixel decoder -> decoder, under the flax tree's names
    (float32 on the CPU as constructed; ``build_model`` places it)."""

    def __init__(self, cfg: UniVSConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = _build_backbone(cfg.backbone)
        self.pixel_decoder = _pixel_decoder(cfg, self.backbone.out_channels)
        self.decoder = _decoder(cfg)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """[..., H, W, 3] raw RGB (0-255) -> normalized compute dtype."""
        mean = torch.tensor(self.cfg.pixel_mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(self.cfg.pixel_std, dtype=torch.float32, device=images.device)
        return ((images.to(torch.float32) - mean) / std).to(compute_dtype_of(self.cfg))

    def encode_features(self, images: torch.Tensor):
        """images [B, T, H, W, 3] raw -> (mask_features [B*T, H/4, W/4, Cm],
        the multi-scale maps, coarse to fine)."""
        b, t, h, w, _ = images.shape
        feats = self.backbone(self.normalize(images).reshape(b * t, h, w, 3))
        mask_features, _, _, ms = self.pixel_decoder(feats)
        return mask_features, ms

    def forward(self, images: torch.Tensor, frame_indices: torch.Tensor, task: str = "detection",
                text_prompts: Optional[TextPrompts] = None,
                visual_prompts: Optional[VisualPrompts] = None,
                cls_emb: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None, gt_boxes: Optional[torch.Tensor] = None,
                gt_occur: Optional[torch.Tensor] = None,
                gt_obj_valid: Optional[torch.Tensor] = None, train: bool = False,
                shuffle_key=None, prompt_key=None, shard=None) -> Dict:
        """images [B, T, H, W, 3] raw RGB, frame_indices [B, T] -> the
        decoder's outputs.  Training sot (``gt_masks`` [B, Qp, T, Hm, Wm],
        ``gt_boxes`` [B, Qp, T, 4] normalized, ``gt_occur`` [B, Qp, T],
        ``gt_obj_valid`` [B, Qp]) samples the visual prompts from the
        ground truth with the draws of ``prompt_key`` (with a ``shard``,
        this process's videos' draws of the global batch); training draws
        the decoder's shuffle permutations from ``shuffle_key``."""
        b, t = images.shape[:2]
        mask_features, ms = self.encode_features(images)
        if train and task == "sot" and visual_prompts is None and gt_masks is not None:
            grid_feats, grid_pos = self.decoder.prompt_feature_grid(ms[-1], frame_indices)
            draws, coin = draw_train_prompts(prompt_key, b, t, gt_masks.shape[1],
                                             grid_feats.shape[2] * grid_feats.shape[3],
                                             shard)
            visual_prompts = train_visual_prompts(
                grid_feats, grid_pos, gt_masks, gt_boxes, gt_occur, gt_obj_valid,
                self.cfg.prompt.num_dense_points_train, draws, coin)
        perms = None
        if train and self.decoder.temporal_query_shuffle and t > 1:
            perms = draw_shuffle_perms(shuffle_key, self.decoder.num_layers, t)
        return self.decoder(ms, mask_features, frame_indices, task=task,
                            visual_prompts=visual_prompts, cls_emb=cls_emb,
                            text_prompts=text_prompts, train=train, shuffle_perms=perms)


def draw_train_prompts(key, b: int, t: int, Qp: int, HW: int,
                       shard=None) -> Tuple[List[TrainPromptDraw], float]:
    """Training sot's draws: one ``TrainPromptDraw`` per video and the PE
    coin, at the addresses of ``univs.py:107-119`` (flax's
    ``make_rng("prompt")`` split into b + 1 keys, b the global batch's
    videos; a ``shard`` takes its videos' keys)."""
    first, total = (0, b) if shard is None else (shard.offset, shard.total)
    keys = key.static(1).split(total + 1)
    return ([draw_train_clip_prompts(keys[first + i], t, Qp, HW) for i in range(b)],
            float(keys[total].uniform(())))


def train_visual_prompts(grid_feats, grid_pos, gt_masks, gt_boxes, gt_occur, gt_obj_valid,
                         num_points: int, draws: List[TrainPromptDraw],
                         coin: float) -> VisualPrompts:
    """GT-driven visual prompts of a training batch: each video's sample
    at its drawn key frame, a singleton frame axis, the query position
    from the kv PE when the coin is above 0.5 (decoder_univs.py:646-649),
    else from the kv features."""
    t = grid_feats.shape[1]
    samples = [sample_train_clip_prompts(grid_feats[i], grid_pos[i], gt_masks[i], gt_boxes[i],
                                         gt_occur[i], gt_obj_valid[i], num_points, d)[0]
               for i, d in enumerate(draws)]
    kv, kv_pe, kv_valid = (torch.stack(x) for x in zip(*(broadcast_prompt_sample(s, t)
                                                        for s in samples)))
    valid = torch.stack([s.valid for s in samples])
    return make_visual_prompts(kv, kv_pe, kv_valid, valid, coin > 0.5, t=t)


def build_model(cfg: UniVSConfig, params: Optional[dict] = None, seed: int = 0,
                device=None) -> UniVSModel:
    """The full model on ``device`` (the card unless "cpu"): weights from
    ``params`` (a state_dict of this model, e.g. from
    ``utils.weights.state_dict_from_flax``) or, when None, the port's
    seeded init."""
    from univs_tpu_torch.utils import weights

    model = UniVSModel(cfg)
    if params is None:
        weights.init_params(model, seed)
    else:
        weights.load_state_dict_strict(model, params)
    return _place(model, cfg, device)
