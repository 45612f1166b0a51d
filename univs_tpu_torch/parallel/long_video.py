"""Stage-3 long-video training: sliding clips and the inter-clip ReID
loss (counterpart of ``univs_tpu/parallel/long_video.py``; the
reference's ``UniVS_Prompt_LongVideo``, univs_prompt_longvideo.py:95-625).

A T-frame clip slides over the Tv-frame sample with stride T - 1; each
clip is encoded twice, once by ``encode_features`` for the prompt grid
and once inside the sot forward, and neither encode is detached (the
prompt features carry gradient, as JAX's).  The per-clip losses are
averaged over the clips; at the end the inter-clip contrastive ReID loss
ties the matched embeddings of one object across the clips, on every
decoder layer but the first.

The training-time prompt pool is write-only in the reference law: it
feeds no pooled prompt back into later clips (JAX ``long_video.py``
:101-114), so each clip's prompts come from its own ground truth and no
pool is kept here.

Draws at JAX's addresses: clip ``ci`` takes ``fold_in(key, ci)`` split
into (prompt, criterion, shuffle, coin), the prompt key split over the
global batch's videos; the inter-clip terms take ``fold_in(key, 10_001)``
folded with the layer, split over the videos.  With a ``BatchShard`` the
per-video draws are this process's slice and the mean over the videos is
global.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from univs_tpu_torch.losses.criterion import (
    TrainTargets,
    UniCriterion,
    _unit,
    contrastive_aux_loss,
    contrastive_loss,
    draw_gumbel_pair,
)
from univs_tpu_torch.ops.mask_ops import masks_to_boxes
from univs_tpu_torch.parallel.ddp import BatchShard
from univs_tpu_torch.prompts.visual_prompt import (
    broadcast_prompt_sample,
    draw_train_clip_prompts,
    sample_train_clip_prompts,
)
from univs_tpu_torch.structures import make_visual_prompts


def clip_starts(num_frames_video: int, num_frames_clip: int) -> List[int]:
    """Sliding starts with stride T - 1 (univs_prompt_longvideo.py:371)."""
    stride = max(num_frames_clip - 1, 1)
    starts = list(range(0, max(num_frames_video - num_frames_clip, 0) + 1, stride))
    if starts[-1] + num_frames_clip < num_frames_video:
        starts.append(num_frames_video - num_frames_clip)
    return starts


def long_video_loss(model, criterion: UniCriterion, images: torch.Tensor,
                    frame_indices: torch.Tensor, targets: TrainTargets, cfg, key,
                    shard: Optional[BatchShard] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total stage-3 loss of a batch of long videos (task sot):
    images [B, Tv, H, W, 3] raw, frame_indices [B, Tv], targets with
    masks [B, N, Tv, h, w] and ids [B, N, Tv]; ``model`` the training
    ``UniVSModel``, ``key`` a ``DrawKey``.  Returns (total, logged): the
    clips' losses as ``clip{ci}_<name>`` and the inter-clip terms as
    ``loss_reid_interclip[_aux][_l]``."""
    B, Tv = images.shape[:2]
    T = cfg.num_frames
    N = targets.valid.shape[1]
    R = cfg.prompt.num_dense_points_train
    sh = shard or BatchShard.whole(B)
    dev = images.device
    starts = clip_starts(Tv, T)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    logged: Dict[str, torch.Tensor] = {}
    stash_per_clip: List[list] = []  # per clip: per layer (embeddings, ids)
    cls_emb = torch.zeros((1, cfg.decoder.clip_cls_emb_dim), device=dev)
    slots = torch.arange(N, device=dev)[None].expand(B, N)

    for ci, s in enumerate(starts):
        r_prompt, r_crit, r_shuffle, r_flip = key.fold_in(ci).split(4)
        imgs_c, fi_c = images[:, s:s + T], frame_indices[:, s:s + T]
        masks_c, ids_c = targets.masks[:, :, s:s + T], targets.ids[:, :, s:s + T]

        # visual prompts from this clip's ground truth on the clip's own
        # features (the first encode)
        _, ms = model.encode_features(imgs_c)
        grid_feats, grid_pos = model.decoder.prompt_feature_grid(ms[-1], fi_c)
        h4, w4 = masks_c.shape[-2:]
        boxes_c = masks_to_boxes(masks_c) / torch.tensor([w4, h4, w4, h4], dtype=torch.float32,
                                                         device=dev)
        hw = grid_feats.shape[2] * grid_feats.shape[3]
        vkeys = sh.split(r_prompt)
        samples = [sample_train_clip_prompts(
            grid_feats[b], grid_pos[b], masks_c[b], boxes_c[b], ids_c[b] >= 0, targets.valid[b], R,
            draw_train_clip_prompts(vkeys[b], T, N, hw))[0] for b in range(B)]
        kv, kv_pe, kv_valid = (torch.stack(x) for x in zip(*(broadcast_prompt_sample(smp, T)
                                                            for smp in samples)))
        valid = torch.stack([smp.valid for smp in samples])
        use_pe = float(r_flip.uniform(())) > 0.5
        vp = make_visual_prompts(kv, kv_pe, kv_valid, valid, use_pe, t=T)

        out = model(imgs_c, fi_c, task="sot", visual_prompts=vp, cls_emb=cls_emb, train=True,
                    shuffle_key=r_shuffle)  # the second encode
        targets_c = TrainTargets(labels=targets.labels, ids=ids_c, masks=masks_c,
                                 valid=targets.valid,
                                 prompt_obj_ids=torch.where(valid & targets.valid, slots, -1))
        stash_c: list = []
        loss_c, logged_c = criterion(r_crit, out, targets_c, torch.ones((1,), dtype=torch.bool,
                                                                         device=dev),
                                     task="sot", reid_stash=stash_c, shard=sh)
        total = total + loss_c
        for k, v in logged_c.items():
            logged[f"clip{ci}_{k}"] = v
        stash_per_clip.append(stash_c)

    # per-clip losses are AVERAGED over the clips (univs_prompt_longvideo.py:431-434)
    total = total / float(len(starts))

    # the inter-clip ReID loss (interclip_reid_loss :469-526), layers 1..L-1,
    # each term weighted 0.5 x reid_weight (:260)
    num_layers = len(stash_per_clip[0])
    r_inter = key.fold_in(10_001)
    w_inter = 0.5 * cfg.train.reid_weight
    for layer in range(1, num_layers):
        emb = torch.cat([st[layer][0] for st in stash_per_clip], dim=2)
        ids = torch.cat([st[layer][1] for st in stash_per_clip], dim=2)
        ctt, aux = _interclip_layer_loss(emb, ids, targets.valid, r_inter.fold_in(layer), sh)
        suffix = "" if layer == num_layers - 1 else f"_{layer}"
        logged[f"loss_reid_interclip{suffix}"] = ctt
        logged[f"loss_reid_interclip_aux{suffix}"] = aux
        total = total + w_inter * (ctt + aux)
    return total, logged


def _interclip_layer_loss(emb: torch.Tensor, ids: torch.Tensor, obj_valid: torch.Tensor, key,
                          shard: Optional[BatchShard] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the inter-clip ReID law (univs_prompt_longvideo.py:
    489-524): emb [B, N, Tall, C] the matched embeddings of every clip,
    ids [B, N, Tall] their per-frame ids (-1 absent), obj_valid [B, N].
    Per video the object slots are the id set; each slot's anchor is one
    uniformly random kept occurrence (Gumbel-max over the mask, the
    reference's randperm + argmax); the columns are every kept token; the
    contrastive term on sim / sqrt(C) and the aux term on the cosine
    similarity.  Returns the two terms averaged over the (global batch's)
    videos."""
    B, N, Tall, C = emb.shape
    sh = shard or BatchShard.whole(B)
    vkeys = sh.split(key)
    f32 = torch.float32
    ctts, auxs = [], []
    for b in range(B):
        e, i, ov = emb[b].to(f32), ids[b], obj_valid[b]
        flat = e.reshape(N * Tall, C)
        fid = i.reshape(N * Tall)
        keep = (fid >= 0) & ov.repeat_interleave(Tall)
        g = vkeys[b].gumbel((N, Tall)).to(e.device)
        g = torch.where((i >= 0) & ov[:, None], g, torch.full_like(g, -math.inf))
        anchor_t = torch.argmax(g, dim=-1)  # [N], the first maximum
        anchor = e[torch.arange(N, device=e.device), anchor_t]  # [N, C]
        slot_id = i.amax(dim=-1)  # each slot's id (-1 absent)
        row_valid = ov & (slot_id >= 0) & (i >= 0).any(-1)
        pos = (slot_id[:, None] == fid[None]).to(f32)
        sim = anchor @ flat.T / math.sqrt(C)
        r1, _ = vkeys[b].split(2)
        ctts.append(contrastive_loss(sim, pos, row_valid, keep,
                                     gumbel=draw_gumbel_pair(r1, sim.shape[1])))
        auxs.append(contrastive_aux_loss(_unit(anchor) @ _unit(flat).T, pos, row_valid, keep))
    return torch.stack(ctts).sum() / sh.total, torch.stack(auxs).sum() / sh.total
