"""Alternative inference drivers: MinVIS-style fast VIS, MDQE clip-level
VIS, non-unified online VPS, and raw-video semantic feature extraction
(counterpart of ``univs_tpu/inference/fast_vis.py``).

Every driver runs one forward per clip of T frames: the backbone and
pixel decoder re-encode each clip (so kernels B, A and C launch once per
encoder layer and clip on the card), then the decoder in detection mode
with the category bank.  What differs is the host law across clips:

- ``FastVISDriver`` (``InferenceVideoVISFast``): the next clip's queries
  matched to the last clip's by the bisoftmax Hungarian
  (``match_from_embds``, the port's exact JV), per-query masks
  concatenated, class scores averaged;
- ``MDQEVISDriver``: per-clip outputs score-thresholded into the MDQE
  over-tracker (``inference/trackers.py``), window emission and rollover;
- ``FastVPSDriver``: the ``FastOverTracker``, then panoptic stitching at
  1/4 resolution;
- ``SemanticExtractionDriver``: per-frame decoder-normed object tokens and
  the mask features mean-pooled 8 x 8, and ``semantic_features_to_masks``,
  which turns them back into class and mask logits.

The constructors are entry points: the card unless ``device="cpu"``.
Arrays handed back are numpy float32 (the JAX package hands back its
compute dtype; numpy has no bf16).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from univs_tpu_torch.inference.driver import _StreamingDriver
from univs_tpu_torch.inference.entity import mask_quality_scores
from univs_tpu_torch.inference.trackers import FastOverTracker, MDQETracker
from univs_tpu_torch.losses.hungarian import hungarian
from univs_tpu_torch.models.univs import UniVSModel, build_model


def _unit(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=eps)


def match_from_embds(tgt_embds: torch.Tensor, cur_embds: torch.Tensor) -> torch.Tensor:
    """Bisoftmax frame-to-frame query matching (comm.py:25-62 / MinVIS):
    tgt_embds, cur_embds [Q, C] -> perm [Q], the cur index per tgt slot."""
    sim = _unit(tgt_embds, 1e-6) @ _unit(cur_embds, 1e-6).T
    bisoft = (torch.softmax(sim, dim=0) + torch.softmax(sim, dim=1)) / 2
    return hungarian(1.0 - bisoft)


class FastVISDriver(_StreamingDriver):
    """MinVIS-style VIS: one forward per clip, embeddings matched across
    clips, per-query masks concatenated.

    Args (``_StreamingDriver``'s): cfg; params (a built ``UniVSModel``, its
    state_dict, or None for the seeded init of ``seed``); device (None ->
    the card, raises without one; "cpu" explicitly)."""

    def _upload(self, frames) -> torch.Tensor:
        # uint8 frames stay uint8 on the way up, normalized on the device
        return torch.as_tensor(frames).to(self.device)

    def _clip_idx(self, i: int, V: int) -> np.ndarray:
        return np.minimum(np.arange(i, i + self.T), V - 1)

    @torch.no_grad()
    def _clip_fn(self, frames_d: torch.Tensor, idx: np.ndarray, cls_emb: torch.Tensor):
        """One clip -> (sigmoid class scores [Ql, K], mask logits [Ql, T,
        H/4, W/4], mean query embeddings [Ql, C]), float32 on the device."""
        idx_d = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        mask_features, ms = self.encode_window(frames_d[idx_d])
        out = self.model.decoder(ms, mask_features, idx_d[None], task="detection",
                                 cls_emb=cls_emb)
        Ql = self.cfg.decoder.num_queries
        return (torch.sigmoid(out["pred_logits"][0, :Ql].to(torch.float32)),
                out["pred_masks"][0, :Ql].to(torch.float32),
                out["pred_embds"][0, :Ql].mean(dim=1).to(torch.float32))

    def _bank(self, cls_emb) -> torch.Tensor:
        return torch.as_tensor(cls_emb).to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def run(self, frames: np.ndarray, cls_emb, topk: int = 10) -> List[Dict]:
        """frames [V, H, W, 3] -> per-instance dicts with per-frame mask
        logits (1/4 resolution), aligned across clips."""
        V = frames.shape[0]
        frames_d = self._upload(frames)
        cls_emb = self._bank(cls_emb)
        all_masks, all_logits = [], []
        ref_embds = None
        for i in range(0, V, self.T):
            logits, masks, embds = self._clip_fn(frames_d, self._clip_idx(i, V), cls_emb)
            if ref_embds is not None:
                perm = match_from_embds(ref_embds, embds)
                masks, logits, embds = masks[perm], logits[perm], embds[perm]
            ref_embds = embds
            n_keep = min(self.T, V - i)
            all_masks.append(masks[:, :n_keep].cpu().numpy())
            all_logits.append(logits.cpu().numpy())
        masks = np.concatenate(all_masks, axis=1)[:, :V]
        scores = np.mean(all_logits, axis=0)  # [Q, K]
        order = np.argsort(-scores.max(-1))[:topk]
        return [{"score": scores[q], "mask_logits": masks[q], "category_id": int(scores[q].argmax())}
                for q in order]


class MDQEVISDriver(FastVISDriver):
    """Clip-level VIS with the MDQE over-tracker (inference_video_vis.py:39
    with tracker_type='mdqe'): per-clip learnable-query outputs,
    score-thresholded into tracker clips, window-resident matching and
    rollover, per-window emission."""

    @torch.no_grad()
    def run(self, frames: np.ndarray, cls_emb, score_thres: float = 0.05,
            window_track: Optional[int] = None, topk: int = 25) -> List[Dict]:
        V = frames.shape[0]
        T = self.T
        stride = self.cfg.inference.clip_stride
        W = window_track or max(T * 2, 10)
        frames_d = self._upload(frames)
        cls_emb = self._bank(cls_emb)
        tracker = MDQETracker(
            num_classes=int(cls_emb.shape[0]), num_frames=T, num_frames_window_track=W,
            clip_stride=stride, embed_dim=self.cfg.decoder.hidden_dim,
            apply_cls_thres=self.cfg.inference.apply_cls_thres, data_name="ytvis",
        )
        results: Dict[int, Dict] = {}  # obj_id -> {frames: {f: mask}, cls: []}
        window_start = 0
        first = True
        i = 0
        while i < V:
            logits, masks, embds = (t.cpu().numpy() for t in
                                    self._clip_fn(frames_d, self._clip_idx(i, V), cls_emb))
            keep = logits.max(-1) > score_thres
            if keep.sum() == 0:
                keep[np.argmax(logits.max(-1))] = True
            clip = {
                "scores": logits.max(-1)[keep],
                "mask_logits": masks[keep],
                "cls_probs": logits[keep],
                "query_embeds": embds[keep],
                "frame_idx": list(range(i - window_start, i - window_start + T)),
            }
            tracker.update(clip, is_first_clip=first)
            first = False
            nxt = i + stride
            is_last = nxt + T > V + T - 1 or nxt >= V
            if (nxt - window_start) + T > tracker.mem_length or is_last:
                out = tracker.get_result(is_last_clip=is_last)
                for k, oid in enumerate(np.asarray(out["obj_ids"])):
                    r = results.setdefault(int(oid), {"frames": {}, "cls": []})
                    r["cls"].append(np.asarray(out["pred_cls_scores"][k]))
                    for t in range(out["pred_masks"].shape[1]):
                        f = window_start + t
                        if f < V:
                            r["frames"][f] = np.asarray(out["pred_masks"][k, t])
                window_start += tracker.window_frames
            if is_last:
                break
            i = nxt
        final = []
        for oid, r in results.items():
            score = np.mean(r["cls"], axis=0)
            final.append({"track_id": oid, "score": score, "category_id": int(score.argmax()),
                          "masks": r["frames"]})
        final.sort(key=lambda r: -float(np.max(r["score"])))
        return final[:topk]


class FastVPSDriver(FastVISDriver):
    """Non-unified online VPS (inference_video_vps.py:35-406): per-clip
    learnable-query outputs matched across clips by the host-side
    ``FastOverTracker``, then panoptic stitching at 1/4 resolution."""

    @torch.no_grad()
    def run_vps(self, frames: np.ndarray, cls_emb, thing_class_ids,
                object_thres: float = 0.25) -> Tuple[np.ndarray, List[Dict]]:
        V = frames.shape[0]
        frames_d = self._upload(frames)
        cls_emb = self._bank(cls_emb)
        tracker = FastOverTracker(new_score_thres=object_thres)
        for i in range(0, V, self.T):
            logits, masks, embds = self._clip_fn(frames_d, self._clip_idx(i, V), cls_emb)
            n_keep = min(self.T, V - i)
            tracker.update(i, embds.cpu().numpy(), logits.cpu().numpy(),
                           masks[:, :n_keep].cpu().numpy())
        results = tracker.results(V)

        h4, w4 = masks.shape[-2:]
        pan = np.zeros((V, h4, w4), np.int32)
        infos = []
        thing_memory, stuff_memory = {}, {}
        seg_id = 0
        for t in range(V):
            order = sorted(results, key=lambda r: -float(np.max(r["score"])))
            taken = np.zeros((h4, w4), bool)
            for r in order:
                if t not in r["masks"]:
                    continue
                m = (r["masks"][t] > 0) & ~taken
                if m.sum() == 0:
                    continue
                c = r["category_id"]
                isthing = (c + 1) in thing_class_ids
                key = r["track_id"] if isthing else c
                memory = thing_memory if isthing else stuff_memory
                if key not in memory:
                    seg_id += 1
                    memory[key] = seg_id
                    infos.append({"id": seg_id, "isthing": isthing, "category_id": c + 1})
                pan[t][m] = memory[key]
                taken |= m
        return pan, infos


class SemanticExtractionDriver(FastVISDriver):
    """Raw frames -> per-frame object tokens and compressed mask features
    (inference_video_semantic_extraction.py:148-240)."""

    @torch.no_grad()
    def _extract(self, frames_d: torch.Tensor, idx: np.ndarray, cls_emb: torch.Tensor):
        """One clip -> (tokens [T, C, Q], mask features mean-pooled 8 x 8
        from the 1/4 map [T, H/32, W/32, C])."""
        idx_d = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        mf, ms = self.encode_window(frames_d[idx_d])
        out = self.model.decoder(ms, mf, idx_d[None], task="detection", cls_emb=cls_emb)
        embds = out["pred_embds"][0, :self.cfg.decoder.num_queries]  # [Q, T, C]
        t_, h, w, c = mf.shape
        mf = mf.reshape(t_, h // 8, 8, w // 8, 8, c).mean(dim=(2, 4))
        return embds.permute(1, 2, 0), mf

    @torch.no_grad()
    def run(self, frames: np.ndarray, cls_emb):
        """frames [V, H, W, 3] -> (tokens [V, C, Q], mask features [V, H/32,
        W/32, C]), float32."""
        V = frames.shape[0]
        frames_d = self._upload(frames)
        cls_emb = self._bank(cls_emb)
        toks, mfs = [], []
        for i in range(0, V, self.T):
            e, m = self._extract(frames_d, self._clip_idx(i, V), cls_emb)
            n = min(self.T, V - i)
            toks.append(e[:n].to(torch.float32).cpu().numpy())
            mfs.append(m[:n].to(torch.float32).cpu().numpy())
        return np.concatenate(toks), np.concatenate(mfs)


@torch.no_grad()
def semantic_features_to_masks(
    cfg,
    params,
    obj_tokens: np.ndarray,  # [T, C, Q] saved by SemanticExtractionDriver
    mask_feats: np.ndarray,  # [T, h, w, C] compressed mask features
    cls_emb,  # [K, Dt] category bank
    apply_cls_thres: float = 0.65,
    apply_mask_quality_thres: float = 0.85,
    temporal_stride: int = 10,
    cls_start: int = 1000,
    only_high_conf_masks: bool = True,
    device=None,
    seed: int = 0,
):
    """Class logits and mask logits from saved semantic features
    (semantic_feature_to_mask.py:30-150, ``ConvertSemanticFeatureToMask
    .convert``).  The saved tokens are the decoder's ``pred_embds``,
    already decoder-normed, so the norm is not applied again; then
    ``mask_embed`` x the mask features, and ``vis2text_projection`` ->
    cosine similarity against the L2-normalised bank x ``exp(cls_temp)``.
    The high-confidence filter keeps queries whose sigmoid class score
    over categories [cls_start:] exceeds ``apply_cls_thres`` and whose
    mask stability at ``temporal_stride`` exceeds
    ``apply_mask_quality_thres``.

    ``params`` as the drivers take it (a ``UniVSModel``, its state_dict,
    or None for the seeded init of ``seed``); a built model is used on
    its own device, else the model is built on ``device`` (the card
    unless "cpu").  Returns (cls_logits [n, T, K], mask_logits [n, T, h,
    w], indices [n] of the kept queries), numpy float32."""
    model = params if isinstance(params, UniVSModel) else build_model(cfg, params, seed=seed,
                                                                     device=device)
    dec = model.decoder
    dev = dec.query_feat.device
    tokens = torch.as_tensor(obj_tokens, device=dev).permute(0, 2, 1).to(dec.query_feat.dtype)
    mf = torch.as_tensor(mask_feats, device=dev).to(torch.float32)
    bank = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)
    membed = dec.mask_embed(tokens)  # [T, Q, mask_dim]
    cls_feats = dec.vis2text_projection(tokens)  # [T, Q, Dt]
    masks = torch.einsum("tqc,thwc->qthw", membed.to(torch.float32), mf)
    c = _unit(cls_feats, 1e-12).to(torch.float32)
    logits = torch.einsum("tqd,kd->qtk", c, _unit(bank, 1e-12))
    logits = logits * torch.exp(dec.cls_temp.to(torch.float32))
    cls_logits, mask_logits = logits.cpu().numpy(), masks.cpu().numpy()
    Q = mask_logits.shape[0]
    if not only_high_conf_masks:
        return cls_logits, mask_logits, np.arange(Q)

    start = min(cls_start, cls_logits.shape[-1] - 1)
    scores = 1.0 / (1.0 + np.exp(-cls_logits[..., start:]))
    is_conf = scores.reshape(Q, -1).max(-1) > apply_cls_thres
    qual = mask_quality_scores(masks[:, ::temporal_stride]).cpu().numpy()
    keep = np.flatnonzero(is_conf & (qual > apply_mask_quality_thres))
    return cls_logits[keep], mask_logits[keep], keep
