"""Video inference driver, VIS (counterpart of the VIS half of
``univs_tpu/inference/driver.py``).

``EntityDriver`` streams one video: backbone + pixel decoder once per
``num_frames_window`` frames (uint8 frames uploaded, normalized on the
device), ``entity_clip_step`` once per clip from the ONE clip schedule
``_iter_clips``, window emission with eviction, and at the end of the
video the drain: only the finally-valid entity rows are upsampled,
thresholded and bit-packed on the device, then fetched and turned into
per-frame RLEs on the host (``assemble_vis_results``).

``start_vis`` / ``finish_vis`` keep the JAX package's pipelined API; in
this port they run in order on the current stream (overlapping the
upload and the drain on side streams is listed in ROADMAP.md).  The
pool is updated in place; every emitted window is a copy taken before
``evict_window`` / ``shift_clip`` mutate the pool.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from univs_tpu_torch.config import UniVSConfig
from univs_tpu_torch.inference import memory_pool as mp
from univs_tpu_torch.inference.entity import EntityClipConfig, entity_clip_step
from univs_tpu_torch.models.univs import UniVSModel, build_model, compute_dtype_of
from univs_tpu_torch.utils import rle
from univs_tpu_torch.utils.device import resolve_device


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., W] bool -> [..., ceil(W/8)] uint8, big-endian bit order
    (np.unpackbits-compatible)."""
    W = bits.shape[-1]
    pad = (-W) % 8
    if pad:
        bits = F.pad(bits, (0, pad))
    b = bits.reshape(*bits.shape[:-1], (W + pad) // 8, 8).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def _upsample_threshold_pack(logits: torch.Tensor, image_size, out_size, padded_size) -> torch.Tensor:
    """[E, n, H4, W4] logits -> [E, n, out_h, ceil(out_w/8)] packed uint8:
    bilinear (align_corners=False) to the padded size, crop, optional
    resize to the output size, threshold at 0 (save_results_vis:932-939).
    Entities go in chunks so the float32 intermediate stays ~256 MB."""
    E, n = logits.shape[:2]
    budget = 64 * 2 ** 20
    per_e = max(1, n * padded_size[0] * padded_size[1])
    c = max(1, budget // per_e)
    outs = []
    for s in range(0, E, c):
        y = F.interpolate(logits[s:s + c].to(torch.float32), size=tuple(padded_size),
                          mode="bilinear", align_corners=False)
        y = y[:, :, : image_size[0], : image_size[1]]
        if tuple(image_size) != tuple(out_size):
            y = F.interpolate(y, size=tuple(out_size), mode="bilinear", align_corners=False)
        outs.append(_pack_bits(y > 0))
    return torch.cat(outs, dim=0)


class EntityDriver:
    """Category-guided VIS over one video.

    Args:
        cfg: UniVSConfig
        params: a ``UniVSModel`` already built, its state_dict (e.g. from
            ``utils.weights.state_dict_from_flax``), or None for the
            port's seeded init (``seed``)
        num_classes: K of the category bank slice
        capacity: entity slots E
        device: None -> the card (raises without one); "cpu" explicitly
    """

    def __init__(self, cfg: UniVSConfig, params=None, num_classes: int = 1, capacity: int = 40,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        if isinstance(params, UniVSModel):
            self.model = params.to(self.device)
        else:
            self.model = build_model(cfg, params, seed=seed, device=self.device)
        self.dtype = compute_dtype_of(cfg)
        self.num_classes = num_classes
        self.capacity = capacity
        inf = cfg.inference
        self.T = inf.num_frames
        self.stride = inf.clip_stride
        self.window = inf.num_frames_window
        self.out_window = max(self.window - self.T, self.T)
        self.cc = EntityClipConfig(
            num_queries=cfg.decoder.num_queries,
            topk_candidates=inf.topk_per_video,
            num_prev_frames_memory=cfg.prompt.num_prev_frames_memory,
            apply_cls_thres=inf.apply_cls_thres,
            newly_thres=inf.newly_entity_thres,
            consistency_thres=inf.consistency_thres[0],
            nms_thres=inf.nms_thres,
            num_dense_points=cfg.prompt.num_dense_points_test,
            clip_stride=self.stride,
            num_frames=self.T,
            detect_newly_interval_frames=inf.detect_newly_interval_frames,
        )
        self._modules = (self.model.pixel_decoder, self.model.decoder)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_window(self, frames: torch.Tensor):
        """[n, H, W, 3] raw frames (uint8 or float) on the device ->
        (mask_features [n, H/4, W/4, C], multi-scale tuple), per frame."""
        x = self.model.normalize(frames)
        feats = self.model.backbone(x)
        mask_features, _, _, ms = self.model.pixel_decoder(feats)
        return mask_features, tuple(ms)

    def _iter_clips(self, V: int):
        """The ONE clip/window/emission schedule for a V-frame video
        (same generator as the JAX driver's): per-clip dicts with ``i``,
        ``clip_idx`` (tail-clamped), ``rel`` (window-relative),
        ``offset`` (i - frames emitted so far), ``new_window`` (window
        start when this clip needs a fresh encode, else None), ``emits``
        [(start, n_out), ...] and ``is_last``."""
        window_range = (0, 0)
        emitted_total = 0
        i, is_last = 0, False
        while i < V and not is_last:
            is_last = i + self.T >= V
            clip_idx = np.minimum(np.arange(i, i + self.T), V - 1)
            new_window = None
            if min(i + self.T, V) > window_range[1]:
                new_window = i
                window_range = (i, i + self.window)
            offset = i - emitted_total
            emits = []
            while (i + self.T - emitted_total) >= (self.out_window + self.T) or (
                is_last and emitted_total < V
            ):
                n_out = (self.out_window if not is_last
                         else min(V - emitted_total, self.out_window + self.T))
                emits.append((emitted_total, n_out))
                emitted_total += n_out
                if is_last and emitted_total >= V:
                    break
            yield {
                "i": i, "clip_idx": clip_idx,
                "rel": clip_idx - window_range[0], "offset": offset,
                "new_window": new_window, "emits": emits, "is_last": is_last,
            }
            i += self.stride

    def num_window_encodes(self, V: int) -> int:
        return sum(c["new_window"] is not None for c in self._iter_clips(V))

    def _emit(self, pool: mp.EntityMemory, out_frames: int):
        """Copies of the first ``out_frames`` window frames (fp16, divided
        by occurrence — save_results_vis:931), the per-window class-score
        snapshot (logits-history mean, :926)."""
        occ = pool.occurrence[:, :out_frames].clamp(min=1.0)
        masks = (pool.mask_logits[:, :out_frames] / occ[:, :, None, None]).to(torch.float16)
        scores = pool.logits_sum / pool.logits_count.clamp(min=1)[:, None]
        return masks, scores

    @torch.no_grad()
    def _dispatch(self, frames, cls_emb, next_frames=None) -> Dict:
        V, H, W = frames.shape[:3]
        dev = self.device
        pool = mp.create_entity_memory(
            self.capacity, self.num_classes, self.cfg.decoder.hidden_dim, (H // 4, W // 4),
            window=self.out_window + self.T, num_prompt_points=self.cc.num_dense_points,
            embd_history=8, prompt_history=self.T + self.stride, device=dev,
        )
        # the caller's dtype is kept: uint8 frames move 4x fewer bytes and
        # are normalized on the device inside the window encode
        frames_d = torch.as_tensor(frames).to(dev)
        cls_emb = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)

        feats_window = None
        emitted: List[torch.Tensor] = []
        emit_starts: List[int] = []
        emit_scores: List[torch.Tensor] = []
        first = True
        for c in self._iter_clips(V):
            if c["new_window"] is not None:
                i0 = c["new_window"]
                idx = torch.as_tensor(np.minimum(np.arange(i0, i0 + self.window), V - 1), device=dev)
                feats_window = self.encode_window(frames_d[idx])
            mf_w, ms_w = feats_window
            rel = torch.as_tensor(c["rel"], device=dev)
            feats = (mf_w[rel], tuple(m[rel] for m in ms_w))
            entity_clip_step(self._modules, feats, pool, c["clip_idx"], c["offset"], first,
                             cls_emb, self.cc)
            first = False
            for start, n_out in c["emits"]:
                # emit + evict exactly n_out frames: the trailing T overlap
                # frames stay in the pool and keep accumulating
                masks, scores = self._emit(pool, n_out)
                mp.evict_window(pool, n_out)
                emitted.append(masks)
                emit_scores.append(scores)
                emit_starts.append(start)
            if not c["is_last"]:
                mp.shift_clip(pool, self.stride)

        next_dev = None
        if next_frames is not None:
            next_dev = torch.as_tensor(next_frames).to(dev)
        return {
            "V": V, "pool": pool, "emitted": emitted, "emit_starts": emit_starts,
            "emit_scores": emit_scores,
            "next_frames_device": next_dev, "drained": False,
        }

    @torch.no_grad()
    def _queue_drain(self, h: Dict) -> None:
        """Upsample + threshold + bit-pack only the finally-valid entity
        rows of every emitted window (one host sync on ``valid``)."""
        if h["drained"]:
            return
        h["drained"] = True
        entity_rows = np.flatnonzero(h["pool"].valid.cpu().numpy())
        if entity_rows.size:
            idx = torch.as_tensor(entity_rows, device=self.device)
            h["emitted"] = [_upsample_threshold_pack(m[idx], *h["sizes"]) for m in h["emitted"]]
        else:
            oh, ow = h["sizes"][1]
            h["emitted"] = [torch.zeros((0, m.shape[1], oh, (ow + 7) // 8), dtype=torch.uint8)
                            for m in h["emitted"]]
        h["entity_rows"] = entity_rows

    def _fetch(self, h: Dict):
        emitted = [m.cpu().numpy() for m in h["emitted"]]
        emit_scores = [s.cpu().numpy() for s in h["emit_scores"]]
        return emitted, h["emit_starts"], emit_scores, h["pool"], h["entity_rows"]

    # -- VIS API ---------------------------------------------------------

    def start_vis(self, frames, cls_emb, image_size=None, out_size=None, next_frames=None) -> Dict:
        """Run one video's VIS compute; returns a handle for
        :meth:`finish_vis`.  ``next_frames`` (the NEXT video) is uploaded
        after this video's compute; read it back from
        ``handle['next_frames_device']``."""
        V, H, W = frames.shape[:3]
        image_size = tuple(image_size or (H, W))
        out_size = tuple(out_size or image_size)
        h = self._dispatch(frames, cls_emb, next_frames=next_frames)
        h["sizes"] = (image_size, out_size, (H, W))
        return h

    def finish_vis(self, h: Dict) -> List[Dict]:
        """Drain + assemble a :meth:`start_vis` handle into per-entity results."""
        self._queue_drain(h)
        emitted, emit_starts, emit_scores, pool, entity_rows = self._fetch(h)
        return assemble_vis_results(
            emitted, emit_starts, emit_scores, pool.valid.cpu().numpy(),
            pool.quality_sum.cpu().numpy(), h["V"], h["sizes"][1], entity_rows)

    def run_vis(self, frames, cls_emb, image_size=None, out_size=None) -> List[Dict]:
        """frames [V, H, W, 3] raw RGB (padded to divisibility) -> per-entity
        dicts with per-frame RLEs and class scores
        (inference_video_entity.py:914-961)."""
        return self.finish_vis(self.start_vis(frames, cls_emb, image_size, out_size))


# ---------------------------------------------------------------------------
# host-side assembly (numpy; shared laws with the JAX driver)
# ---------------------------------------------------------------------------


def assemble_vis_results(emitted, emit_starts, emit_scores, valid, quality_sum, V, out_size,
                         entity_rows) -> List[Dict]:
    """Per-entity result dicts from emitted windows (the host half of
    save_results_vis, inference_video_entity.py:914-961): bit-packed
    output-resolution masks [R, n, out_h, ceil(out_w/8)] whose rows map
    to slots through ``entity_rows``."""
    capacity = valid.shape[0]
    row_of = {int(e): r for r, e in enumerate(entity_rows)}
    # res['mask_quality_score'] = q_i / (int(q.max()) + 1) (:958)
    quality = quality_sum / (int(quality_sum.max()) + 1)
    results = []
    for e in range(capacity):
        if not valid[e]:
            continue
        segs = [None] * V
        for win_masks, start in zip(emitted, emit_starts):
            up = np.unpackbits(win_masks[row_of[e]], axis=-1)[..., :out_size[1]]
            for k in range(up.shape[0]):
                if start + k < V:
                    segs[start + k] = rle.encode(up[k])
        blank = rle.encode(np.zeros(out_size, np.uint8))
        segs = [s if s is not None else blank for s in segs]
        score_windows = np.stack([s[e] for s in emit_scores])  # [W, K]
        results.append({
            "obj_id": e,
            "score_windows": score_windows,
            "score": combine_window_scores(score_windows.copy()),
            "mask_quality_score": float(quality[e]),
            "segmentations": segs,
        })
    return results


def temporal_consistency_weighting(scores: np.ndarray) -> np.ndarray:
    """In-place per-window score weighting (calculate_mask_temporal_
    consistency_scores, inference/comm.py:197-207)."""
    nonblank = scores.sum(-1) > 0
    W = len(nonblank)
    for t in range(W):
        s_t, e_t = max(0, t - 1), min(W, t + 1)
        w = float(nonblank[t]) * float(nonblank[s_t:e_t].sum()) / max(e_t - s_t, 1)
        scores[t] = scores[t] * w
    return scores


def combine_window_scores(score_windows: np.ndarray) -> np.ndarray:
    """[W, K] per-window scores -> [K] (inference/comm.py:166-167).
    Mutates ``score_windows``."""
    scores = temporal_consistency_weighting(score_windows)
    denom = max(int((scores.sum(-1) > 0).sum()), 1)
    return scores.sum(0) / denom


def vis_results_to_ytvis_json(video_id, video_len: int, height: int, width: int,
                              results: List[Dict], apply_cls_thresh: float = 0.05,
                              topk_per_video: int = 25) -> List[Dict]:
    """Per-entity windows -> YTVIS-format per-(entity, class) records
    (vis_clip_instances_to_coco_json_video, inference/comm.py:97-195)."""
    out, scores_all = [], []
    num_above = 0
    for res in results:
        if "score_windows" in res:
            scores = combine_window_scores(np.asarray(res["score_windows"], np.float32).copy())
        else:
            scores = np.asarray(res["score"], np.float32)
        if "mask_quality_score" in res:
            quality = float(res["mask_quality_score"])
        else:
            raw = (np.asarray(res["score_windows"], np.float32) if "score_windows" in res
                   else np.asarray(res["score"], np.float32)[None])
            nonblank = int((raw.sum(-1) > 0).sum())
            quality = max(float(nonblank) / max(video_len, 1), 0.1)
        for c in range(scores.shape[0]):
            if scores[c] < 0.1 * apply_cls_thresh:
                continue
            s = float(scores[c]) * quality
            out.append({"video_id": video_id, "score": s, "category_id": int(c),
                        "segmentations": res["segmentations"], "height": height, "width": width})
            scores_all.append(s)
            if scores[c] > apply_cls_thresh:
                num_above += 1
    if scores_all:
        scores_all.sort(reverse=True)
        k = max(int(num_above * 1.5), topk_per_video)
        thr = scores_all[min(k, len(scores_all) - 1)]
        out = [r for r in out if r["score"] >= thr]
    return out
