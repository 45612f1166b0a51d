"""Standalone inter-clip trackers, host-side numpy and scipy (the port's
own copy of ``univs_tpu/inference/trackers.py``, which it may not
import).

Rebuilds of the reference's tracker zoo (``FastOverTracker_DET`` /
``InterClipCombiner_SOT``, inter_clip_combiner.py:13-499, and
``MDQE_OverTrackerEfficient``, mdqe_overtracker_efficient.py:12-408): a
memory of per-track masks / embeddings / logits matched to each new
clip's instances by cosine (+ bisoftmax) similarity with spatial-IoU
gating, expanding the memory with unmatched instances.  They serve the
non-unified drivers of ``inference/fast_vis.py``.  The laws are copied
line for line, so ties resolve as in the JAX package (scipy's
``linear_sum_assignment`` on the same float arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclass
class Track:
    track_id: int
    embds: List[np.ndarray] = field(default_factory=list)  # [C] per clip
    logits: List[np.ndarray] = field(default_factory=list)  # [K]
    masks: Dict[int, np.ndarray] = field(default_factory=dict)  # frame -> mask logits
    last_frame: int = -1

    def mean_embd(self, last: int = 3) -> np.ndarray:
        e = np.stack(self.embds[-last:])
        e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-6)
        return e.mean(0)

    def score(self) -> np.ndarray:
        return np.mean(self.logits, axis=0)


class FastOverTracker:
    """Memory tracker with cosine similarity + spatial-IoU gating
    (reference: inter_clip_combiner.py:13-370 — cosine+ctt similarity
    :352-372, siou gating :173)."""

    def __init__(self, match_threshold: float = 0.3, siou_gate: float = 0.1,
                 new_score_thres: float = 0.25, max_tracks: int = 200):
        self.match_threshold = match_threshold
        self.siou_gate = siou_gate
        self.new_score_thres = new_score_thres
        self.max_tracks = max_tracks
        self.tracks: Dict[int, Track] = {}
        self._next = 0

    def _similarity(self, cand_embds: np.ndarray, cand_masks: np.ndarray,
                    frame_start: int) -> np.ndarray:
        tids = list(self.tracks)
        if not tids:
            return np.zeros((0, len(cand_embds)))
        mem = np.stack([self.tracks[t].mean_embd() for t in tids])
        ce = cand_embds / np.maximum(np.linalg.norm(cand_embds, axis=-1, keepdims=True), 1e-6)
        cos = mem @ ce.T  # [T, N]
        bisoft = (softmax(cos, 0) + softmax(cos, 1)) / 2
        sim = 0.5 * (cos + bisoft)
        # spatial-IoU gate on overlapping frames
        for ti, t in enumerate(tids):
            tr = self.tracks[t]
            for ci in range(len(cand_embds)):
                siou = _mask_overlap(tr, cand_masks[ci], frame_start)
                if siou is not None and siou < self.siou_gate:
                    sim[ti, ci] = -1.0
        return sim

    def update(self, frame_start: int, embds: np.ndarray, logits: np.ndarray,
               masks: np.ndarray):
        """embds [N, C]; logits [N, K] (sigmoid scores); masks [N, T, h, w]
        mask logits for frames [frame_start, frame_start+T)."""
        N = embds.shape[0]
        tids = list(self.tracks)
        sim = self._similarity(embds, masks, frame_start)
        assigned = np.full(N, -1, np.int64)
        if sim.size:
            ri, ci = linear_sum_assignment(-sim)
            for a, b in zip(ri, ci):
                if sim[a, b] >= self.match_threshold:
                    assigned[b] = tids[a]
        for ci in range(N):
            tid = assigned[ci]
            if tid < 0:
                if logits[ci].max() < self.new_score_thres or len(self.tracks) >= self.max_tracks:
                    continue
                tid = self._next
                self._next += 1
                self.tracks[tid] = Track(tid)
            tr = self.tracks[tid]
            tr.embds.append(embds[ci])
            tr.logits.append(logits[ci])
            for t in range(masks.shape[1]):
                f = frame_start + t
                if f in tr.masks:
                    tr.masks[f] = (tr.masks[f] + masks[ci, t]) / 2  # overlap averaging
                else:
                    tr.masks[f] = masks[ci, t]
            tr.last_frame = frame_start + masks.shape[1] - 1

    def results(self, video_len: int, topk: int = 25) -> List[Dict]:
        out = []
        for tr in self.tracks.values():
            score = tr.score()
            out.append({
                "track_id": tr.track_id,
                "score": score,
                "category_id": int(score.argmax()),
                "masks": {f: m for f, m in tr.masks.items() if f < video_len},
            })
        out.sort(key=lambda r: -float(np.max(r["score"])))
        return out[:topk]


def get_ctt_similarity(saved_query_embeds: np.ndarray, input_query_embeds: np.ndarray) -> np.ndarray:
    """Bisoftmax query similarity (reference:
    mdqe_overtracker_efficient.py:368-383 get_ctt_similarity)."""
    N_s = saved_query_embeds.shape[0]
    N_i = input_query_embeds.shape[0]
    if N_s == 1 and N_i == 1:
        a = saved_query_embeds / np.maximum(
            np.linalg.norm(saved_query_embeds, axis=-1, keepdims=True), 1e-12)
        b = input_query_embeds / np.maximum(
            np.linalg.norm(input_query_embeds, axis=-1, keepdims=True), 1e-12)
        return a @ b.T
    feats = saved_query_embeds @ input_query_embeds.T  # [N_s, N_i]
    d2t = softmax(feats, 0)
    t2d = softmax(feats, 1)
    ws = 1 if N_s > 1 else 0
    wi = 1 if N_i > 1 else 0
    return (ws * d2t + wi * t2d) / max(ws + wi, 1)


class MDQETracker:
    """Faithful numpy rebuild of ``MDQE_OverTrackerEfficient``
    (reference: univs/modeling/tracking/mdqe_overtracker_efficient.py:
    12-365) — window-resident per-clip mask-logit memory, long/short
    bisoftmax (ctt) matching combined with overlap-frame soft-IoU,
    repeated-detection suppression, untracked-frame aging, and the
    window-rollover bookkeeping of ``get_result``.

    Frame indices are LOCAL to the current window's memory
    (``saved_frame_idx = range(mem_length)``), exactly like the
    reference; callers shift indices at window rollover.  Mask logits
    are stored at whatever resolution the caller provides (the unified
    path passes 1/4 res).
    """

    def __init__(self, num_classes: int, num_frames: int,
                 num_frames_window_track: int, clip_stride: int,
                 embed_dim: int, apply_cls_thres: float = 0.25,
                 data_name: str = "ytvis"):
        self.num_classes = num_classes
        self.num_frames = num_frames
        self.window_frames = num_frames_window_track
        self.clip_stride = clip_stride
        self.embed_dim = embed_dim
        self.apply_cls_thres = apply_cls_thres

        self.mem_length = num_frames_window_track + num_frames
        self.num_clips = num_frames_window_track // clip_stride + 2

        # cost-matrix params (reference :49-56)
        self.siou_match_threshold = 0.05
        self.ctt_match_threshold = 0.75
        self.beta_siou = 1
        self.beta_ctt = 1
        self.weighted_manner = True
        self.num_clip_mem_long = (30 // clip_stride) if "ytvis" in data_name else (10 // clip_stride)
        self.weights_mem = np.exp(np.arange(self.num_clip_mem_long) * 0.25)

        self.saved_frame_idx = list(range(self.mem_length))
        self.image_size = None
        self.num_inst = 0
        self.num_inst_prev_windows = 0
        self.num_clip = 0
        self.num_window = 0
        self.saved_idx_set: set = set()

    # ------------------------------------------------------------------

    def _init_memory(self, is_first=False, image_size=None, num_insts=None):
        if is_first:
            assert image_size is not None and num_insts
            self.image_size = tuple(image_size)
            self.num_max_inst = 2 * num_insts
            self.saved_inst_id = np.arange(self.num_max_inst)
        else:
            self.num_clip = 1
            self.saved_idx_set = set(range(self.num_frames - 1))
            self.num_max_inst = (
                int(1.5 * self.num_inst) if self.num_inst < 50 else int(1.2 * self.num_inst)
            )
        C, N, L = self.num_clips, self.num_max_inst, self.mem_length
        self.saved_logits = np.zeros((C, N, L, *self.image_size), np.float32)
        self.saved_valid = np.zeros((C, N, L), bool)
        self.saved_cls = np.zeros((C, N, self.num_classes), np.float32)
        self.saved_query_embeds = np.zeros((C, N, self.embed_dim), np.float32)
        self.saved_untracked_frames_mem = np.zeros(N, np.float32)
        self.saved_query_embeds_mem = np.zeros((N, self.embed_dim), np.float32)

    def _expand_memory(self, n):
        C, L = self.num_clips, self.mem_length

        def pad(a, shape):
            return np.concatenate([a, np.zeros(shape, a.dtype)], axis=1)

        self.saved_logits = pad(self.saved_logits, (C, n, L, *self.image_size))
        self.saved_valid = pad(self.saved_valid, (C, n, L))
        self.saved_cls = pad(self.saved_cls, (C, n, self.num_classes))
        self.saved_query_embeds = pad(self.saved_query_embeds, (C, n, self.embed_dim))
        self.saved_untracked_frames_mem = np.concatenate(
            [self.saved_untracked_frames_mem, np.zeros(n, np.float32)])
        self.saved_query_embeds_mem = np.concatenate(
            [self.saved_query_embeds_mem, np.zeros((n, self.embed_dim), np.float32)])
        max_id = int(self.saved_inst_id.max()) + 1
        self.saved_inst_id = np.concatenate([self.saved_inst_id, max_id + np.arange(n)])
        self.num_max_inst += n

    def _update_memory(self, r_idx, c_idx, clip):
        start = min(clip["frame_idx"])
        end = max(clip["frame_idx"])
        if len(r_idx) and max(r_idx) >= self.num_max_inst:
            self._expand_memory(len([1 for i in r_idx if i >= self.num_max_inst]))
        r_idx = list(r_idx)
        c_idx = list(c_idx)
        self.saved_logits[self.num_clip, r_idx, start:end + 1] = clip["mask_logits"][c_idx]
        self.saved_valid[self.num_clip, r_idx, start:end + 1] = True
        self.saved_cls[self.num_clip, r_idx] = clip["cls_probs"][c_idx]
        self.saved_query_embeds[self.num_clip, r_idx] = clip["query_embeds"][c_idx]

        self.saved_untracked_frames_mem += 1
        self.saved_untracked_frames_mem[r_idx] = 0
        if self.num_clip > 0 and self.weighted_manner:
            start_clip = max(self.num_clip - 1, 0)
            q = self.saved_query_embeds[start_clip:self.num_clip + 1][:, r_idx]  # [C', n, E]
            w = self.weights_mem[: q.shape[0]].reshape(-1, 1, 1)
            valid = (q != 0).any(-1)[..., None]
            self.saved_query_embeds_mem[r_idx] = (q * w).sum(0) / np.maximum(
                (valid * w).sum(0), 1.0
            )
        else:
            self.saved_query_embeds_mem[r_idx] = clip["query_embeds"][c_idx]

    def _get_siou(self, saved_masks, input_masks):
        """Soft-IoU of thresholded sigmoid masks (reference :165-200;
        the crowded-object downsampling there is a memory optimization
        that changes numbers — we apply it identically)."""
        H, W = input_masks.shape[-2:]
        if saved_masks.shape[0] >= 20 or input_masks.shape[0] >= 20:
            import torch
            import torch.nn.functional as F

            input_masks = F.interpolate(
                torch.from_numpy(input_masks), size=(H // 2, W // 2),
                mode="bilinear", align_corners=False).numpy()
            saved_masks = F.interpolate(
                torch.from_numpy(saved_masks), size=(H // 2, W // 2),
                mode="bilinear", align_corners=False).numpy()
        i = (input_masks.reshape(input_masks.shape[0], -1) > 0.5).astype(np.float32)
        s = (saved_masks.reshape(saved_masks.shape[0], -1) > 0.5).astype(np.float32)
        inter = s @ i.T
        union = s.sum(-1)[:, None] + i.sum(-1)[None] - inter
        return inter / np.maximum(union, 1.0)

    # ------------------------------------------------------------------

    def update(self, clip: Dict, is_first_clip: bool = False):
        """clip: {scores [N], mask_logits [N, T, H, W], cls_probs [N, K],
        query_embeds [N, E], frame_idx: list of window-local indices}."""
        n_in = len(clip["scores"])
        if is_first_clip:
            self._init_memory(is_first=True, image_size=clip["mask_logits"].shape[-2:],
                              num_insts=n_in)

        if self.num_inst == 0:
            matched_ID = matched_idx = list(range(n_in))
            self.num_inst += n_in
        else:
            q_mem = self.saved_query_embeds_mem[: self.num_inst]
            still = np.nonzero(
                self.saved_untracked_frames_mem[: self.num_inst] < self.num_clip_mem_long
            )[0]
            scores_mem = np.zeros((self.num_inst, n_in), np.float32)
            scores_all = get_ctt_similarity(q_mem, clip["query_embeds"])
            scores_mem[still] = scores_all[still]

            # overlap-frame soft IoU (reference :224-245)
            inter_in, inter_saved = [], []
            for o_i, f_i in enumerate(clip["frame_idx"]):
                if f_i in self.saved_idx_set:
                    inter_in.append(o_i)
                    inter_saved.append(self.saved_frame_idx.index(f_i))
            if len(inter_saved) == 0:
                siou = np.zeros((self.num_inst, n_in), np.float32)
            else:
                i_masks = clip["mask_logits"][:, inter_in]
                s_masks = self.saved_logits[: self.num_clip, : self.num_inst][:, :, inter_saved]
                s_valid = self.saved_valid[: self.num_clip, : self.num_inst].any(-1)
                s_masks = s_masks.sum(0) / np.maximum(
                    s_valid.sum(0), 1
                ).reshape(-1, 1, 1, 1)
                siou = self._get_siou(_sigmoid(s_masks), _sigmoid(i_masks))

            scores = self.beta_ctt * scores_mem + self.beta_siou * siou
            thr = self.beta_ctt * self.ctt_match_threshold + self.beta_siou * self.siou_match_threshold
            above = scores > thr
            scores = scores * above
            ri, ci = linear_sum_assignment(-scores)
            matched_ID, matched_idx = [], []
            for r, c in zip(ri, ci):
                if not above[r, c]:
                    continue
                matched_ID.append(int(r))
                matched_idx.append(int(c))
                scores_mem[r, c] = 0
                siou[r, c] = -1

            # repeated-detection suppression (reference :267-278)
            repeated = []
            for idx in range(n_in):
                if idx in matched_idx:
                    continue
                is_rep = scores_mem[:, idx].max() > self.ctt_match_threshold
                is_rep = is_rep and (siou[:, idx].max() > 0.4)
                if is_rep:
                    repeated.append(idx)
            unmatched = [i for i in range(n_in)
                         if i not in matched_idx + repeated
                         and clip["scores"][i] > 2 * self.apply_cls_thres]
            new_ids = list(range(self.num_inst, self.num_inst + len(unmatched)))
            matched_ID += new_ids
            matched_idx += unmatched
            self.num_inst += len(new_ids)

        self._update_memory(matched_ID, matched_idx, clip)
        self.saved_idx_set.update(set(clip["frame_idx"]))
        self.num_clip += 1

    def get_result(self, is_last_clip: bool = False) -> Dict:
        """Window emission + rollover (reference :298-365)."""
        self.num_window += 1
        ml = self.saved_logits[: self.num_clip, : self.num_inst]
        valid = self.saved_valid[: self.num_clip, : self.num_inst]
        mask_logits = ml.sum(0) / np.maximum(valid.sum(0), 1)[..., None, None]
        len_frames = self.window_frames if not is_last_clip else max(self.saved_idx_set) + 1
        out_masks = mask_logits[:, :len_frames]

        cls = self.saved_cls[: self.num_clip, : self.num_inst]
        valid_clip = valid.any(-1)[..., None]
        out_cls = (cls * valid_clip).sum(0) / np.maximum(valid_clip.sum(0), 1)

        q_mem = self.saved_query_embeds_mem[: self.num_inst]
        untracked = self.saved_untracked_frames_mem[: self.num_inst]
        out_inst_id = self.saved_inst_id[: self.num_inst].copy()
        valid_inst_prev = out_inst_id < self.num_inst_prev_windows

        if not is_last_clip:
            valid_track = untracked < self.num_clip_mem_long
            valid_cls = out_cls.max(-1) > self.apply_cls_thres
            valid_cur = valid_cls | valid_track
            self.num_inst = int(valid_cur.sum())

            old_valid = valid
            self._init_memory()
            self.saved_logits[0, : self.num_inst, : self.mem_length - self.window_frames] = \
                mask_logits[:, self.window_frames:][valid_cur]
            self.saved_valid[0, : self.num_inst, : self.mem_length - self.window_frames] = \
                old_valid[-self.num_frames + 1:, :, self.window_frames:].any(0)[valid_cur]
            self.saved_query_embeds[0, : self.num_inst] = q_mem[valid_cur]
            self.saved_cls[0, : self.num_inst] = out_cls[valid_cur]
            self.saved_query_embeds_mem[: self.num_inst] = q_mem[valid_cur]
            self.saved_untracked_frames_mem[: self.num_inst] = untracked[valid_cur]

            saved_id = out_inst_id[valid_cur]
            n_newly = int((saved_id >= self.num_inst_prev_windows).sum())
            newly_ids = self.num_inst_prev_windows + np.arange(n_newly)
            if n_newly > 0:
                saved_id[-n_newly:] = newly_ids
            self.num_inst_prev_windows += n_newly
            self.saved_inst_id = np.concatenate([
                saved_id,
                np.arange(self.num_max_inst - len(saved_id)) + self.num_inst_prev_windows,
            ])

            valid_out = valid_inst_prev | valid_cur
            out_cls = out_cls[valid_out]
            out_masks = out_masks[valid_out]
            out_inst_id = out_inst_id[valid_out]
            if n_newly > 0:
                out_inst_id[-n_newly:] = newly_ids
        return {"pred_masks": out_masks, "pred_cls_scores": out_cls, "obj_ids": out_inst_id}


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x: np.ndarray, axis: int) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / np.maximum(e.sum(axis=axis, keepdims=True), 1e-9)


def _mask_overlap(track: Track, cand_mask: np.ndarray, frame_start: int) -> Optional[float]:
    """IoU between the track's stored masks and a candidate on shared frames."""
    ious = []
    for t in range(cand_mask.shape[0]):
        f = frame_start + t
        if f in track.masks:
            a = track.masks[f] > 0
            b = cand_mask[t] > 0
            u = np.logical_or(a, b).sum()
            if u > 0:
                ious.append(np.logical_and(a, b).sum() / u)
    return float(np.mean(ious)) if ious else None
