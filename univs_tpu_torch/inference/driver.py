"""Video inference driver, VIS / VPS / VSS (counterpart of
``EntityDriver`` in ``univs_tpu/inference/driver.py``).

``EntityDriver`` streams one video: backbone + pixel decoder once per
``num_frames_window`` frames (uint8 frames uploaded, normalized on the
device), ``entity_clip_step`` once per clip from the ONE clip schedule
``_iter_clips``, window emission with eviction, and at the end of the
video the drain.  VIS: only the finally-valid entity rows are
upsampled, thresholded and bit-packed on the device, then fetched and
turned into per-frame RLEs on the host (``assemble_vis_results``).  VPS
(``run_vps``): the pixel newly-entity variant, raw (undivided) windows
of every slot, and the reference's panoptic stitching on the host in
numpy.  VSS (``run_vss``): per-clip semantic labels from the learnable
queries, no cross-clip state.

``start_vis`` / ``finish_vis`` keep the JAX package's pipelined API; in
this port they run in order on the current stream (overlapping the
upload and the drain on side streams is listed in ROADMAP.md).
``EntityDriver(pipeline_devices=(encode, decode))`` splits a video over
two devices as the JAX driver does (``driver.py:261-279,395-406``): the
parameters sit on both, the window encode runs on the first, its
features go to the second with ``non_blocking`` copies, and the next
window's encode is dispatched as soon as the current one is, so the two
devices overlap.  The
pool is updated in place; every emitted window is a copy taken before
``evict_window`` / ``shift_clip`` mutate the pool.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from univs_tpu_torch.config import UniVSConfig
from univs_tpu_torch.inference import memory_pool as mp
from univs_tpu_torch.inference.entity import EntityClipConfig, entity_clip_step
from univs_tpu_torch.inference.vos import inject_gt_first_appearance, vos_clip_step
from univs_tpu_torch.models.univs import UniVSModel, build_model, compute_dtype_of
from univs_tpu_torch.structures import TextPrompts
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


class _StreamingDriver:
    """What the category-guided and the prompt-guided drivers share: the
    model on the device, the window encode and the one clip / window /
    emission schedule."""

    # the JAX package's VIS loop re-encodes a window when the clip's last
    # real frame passes it (min(i + T, V)); its VOS loop when i + T does
    tail_clamped_encode = True

    def __init__(self, cfg: UniVSConfig, params=None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        if isinstance(params, UniVSModel):
            self.model = params.to(self.device)
        else:
            self.model = build_model(cfg, params, seed=seed, device=self.device)
        self.dtype = compute_dtype_of(cfg)
        inf = cfg.inference
        self.T = inf.num_frames
        self.stride = inf.clip_stride
        self.window = inf.num_frames_window
        self.out_window = max(self.window - self.T, self.T)
        self._modules = (self.model.pixel_decoder, self.model.decoder)
        self._enc_model = None  # the encode device's copy when pipelined
        self.frames_device = self.device

    def _pipeline(self, encode_device) -> None:
        """Run the window encode on ``encode_device`` (a copy of the model
        there, unless it is the decode device) and pipeline it one window
        ahead of the clip steps."""
        enc = resolve_device(encode_device)
        self._enc_model = self.model if enc == self.device else copy.deepcopy(self.model).to(enc)
        self.frames_device = enc

    @torch.no_grad()
    def encode_window(self, frames: torch.Tensor, videos: int = 1):
        """[n, H, W, 3] raw frames (uint8 or float) on the device, the
        windows of ``videos`` videos one after another -> (mask_features
        [n, H/4, W/4, C], multi-scale tuple), per frame, on the decode
        device."""
        if self._enc_model is None:
            return self._encode(self.model, frames, videos)
        # the kernels launch on the current device's stream: make it the
        # encode device's
        guard = torch.cuda.device(frames.device) if frames.is_cuda else contextlib.nullcontext()
        with guard:
            mask_features, ms = self._encode(self._enc_model, frames, videos)
        move = lambda t: t.to(self.device, non_blocking=True)
        return move(mask_features), tuple(move(m) for m in ms)

    @staticmethod
    def _encode(model, frames: torch.Tensor, videos: int = 1):
        """The backbone once per video's window, so that a video's features
        do not depend on the batch it is served in (cuDNN rounds a
        convolution by the algorithm it picks for the batch size); the
        pixel decoder once over every frame, so A, B and C run once per
        encoder layer for the whole batch."""
        x = model.normalize(frames)
        if videos == 1:
            feats = model.backbone(x)
        else:
            parts = [model.backbone(chunk) for chunk in x.chunk(videos)]
            feats = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        mask_features, _, _, ms = model.pixel_decoder(feats)
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
            end = min(i + self.T, V) if self.tail_clamped_encode else i + self.T
            if end > window_range[1]:
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

    @torch.no_grad()
    def _clip_loop(self, frames_d: torch.Tensor, pools: Sequence[mp.EntityMemory], clip_step,
                   on_emit) -> None:
        """The clip loop over B videos in lockstep on the device
        (``frames_d`` [B, V, H, W, 3], one pool each; a single video is
        B = 1): the window encode when a clip needs one, with the video
        axis folded into the frame axis (one encode of B x window
        frames, the backbone once per video), ``clip_step(b, feats, clip)``
        on each video's pool, then
        per due emission and video ``on_emit(b, start, n_out)`` before
        ``evict_window`` drops exactly n_out frames (the trailing T
        overlap frames stay and keep accumulating), and ``shift_clip``
        unless it is the last clip.  ``on_emit`` must copy what it keeps:
        the pools are updated in place."""
        B, V = frames_d.shape[:2]
        plan = list(self._iter_clips(V))
        starts = [c["new_window"] for c in plan if c["new_window"] is not None]
        ahead = {}

        def encode(i0):
            idx = torch.as_tensor(np.minimum(np.arange(i0, i0 + self.window), V - 1),
                                  device=frames_d.device)
            n = int(idx.numel())
            mf, ms = self.encode_window(frames_d[:, idx].reshape(B * n, *frames_d.shape[2:]), B)
            return mf.reshape(B, n, *mf.shape[1:]), tuple(m.reshape(B, n, *m.shape[1:]) for m in ms)

        feats_window = None
        for c in plan:
            if c["new_window"] is not None:
                i0 = c["new_window"]
                feats_window = ahead.pop(i0) if i0 in ahead else encode(i0)
                k = starts.index(i0)
                if self._enc_model is not None and k + 1 < len(starts):
                    ahead[starts[k + 1]] = encode(starts[k + 1])
            mf_w, ms_w = feats_window
            rel = torch.as_tensor(c["rel"], device=self.device)
            for b in range(B):
                clip_step(b, (mf_w[b, rel], tuple(m[b, rel] for m in ms_w)), c)
            for start, n_out in c["emits"]:
                for b, pool in enumerate(pools):
                    on_emit(b, start, n_out)
                    mp.evict_window(pool, n_out)
            if not c["is_last"]:
                for pool in pools:
                    mp.shift_clip(pool, self.stride)

    def num_window_encodes(self, V: int) -> int:
        return sum(c["new_window"] is not None for c in self._iter_clips(V))

    def _new_pool(self, capacity: int, num_classes: int, H: int, W: int) -> mp.EntityMemory:
        return mp.create_entity_memory(
            capacity, num_classes, self.cfg.decoder.hidden_dim, (H // 4, W // 4),
            window=self.out_window + self.T, num_prompt_points=self.cc.num_dense_points,
            embd_history=8, prompt_history=self.T + self.stride, device=self.device,
        )


class EntityDriver(_StreamingDriver):
    """Category-guided VIS / VPS / VSS over one video.

    Args:
        cfg: UniVSConfig
        params: a ``UniVSModel`` already built, its state_dict (e.g. from
            ``utils.weights.state_dict_from_flax``), or None for the
            port's seeded init (``seed``)
        num_classes: K of the category bank slice
        capacity: entity slots E
        device: None -> the card (raises without one); "cpu" explicitly
        thing_class_ids: 1-based thing classes of a panoptic dataset,
            ``run_vps``'s default
        pipeline_devices: optional (encode device, decode device): the
            window encode on the first, the clip steps and the pool on
            the second (``device`` is then the decode device); None runs
            everything on ``device``
    """

    def __init__(self, cfg: UniVSConfig, params=None, num_classes: int = 1, capacity: int = 40,
                 device=None, seed: int = 0, thing_class_ids: Optional[Sequence[int]] = None,
                 pipeline_devices=None):
        if pipeline_devices is not None:
            device = pipeline_devices[1]
        super().__init__(cfg, params, device, seed)
        if pipeline_devices is not None:
            self._pipeline(pipeline_devices[0])
        self.num_classes = num_classes
        self.capacity = capacity
        self.thing_class_ids = None if thing_class_ids is None else tuple(thing_class_ids)
        inf = cfg.inference
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
        # the VPS panoptic newly-entity variant (reference dispatch
        # inference_video_entity.py:367-370)
        self.cc_pixel = dataclasses.replace(self.cc, variant="pixel")

    def _emit(self, pool: mp.EntityMemory, out_frames: int, divide: bool):
        """A copy of the first ``out_frames`` window frames, fp16, divided
        by occurrence (VIS, save_results_vis:931) or raw (VPS,
        save_results_vps:984); the per-window class-score snapshot
        (logits-history mean, :926); for VPS a snapshot of ``valid``,
        which the pool's later in-place updates would change (VIS reads
        the final ``valid``)."""
        win = pool.mask_logits[:, :out_frames]
        if divide:
            win = win / pool.occurrence[:, :out_frames].clamp(min=1.0)[:, :, None, None]
        scores = pool.logits_sum / pool.logits_count.clamp(min=1)[:, None]
        return win.to(torch.float16), scores, None if divide else pool.valid.clone()

    @torch.no_grad()
    def _dispatch(self, frames, cls_emb, divide: bool, thing_mask=None, next_frames=None) -> Dict:
        """One video's whole clip loop; ``thing_mask`` ([K] bool) selects
        the VPS pixel newly-entity variant, ``divide`` the VIS windows
        (else raw).  ``next_frames`` (the NEXT video) is uploaded after
        this video's compute."""
        V, H, W = frames.shape[:3]
        dev = self.device
        pool = self._new_pool(self.capacity, self.num_classes, H, W)
        # the caller's dtype is kept: uint8 frames move 4x fewer bytes and
        # are normalized on the device inside the window encode
        frames_d = torch.as_tensor(frames).to(self.frames_device)
        cls_emb = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)
        cc = self.cc
        if thing_mask is not None:
            thing_mask = torch.as_tensor(thing_mask, dtype=torch.bool, device=dev)
            cc = self.cc_pixel

        emitted: List[torch.Tensor] = []
        emit_starts: List[int] = []
        emit_scores: List[torch.Tensor] = []
        emit_valids: List[torch.Tensor] = []

        def clip_step(_, feats, c):
            entity_clip_step(self._modules, feats, pool, c["clip_idx"], c["offset"], c["i"] == 0,
                             cls_emb, cc, thing_mask)

        def on_emit(_, start, n_out):
            win, scores, valid = self._emit(pool, n_out, divide)
            emitted.append(win)
            emit_scores.append(scores)
            if valid is not None:
                emit_valids.append(valid)
            emit_starts.append(start)

        self._clip_loop(frames_d[None], [pool], clip_step, on_emit)

        next_dev = None
        if next_frames is not None:
            next_dev = torch.as_tensor(next_frames).to(self.frames_device)
        return {
            "V": V, "pool": pool, "emitted": emitted, "emit_starts": emit_starts,
            "emit_scores": emit_scores, "emit_valids": emit_valids,
            "next_frames_device": next_dev, "drained": False,
        }

    @torch.no_grad()
    def _queue_drain(self, h: Dict, packed_sizes=None) -> None:
        """With ``packed_sizes`` (image, out, padded size): upsample +
        threshold + bit-pack only the finally-valid entity rows of every
        emitted window (one host sync on ``valid``); without, the windows
        stay fp16 quarter-resolution logits of every slot."""
        if h["drained"]:
            return
        h["drained"] = True
        entity_rows = None
        if packed_sizes is not None:
            entity_rows = np.flatnonzero(h["pool"].valid.cpu().numpy())
            if entity_rows.size:
                idx = torch.as_tensor(entity_rows, device=self.device)
                h["emitted"] = [_upsample_threshold_pack(m[idx], *packed_sizes) for m in h["emitted"]]
            else:
                oh, ow = packed_sizes[1]
                h["emitted"] = [torch.zeros((0, m.shape[1], oh, (ow + 7) // 8), dtype=torch.uint8)
                                for m in h["emitted"]]
        h["entity_rows"] = entity_rows

    def _fetch(self, h: Dict):
        emitted = [m.cpu().numpy() for m in h["emitted"]]
        emit_scores = [s.cpu().numpy() for s in h["emit_scores"]]
        emit_valids = [v.cpu().numpy() for v in h["emit_valids"]]
        return emitted, h["emit_starts"], emit_scores, emit_valids, h["pool"], h["entity_rows"]

    def _stream(self, frames, cls_emb, divide: bool, thing_mask=None):
        """Dispatch + drain (unpacked) + fetch one video -> (emitted fp16
        windows of every slot, window starts, score snapshots, valid
        snapshots, final pool, entity_rows=None)."""
        h = self._dispatch(frames, cls_emb, divide, thing_mask=thing_mask)
        self._queue_drain(h)
        return self._fetch(h)

    # -- VIS API ---------------------------------------------------------

    def start_vis(self, frames, cls_emb, image_size=None, out_size=None, next_frames=None) -> Dict:
        """Run one video's VIS compute; returns a handle for
        :meth:`finish_vis`.  ``next_frames`` (the NEXT video) is uploaded
        after this video's compute; read it back from
        ``handle['next_frames_device']``."""
        V, H, W = frames.shape[:3]
        image_size = tuple(image_size or (H, W))
        out_size = tuple(out_size or image_size)
        h = self._dispatch(frames, cls_emb, divide=True, next_frames=next_frames)
        h["sizes"] = (image_size, out_size, (H, W))
        return h

    def finish_vis(self, h: Dict) -> List[Dict]:
        """Drain + assemble a :meth:`start_vis` handle into per-entity results."""
        self._queue_drain(h, h["sizes"])
        emitted, emit_starts, emit_scores, _, pool, entity_rows = self._fetch(h)
        return assemble_vis_results(
            emitted, emit_starts, emit_scores, pool.valid.cpu().numpy(),
            pool.quality_sum.cpu().numpy(), h["V"], h["sizes"][1], entity_rows)

    def run_vis(self, frames, cls_emb, image_size=None, out_size=None) -> List[Dict]:
        """frames [V, H, W, 3] raw RGB (padded to divisibility) -> per-entity
        dicts with per-frame RLEs and class scores
        (inference_video_entity.py:914-961)."""
        return self.finish_vis(self.start_vis(frames, cls_emb, image_size, out_size))

    # -- VSS / VPS -------------------------------------------------------

    @torch.no_grad()
    def run_vss(self, frames, cls_emb, image_size=None, out_size=None) -> np.ndarray:
        """VSS: per-clip semantic argmax from the learnable queries, no
        cross-clip state; clips of T frames at stride T, each encoding
        its own frames, the short tail clip at its true length (reference:
        inference_video_entity.py:299,357-360,1096-1132; the law is
        ``vss_semantic_labels``, the final nearest resize to ``out_size``
        runs on the host after the argmax, with which it commutes).
        Returns per-frame class maps [V, out_h, out_w] int32."""
        V, H, W = frames.shape[:3]
        image_size = tuple(image_size or (H, W))
        out_size = tuple(out_size or image_size)
        dev = self.device
        frames_d = torch.as_tensor(frames).to(self.frames_device)
        cls_emb = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)
        decoder = self.model.decoder
        labels = np.zeros((V, *out_size), np.int32)
        for i in range(0, V, self.T):
            Tc = min(self.T, V - i)
            clip_idx = np.minimum(np.arange(i, i + self.T), V - 1)
            mf, ms = self.encode_window(frames_d[torch.as_tensor(clip_idx, device=frames_d.device)])
            if Tc < self.T:  # the true short tail clip (reference semantics)
                mf, ms = mf[:Tc], tuple(m[:Tc] for m in ms)
            fi = torch.as_tensor(clip_idx[:Tc], device=dev)[None]
            out = decoder(ms, mf, fi, task="detection", cls_emb=cls_emb)
            sem = vss_semantic_labels(out["pred_logits"][0], out["pred_masks"][0], (H, W),
                                      image_size)
            labels[i:i + Tc] = _resize_labels_nearest(sem.cpu().numpy(), out_size)
        return labels

    def run_vps(self, frames, cls_emb, thing_class_ids=None, image_size=None, out_size=None):
        """VPS: entity tracking with the pixel newly-entity variant, raw
        (undivided) windows of every slot, then the panoptic stitching on
        the host (``assemble_vps_results``).  ``thing_class_ids`` are
        1-based; None takes the constructor's.  Returns (panoptic [V,
        out_h, out_w] int32 segment ids, segments_info list)."""
        if thing_class_ids is None:
            thing_class_ids = self.thing_class_ids
        if thing_class_ids is None:
            raise ValueError("run_vps needs thing_class_ids, here or in the constructor")
        V, H, W = frames.shape[:3]
        image_size = tuple(image_size or (H, W))
        out_size = tuple(out_size or image_size)
        K = int(cls_emb.shape[0])
        emitted, emit_starts, emit_scores, emit_valids, _, _ = self._stream(
            frames, cls_emb, divide=False, thing_mask=vps_thing_mask(thing_class_ids, K))
        return assemble_vps_results(emitted, emit_starts, emit_scores, emit_valids, V,
                                    thing_class_ids, self.cfg.inference.overlap_threshold,
                                    image_size, out_size, (H, W))


class VOSDriver(_StreamingDriver):
    """Prompt-guided VOS / PVOS (``run``: GT masks at first appearance)
    and RefVOS (``run_grounding``: expressions as text prompts) over one
    video, the host loop of the JAX package's ``VOSDriver``: a window of
    ``num_frames_window`` frames encoded when ``i + T`` passes it,
    ``vos_clip_step`` once per clip at ``clip_offset = i - emitted``, the
    emission ``while``, ``shift_clip`` unless it is the last clip.  The
    pool is updated in place; every emitted window is an fp16 copy taken
    before ``evict_window`` / ``shift_clip`` mutate it.  The label maps
    and per-expression masks are upsampled and thresholded on the device
    frame by frame, as the JAX package does on the host.

    Args:
        cfg: UniVSConfig
        params: a ``UniVSModel`` already built, its state_dict, or None
            for the port's seeded init (``seed``)
        capacity: pool slots (the number of objects or expressions, padded)
        num_classes: K of ``cls_emb``
        query_mode: 'prompt' | 'learn' | 'prompt+learn' (VOS back end)
        device: None -> the card (raises without one); "cpu" explicitly
    """

    tail_clamped_encode = False

    def __init__(self, cfg: UniVSConfig, params=None, capacity: int = 1, num_classes: int = 1,
                 query_mode: str = "prompt", device=None, seed: int = 0):
        super().__init__(cfg, params, device, seed)
        self.capacity = capacity
        self.num_classes = num_classes
        self.query_mode = query_mode
        self.cc = EntityClipConfig(
            num_queries=cfg.decoder.num_queries,
            num_prev_frames_memory=cfg.prompt.num_prev_frames_memory,
            num_dense_points=cfg.prompt.num_dense_points_test,
            clip_stride=self.stride, num_frames=self.T,
            prev_visual_prompts_for_grounding=cfg.inference.enabled_prev_visual_prompts_for_grounding,
        )

    def _stream(self, frames, pool, clip_step) -> List:
        """The clip loop over one video; ``clip_step(feats, clip)`` runs
        one clip on ``pool``.  Returns [(start, fp16 window copy)]."""
        emitted = []
        self._clip_loop(torch.as_tensor(frames).to(self.device)[None], [pool],
                        lambda _, feats, c: clip_step(feats, c),
                        lambda _, start, n_out: emitted.append(
                            (start, pool.mask_logits[:, :n_out].to(torch.float16))))
        return emitted

    @torch.no_grad()
    def run(self, frames, gt_masks_14, faf, obj_valid, cls_emb, image_size=None,
            out_size=None) -> np.ndarray:
        """frames [V, H, W, 3]; gt_masks_14 [N, V, H/4, W/4] binary (only
        first-appearance frames need data); faf [N] first-appear frames
        (-1 never); obj_valid [N].  Returns per-frame label maps [V,
        out_h, out_w] uint8 (0 = background, i + 1 = object i)."""
        V, H, W = frames.shape[:3]
        image_size = tuple(image_size or (H, W))
        out_size = tuple(out_size or image_size)
        dev = self.device
        pool = self._new_pool(self.capacity, self.num_classes, H, W)
        gt = torch.as_tensor(np.asarray(gt_masks_14)).to(dev)
        faf_d = torch.as_tensor(np.asarray(faf), dtype=torch.int32, device=dev)
        ov_d = torch.as_tensor(np.asarray(obj_valid), dtype=torch.bool, device=dev)
        cls_emb = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)

        def clip_step(feats, c):
            idx = torch.as_tensor(c["clip_idx"], device=dev)
            inject_gt_first_appearance(pool, gt[:, idx].to(torch.float32), faf_d, ov_d,
                                       c["clip_idx"], c["offset"])
            vos_clip_step(self._modules, feats, pool, c["clip_idx"], c["offset"], cls_emb, self.cc,
                          query_mode=self.query_mode)

        emitted = self._stream(frames, pool, clip_step)
        labels = torch.zeros((V, *out_size), dtype=torch.uint8, device=dev)
        for start, win in emitted:
            for k in range(min(win.shape[1], V - start)):
                logit = _upsample_logits_device(win[:, k], image_size, out_size, (H, W))
                lab = torch.argmax(logit, dim=0) + 1  # first maximum, as np.argmax
                labels[start + k] = torch.where(logit.amax(0) <= 0, 0, lab).to(torch.uint8)
        return labels.cpu().numpy()

    @torch.no_grad()
    def run_grounding(self, frames, text_embs, text_valid, cls_emb=None,
                      n_expressions: Optional[int] = None, image_size=None,
                      out_size=None) -> np.ndarray:
        """RefVOS: expressions as prompts, no GT injection; every
        expression "appears" at frame 0.  text_embs [1, capacity, 1+77,
        Dt] (``PrepareTargets.grounding_inputs(pad_to=capacity)``),
        text_valid [1, capacity].  Returns per-expression binary masks
        [n_expressions, V, out_h, out_w] uint8."""
        V, H, W = frames.shape[:3]
        image_size = tuple(image_size or (H, W))
        out_size = tuple(out_size or image_size)
        if int(text_embs.shape[1]) != self.capacity:
            raise ValueError(f"pad the text prompts to the driver capacity {self.capacity}, "
                             f"got {tuple(text_embs.shape)}")
        N = n_expressions or self.capacity
        dev = self.device
        pool = self._new_pool(self.capacity, self.num_classes, H, W)
        pool.valid[:N] = True
        pool.first_appear[:N] = 0
        tp = TextPrompts(embs=torch.as_tensor(text_embs).to(device=dev, dtype=torch.float32),
                         valid=torch.as_tensor(text_valid).to(device=dev, dtype=torch.bool))
        if cls_emb is not None:
            cls_emb = torch.as_tensor(cls_emb).to(device=dev, dtype=torch.float32)

        def clip_step(feats, c):
            vos_clip_step(self._modules, feats, pool, c["clip_idx"], c["offset"], cls_emb, self.cc,
                          text_prompts=tp, task="grounding")

        emitted = self._stream(frames, pool, clip_step)
        out = torch.zeros((N, V, *out_size), dtype=torch.uint8, device=dev)
        for start, win in emitted:
            for k in range(min(win.shape[1], V - start)):
                logit = _upsample_logits_device(win[:N, k], image_size, out_size, (H, W))
                out[:, start + k] = (logit > 0).to(torch.uint8)
        return out.cpu().numpy()


def _upsample_logits_device(mask_logits: torch.Tensor, image_size, out_size, padded_size):
    """[n, h4, w4] logits -> [n, out_h, out_w] float32 on their device:
    bilinear to the padded size, crop, bilinear to the output size (the
    JAX package's ``_upsample_logits``, the same calls)."""
    m = mask_logits.to(torch.float32)[None]
    m = F.interpolate(m, size=tuple(padded_size), mode="bilinear", align_corners=False)
    m = m[:, :, : image_size[0], : image_size[1]]
    m = F.interpolate(m, size=tuple(out_size), mode="bilinear", align_corners=False)
    return m[0]


def vps_thing_mask(thing_class_ids, num_classes: int) -> np.ndarray:
    """1-based thing class ids -> [K] bool."""
    mask = np.zeros((num_classes,), bool)
    for t in thing_class_ids:
        if 1 <= int(t) <= num_classes:
            mask[int(t) - 1] = True
    return mask


def assemble_vps_results(emitted, emit_starts, emit_scores, emit_valids, V: int, thing_class_ids,
                         overlap_thr: float, image_size, out_size, padded_size):
    """Per-window panoptic stitching on the host in numpy, the JAX
    package's transcription of ``save_results_vps``
    (inference_video_entity.py:963-1094): raw accumulated mask logits
    [E, n, h4, w4] per window, per-window score = history-mean class
    score max x mask quality (0.75 for stuff not yet registered as a
    thing), per-pixel argmax over score-weighted logits, background where
    every sigmoid < 0.5, the per-entity area-ratio filter (halved once a
    thing is tracked), stuff merged by class with persistent segment ids.
    Returns (panoptic [V, out_h, out_w] int32 segment ids, segments_info
    list)."""
    thing_ids = set(int(t) for t in thing_class_ids)  # 1-based
    panoptic = np.zeros((V, *out_size), np.int32)
    thing_memory: Dict[int, int] = {}
    stuff_memory: Dict[int, int] = {}
    final_scores = None

    for win_masks, start, win_scores, win_valid in zip(
        emitted, emit_starts, emit_scores, emit_valids
    ):
        final_scores = win_scores
        n = min(win_masks.shape[1], V - start)
        valid_idx = np.nonzero(win_valid)[0]
        if len(valid_idx) == 0 or n <= 0:
            continue
        E = len(valid_idx)
        cls_scores = win_scores[valid_idx]  # [E, K] history mean
        cur_scores_cls = cls_scores.max(-1)
        cur_classes = cls_scores.argmax(-1) + 1  # 1-based

        def up(t):  # [E, out_h, out_w] raw accumulated logits
            return _upsample_logits(win_masks[valid_idx, t], image_size, out_size, padded_size)

        # pass 1: per-entity quality over the WHOLE window (:998)
        q_pos = np.zeros(E)
        q_tot = np.zeros(E)
        ups = {}
        for t in range(n):
            lg = up(t)
            ups[t] = lg if n <= 8 else None  # cache small windows
            q_pos += (lg > 1).reshape(E, -1).sum(-1)
            q_tot += (lg > -1).reshape(E, -1).sum(-1)
        qual = q_pos / np.maximum(q_tot, 1)
        scores = cur_scores_cls * qual
        for j, e in enumerate(valid_idx):
            if int(cur_classes[j]) not in thing_ids and int(e) not in thing_memory:
                scores[j] *= 0.75  # thing priority (:1000-1001)

        # pass 2: per-pixel argmax (winning entity where its own
        # sigmoid >= 0.5) + window-level area accumulation
        mask_ids_w = np.full((n, *out_size), -1, np.int16)
        winner_on = np.zeros((n, *out_size), bool)  # winner's sig >= 0.5
        mask_area = np.zeros(E, np.int64)
        original_area = np.zeros(E, np.int64)
        painted_count = np.zeros(E, np.int64)
        for t in range(n):
            lg = ups[t] if ups.get(t) is not None else up(t)
            sig = 1.0 / (1.0 + np.exp(-lg))
            prob = scores[:, None, None] * lg
            ids_t = prob.argmax(0).astype(np.int16)
            is_bg = (sig < 0.5).sum(0) == E
            ids_t[is_bg] = -1
            mask_ids_w[t] = ids_t
            win_sig = np.take_along_axis(sig, np.maximum(ids_t, 0)[None], 0)[0]
            winner_on[t] = (ids_t >= 0) & (win_sig >= 0.5)
            for j in range(E):
                sel = ids_t == j
                mask_area[j] += int(sel.sum())
                original_area[j] += int((sig[j] >= 0.5).sum())
                painted_count[j] += int((sel & winner_on[t]).sum())

        # pass 3: register segment ids in entity order (pixels are
        # disjoint, so only the id allocation order matters)
        seg_table = np.zeros(E + 1, np.int32)  # index -1 -> last -> 0
        for j, e in enumerate(valid_idx):
            pred_class = int(cur_classes[j])
            isthing = pred_class in thing_ids
            if mask_area[j] == 0 or original_area[j] == 0 or painted_count[j] == 0:
                continue
            thr = 0.5 * overlap_thr if int(e) in thing_memory else overlap_thr
            if isthing and mask_area[j] / original_area[j] < thr:
                continue
            if not isthing:
                if pred_class not in stuff_memory:
                    stuff_memory[pred_class] = max(
                        list(thing_memory.values()) + list(stuff_memory.values()), default=0) + 1
                seg_table[j] = stuff_memory[pred_class]
            else:
                if int(e) not in thing_memory:
                    thing_memory[int(e)] = max(
                        list(thing_memory.values()) + list(stuff_memory.values()), default=0) + 1
                seg_table[j] = thing_memory[int(e)]

        for t in range(n):
            lab = seg_table[mask_ids_w[t]]
            panoptic[start + t] = np.where(winner_on[t], lab, 0)

    # segments_info from the memory dicts + the final class snapshot
    # (reference: vps_output_results)
    segments_info = []
    cls_final = final_scores.argmax(-1) + 1 if final_scores is not None else None
    for obj_id, seg_id in thing_memory.items():
        c = int(cls_final[obj_id]) if cls_final is not None else 0
        segments_info.append({"id": seg_id, "isthing": c in thing_ids, "category_id": c})
    for stuff_class, seg_id in stuff_memory.items():
        segments_info.append({"id": seg_id, "isthing": False, "category_id": int(stuff_class)})
    return panoptic, segments_info


def vss_semantic_labels(pred_logits: torch.Tensor, pred_masks: torch.Tensor, padded_hw,
                        image_hw) -> torch.Tensor:
    """Per-clip semantic label maps, the transcription of
    ``save_results_vss`` (inference_video_entity.py:1096-1132,
    calculate_mask_quality_scores, utils/comm.py:86-89): pred_logits
    [Q, K] raw, pred_masks [Q, Tc, h4, w4] raw logits; each frame's
    logits upsampled bilinearly to ``padded_hw`` and cropped to
    ``image_hw``; quality = count(> 1) / count(> -1) per query over the
    clip; evidence = sum_q sigmoid(logit) * quality * sigmoid(mask);
    argmax.  One frame at a time (the JAX package's scan / map).
    Returns [Tc, ih, iw] int32."""
    ih, iw = image_hw
    logits = torch.sigmoid(pred_logits.to(torch.float32))  # [Q, K]
    masks_t = pred_masks.to(torch.float32).transpose(0, 1)  # [Tc, Q, h4, w4]
    Q = logits.shape[0]

    def up_frame(mt):  # [Q, h4, w4] -> [Q, ih, iw] logits
        u = F.interpolate(mt[None], size=tuple(padded_hw), mode="bilinear", align_corners=False)
        return u[0, :, :ih, :iw]

    pos = torch.zeros((Q,), dtype=torch.int64, device=logits.device)
    tot = torch.zeros_like(pos)
    for mt in masks_t:
        u = up_frame(mt)
        pos += (u > 1).sum(dim=(1, 2))
        tot += (u > -1).sum(dim=(1, 2))
    quality = pos.to(torch.float32) / tot.clamp(min=1).to(torch.float32)
    wlogits = logits * quality[:, None]  # [Q, K]
    labels = []
    for mt in masks_t:
        u = torch.sigmoid(up_frame(mt))
        sem = torch.einsum("qc,qhw->chw", wlogits, u)
        labels.append(torch.argmax(sem, dim=0).to(torch.int32))
    return torch.stack(labels)


def _resize_labels_nearest(labels: np.ndarray, out_size) -> np.ndarray:
    """[T, h, w] int labels -> [T, out] nearest resize (save_results_vss's
    final ``F.interpolate(..., mode='nearest')``)."""
    m = torch.from_numpy(labels.astype(np.float32))[None]
    m = F.interpolate(m, size=tuple(out_size), mode="nearest")
    return m[0].numpy().astype(np.int32)


def _upsample_logits(mask_logits: np.ndarray, image_size, out_size, padded_size) -> np.ndarray:
    """``_upsample_logits_device`` on a host array (save_results_vps)."""
    return _upsample_logits_device(torch.from_numpy(mask_logits), image_size, out_size,
                                   padded_size).numpy()


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
