"""The comparison that decides ``correct``: the program's outputs from
the window against the plain reference on the same inputs and weights.

Each kind of traffic gathers two sides of the same structure, the
program's (kept from the timed path) and another's (the reference, or
the reference in fp8 as the control), and ``numbers`` reduces a pair to
the compared numbers, each held to its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.harness.loops import FirstProca
from benchmark.reference import rle
from benchmark.reference.inference import memory_pool as mp
from benchmark.reference.structures import VisualPrompts
from benchmark.reference.univs import iter_clips, vss_clip


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.to(torch.float32), b.to(device=a.device, dtype=torch.float32)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def row_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The median over rows (queries) of each row's ||a - b|| / ||b||."""
    a = a.to(torch.float32).reshape(a.shape[0], -1)
    b = b.to(device=a.device, dtype=torch.float32).reshape(b.shape[0], -1)
    e = torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1).clamp(min=1e-30)
    return float(e.median())


def _f32(x):
    return x.to(torch.float32) if torch.is_tensor(x) and x.is_floating_point() else x


# ---------------------------------------------------------------------------
# VIS
# ---------------------------------------------------------------------------


@torch.no_grad()
def vis_decoder_side(model, videos: Dict[int, np.ndarray], cls_emb: torch.Tensor,
                     dec_inputs: Dict[tuple, dict], device) -> Dict[tuple, dict]:
    """A model's decoder outputs (the reference's, or a control's) at the
    kept clips of the kept videos, each on the program's visual prompts of
    that clip (the pool is the program's state; the model encodes the
    frames itself), with its first prompt cross-attention's prompt rows
    (``proca0``)."""
    inf = model.cfg.inference
    T, stride, window = inf.num_frames, inf.clip_stride, inf.num_frames_window
    dec = {}
    first = FirstProca(model.decoder)
    for v, frames_np in videos.items():
        frames = torch.as_tensor(frames_np, device=device)
        feats, start = None, 0
        for c, clip in enumerate(iter_clips(frames.shape[0], T, stride, window)):
            if clip["new_window"] is not None:  # encoded when a kept clip needs it
                feats, start = None, clip["new_window"]
            if (v, c) not in dec_inputs:
                continue
            if feats is None:
                idx = torch.as_tensor(np.minimum(np.arange(start, start + window),
                                                 frames.shape[0] - 1), device=device)
                feats = model.encode(frames[idx])
            rel = torch.as_tensor(clip["rel"], device=device)
            vp = VisualPrompts(**{k: _f32(x) for k, x in dec_inputs[(v, c)]["visual_prompts"].items()})
            fi = torch.as_tensor(clip["clip_idx"], device=device)[None]
            out = model.decoder(tuple(m[rel] for m in feats[1]), feats[0][rel], fi, task="sot",
                                visual_prompts=vp, cls_emb=cls_emb)
            dec[(v, c)] = {k: out[k][0] for k in ("pred_logits", "pred_masks", "pred_embds")}
            dec[(v, c)]["proca0"] = first.rows
    first.remove()
    return dec


def empty_pool_read(kept: dict, capacity: int, K: int, C: int, hw, T: int, R: int, stride: int,
                    num_prev: int, device) -> int:
    """Elements of the program's first-clip visual prompts that differ
    from what an empty pool reads (the start of the clip loop)."""
    pool = mp.create_entity_memory(capacity, K, C, hw, window=1, num_prompt_points=R,
                                   prompt_history=T + stride, device=device)
    kv, kv_pe, kv_valid = mp.read_prompt_kv(pool, num_prev)
    q, qp = mp.read_clip_queries(pool, T)
    want = {"queries": q[None], "query_pos": qp[None], "kv": kv[None, :, :, None],
            "kv_pe": kv_pe[None, :, :, None], "kv_valid": kv_valid[None, :, :, None],
            "valid": pool.valid[None]}
    got = kept["visual_prompts"]
    return int(sum((got[k].to(device) != want[k]).sum() for k in want))


def decoder_numbers(prog: Dict, other: Dict, expected, names) -> Dict[str, float]:
    """The worst kept clip's relative L2 error (``*_err``) and median
    per-query error (``*_med``) of each output; infinite where a kept clip
    has no decoder output on the program's side (it never came)."""
    out = {}
    for name, k in names:
        out[f"{name}_err"] = out[f"{name}_med"] = 0.0 if set(expected) <= set(prog) else math.inf
    for key in expected:
        p, o = prog.get(key), other.get(key)
        if p is None or o is None:
            continue
        for name, k in names:
            out[f"{name}_err"] = max(out[f"{name}_err"], rel_err(p[k], o[k]))
            out[f"{name}_med"] = max(out[f"{name}_med"], row_err(p[k], o[k]))
    return out


def ratios(side: Dict, ref: Dict, low: Dict, expected, names, rows: slice = slice(None),
           prefix: str = "") -> Dict[str, float]:
    """Each output's median per-query error against the float32 reference
    over that of the reference computed in the configuration's compute
    dtype, the worst kept clip (``<prefix><name>_ratio``), over the query
    rows ``rows`` (all by default): the program's distance from float32 in
    units of its own precision's, which cancels how far a seed's weights
    amplify rounding (the masked attention's allow bits flip more on
    some); infinite where a kept clip never came."""
    out = {}
    for name, k in names:
        worst = 0.0
        for key in expected:
            if key not in side:
                worst = math.inf
                continue
            floor = max(row_err(low[key][k][rows], ref[key][k][rows]), 1e-6)
            worst = max(worst, row_err(side[key][k][rows], ref[key][k][rows]) / floor)
        out[f"{prefix}{name}_ratio"] = worst
    return out


class _Recorded:
    """The program's decoder outputs of one kept call, served in the
    decoder's place; the prompt grid comes from the reference's decoder."""

    def __init__(self, decoder, outputs: Dict[str, torch.Tensor]):
        self.prompt_feature_grid = decoder.prompt_feature_grid
        self.outputs = outputs

    def __call__(self, *args, **kwargs):
        return {k: v[None] for k, v in self.outputs.items()}


@torch.no_grad()
def clip_step_diff(ref, steps: Dict[tuple, dict], dec: Dict[tuple, dict], expected,
                   cls_emb: torch.Tensor) -> float:
    """The clip step by itself at the kept clips: the frozen step run on
    the program's pool before the step, its features and its decoder's
    outputs, against the program's pool after it; the count of elements
    (and ints) that differ.  Same code on the same inputs: 0 when sound."""
    from benchmark.reference.inference.entity import EntityClipConfig, entity_clip_step

    if not set(expected) <= set(steps) or not set(expected) <= set(dec):
        return math.inf
    diff = 0
    for key in expected:
        rec = steps[key]
        pool = mp.EntityMemory(**{k: v.clone() if torch.is_tensor(v) else v
                                  for k, v in rec["before"].items()})
        outs = {k: dec[key][k] for k in ("pred_logits", "pred_masks", "pred_embds")}
        entity_clip_step((None, _Recorded(ref.decoder, outs)), rec["encoded"], pool, *rec["args"],
                         cls_emb, EntityClipConfig(**rec["cc"]))
        for name, want in rec["after"].items():
            got = getattr(pool, name)
            diff += int((got != want).sum()) if torch.is_tensor(want) else int(got != want)
    return float(diff)


def drain_diff(drains: Dict[int, dict], outputs: Dict[int, list], size) -> float:
    """The drain and its RLEs by themselves, for the kept videos: from the
    windows the drain got (the program's fp16 window logits, its final
    ``valid``), the reference's law (bilinear to the frame size, threshold
    at 0) gives each valid slot's masks over the video; counted are the
    slots valid on one side only (the program's results against the
    pool's ``valid``) and the pixels where the program's decoded RLEs
    differ.  The same law on the same inputs: 0 when sound."""
    from benchmark.reference.univs import _upsample_threshold

    if set(drains) != set(outputs):
        return math.inf
    diff = 0
    for v, d in drains.items():
        want = set(np.flatnonzero(d["valid"].cpu().numpy()).tolist())
        got = {int(r["obj_id"]): r for r in outputs[v]}
        diff += len(want ^ set(got))
        for e in want & set(got):
            m = np.zeros((d["V"], *size), bool)
            for win, start in zip(d["emitted"], d["starts"]):
                up = _upsample_threshold(win[e][None], size, size, size)[0].cpu().numpy()
                n = min(up.shape[0], d["V"] - start)
                m[start:start + n] = up[:n]
            segs = got[e]["segmentations"]
            if len(segs) != d["V"]:
                diff += m.size
                continue
            served = np.stack([rle.decode_numpy(s).astype(bool) for s in segs])
            diff += int((served != m).sum()) if served.shape == m.shape else m.size
    return float(diff)


# ---------------------------------------------------------------------------
# VSS
# ---------------------------------------------------------------------------


@torch.no_grad()
def vss_other_side(model, videos: Dict[int, np.ndarray], clips: Dict[int, list],
                   cls_emb: torch.Tensor, device) -> Dict:
    """A model's side for the kept clips of the kept videos: the decoder's
    outputs and the class evidence of each frame (labels = its argmax)."""
    T = model.cfg.inference.num_frames
    out = {}
    for v, frames_np in videos.items():
        V = frames_np.shape[0]
        for c in clips[v]:
            idx = np.minimum(np.arange(c * T, c * T + T), V - 1)[: min(T, V - c * T)]
            frames = torch.as_tensor(frames_np[idx], device=device)
            got = vss_clip(model, frames, idx, cls_emb)
            out[(v, c)] = {"pred_logits": got["pred_logits"], "pred_masks": got["pred_masks"],
                           "evidence": got["evidence"],
                           "labels": got["evidence"].argmax(1).to(torch.int32)}
    return out


def vss_as_program(side: Dict, shapes: Dict[int, tuple], T: int) -> Dict:
    """A model's VSS side in the program's form: its decoder outputs by
    clip and its labels placed in per-video maps [V, H, W]."""
    labels = {v: np.zeros(shape, np.int32) for v, shape in shapes.items()}
    for (v, c), o in side.items():
        lab = o["labels"].cpu().numpy()
        labels[v][c * T: c * T + lab.shape[0]] = lab
    return {"dec": side, "labels": labels}


def vss_numbers(prog: Dict, other: Dict, T: int) -> Dict[str, float]:
    """The decoder's outputs at the kept clips (relative L2 error of the
    class and mask logits) and the labels: the widest gap, over the kept
    clips' pixels, by which the evidence of the side's label lies below
    the other side's best, as a share of that best."""
    out = decoder_numbers(prog["dec"], other, list(other), (
        ("logit", "pred_logits"), ("mask", "pred_masks")))
    out["label_gap"] = 0.0
    for (v, c), o in other.items():
        ev = o["evidence"]  # [Tc, K, H, W]
        labels = prog["labels"][v][c * T: c * T + ev.shape[0]]
        lab = torch.as_tensor(np.asarray(labels), device=ev.device).to(torch.int64)
        best = ev.amax(1)
        at = torch.gather(ev, 1, lab[:, None]).squeeze(1)
        gap = ((best - at) / best.clamp(min=1e-30)).amax()
        out["label_gap"] = max(out["label_gap"], float(gap))
    return out
