"""Seeded inputs: videos and class embeddings, made on the device from
``--seed`` in a few large draws and handed to the program as a user
hands them (uint8 frames in host memory, a float32 class bank)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a run: the seed
    and a salt per stream, mixed so that nearby seeds do not share draws."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def noise_videos(seed: int, salt: int, n: int, V: int, H: int, W: int, device) -> List[np.ndarray]:
    """``n`` distinct uint8 noise videos [V, H, W, 3] in host memory."""
    g = generator(seed, salt, device)
    out = []
    for _ in range(n):
        v = torch.randint(0, 256, (V, H, W, 3), generator=g, device=device, dtype=torch.uint8)
        out.append(v.cpu().numpy())
    return out


def class_bank(seed: int, K: int, dim: int, device) -> torch.Tensor:
    """[K, dim] float32 class embeddings, N(0, 1) rows (the decoder
    compares directions only)."""
    g = generator(seed, 1, device)
    return torch.randn((K, dim), generator=g, device=device)


def draw_indices(seed: int, salt: int, k: int, low: int, high: int, always=()) -> List[int]:
    """``k`` distinct integers in [low, high) drawn from the seed, with
    ``always`` among them, sorted."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), salt])
    pool = [i for i in range(low, high) if i not in always]
    take = max(0, min(k - len(always), len(pool)))
    picked = list(always) + [int(x) for x in rng.choice(pool, size=take, replace=False)]
    return sorted(picked)


def blob_clips(seed: int, salt: int, n: int, T: int, H: int, W: int, blobs: int,
               device) -> torch.Tensor:
    """``n`` uint8 clips [n, T, H, W, 3] of persistent moving Gaussian
    blobs (the law of the program's ``synth_blob_video``, drawn here on
    the device): objects that persist over frames rather than noise."""
    g = generator(seed, salt, device)
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    out = torch.empty((n, T, H, W, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        u = torch.rand((7, blobs), generator=g, device=device)
        cy0, cx0 = u[0] * H, u[1] * W
        vy, vx = (u[2] - 0.5) * 12, (u[3] - 0.5) * 12
        sig = 20 + u[4] * 40
        col = torch.rand((blobs, 3), generator=g, device=device) * 220 + 35
        for t in range(T):
            cy, cx = (cy0 + vy * t) % H, (cx0 + vx * t) % W
            acc = torch.zeros((H, W, 3), device=device)
            for b in range(blobs):
                e = torch.exp(-(((yy - cy[b]) / sig[b]) ** 2 + ((xx - cx[b]) / sig[b]) ** 2))
                acc += e[..., None] * col[b]
            out[i, t] = acc.clamp(0, 255).to(torch.uint8)
    return out


def train_batches(seed: int, traffic: dict, classes: int, emb_dim: int, device) -> tuple:
    """``traffic["batches"]`` distinct detection batches of the stage-2
    shape and the category bank, as dicts of host tensors: B clips of T
    blob frames, N instance slots of which ``objects`` hold seeded
    ellipses (centres in the middle 70 %, radii 1/32 to 5/32 of the mask
    map, 8 to 40 pixels at 1024) moving up to 4 pixels a frame (masks at
    1/4), labels drawn from
    the bank; the prompt slots take the targets' category embeddings, then
    negative categories drawn from the seed."""
    B, T, H, W = traffic["clips"], traffic["frames"], traffic["height"], traffic["width"]
    N, n_obj = traffic["slots"], traffic["objects"]
    h4, w4 = H // 4, W // 4
    bank = torch.randn((classes, emb_dim), generator=generator(seed, 21, device),
                       device=device)
    rng = np.random.default_rng([int(seed) % (2 ** 63), 22])
    yy, xx = np.mgrid[0:h4, 0:w4]
    out = []
    for k in range(traffic["batches"]):
        images = blob_clips(seed, 100 + k, B, T, H, W, traffic["blobs"], device).cpu()
        masks = np.zeros((B, N, T, h4, w4), np.float32)
        valid = np.zeros((B, N), bool)
        valid[:, :n_obj] = True
        labels = np.where(valid, rng.integers(1, classes + 1, (B, N)), 0).astype(np.int32)
        for b in range(B):
            for n in range(n_obj):
                cy, cx = rng.uniform(0.15 * h4, 0.85 * h4), rng.uniform(0.15 * w4, 0.85 * w4)
                ry, rx = rng.uniform(h4 / 32, 5 * h4 / 32), rng.uniform(w4 / 32, 5 * w4 / 32)
                vy, vx = rng.uniform(-4, 4, 2)
                for t in range(T):
                    masks[b, n, t] = (((yy - cy - vy * t) / ry) ** 2
                                      + ((xx - cx - vx * t) / rx) ** 2) <= 1
        ids = np.where(valid[:, :, None], np.arange(N)[None, :, None], -1).repeat(T, 2)
        prompt_ids = np.full((B, N), -1, np.int32)
        prompt_cls = np.zeros((B, N), np.int64)
        for b in range(B):
            pos = np.flatnonzero(valid[b])[:N]
            prompt_ids[b, :len(pos)] = pos
            prompt_cls[b, :len(pos)] = labels[b, pos] - 1
            prompt_cls[b, len(pos):] = rng.permutation(classes)[: N - len(pos)]
        t = torch.as_tensor
        out.append({
            "images": images, "frame_indices": t(np.tile(np.arange(T, dtype=np.int32), (B, 1))),
            "labels": t(labels), "ids": t(ids.astype(np.int32)), "masks": t(masks),
            "valid": t(valid), "prompt_obj_ids": t(prompt_ids),
            "prompt_category_embs": bank.cpu()[t(prompt_cls)],
            "prompt_category_valid": torch.ones((B, N), dtype=torch.bool),
            "category_bank": bank.cpu(),
            "category_bank_valid": torch.ones((classes,), dtype=torch.bool)})
    return out
