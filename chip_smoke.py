"""Drive the PyTorch/CUDA port (``univs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It takes no arguments and runs every phase, in order (any failure exits
non-zero):
  device  — torch.cuda present; the card's name and power limit
            (``nvidia-smi --query-gpu=name,power.limit``);
  build   — nvcc builds every kernel from ``univs_tpu_torch/csrc`` for sm_90a;
  kernels — each kernel against its plain PyTorch version on the card, at
            the shapes the main path gives it (30 frames at 640x960,
            bf16 and float32) and at a tiny shape with D=8; times, bound
            and errors per kernel;
  path    — the main path: ``EntityDriver.run_vis`` for UniVS-R50 VIS at
            full width (default UniVSConfig, bf16, 640x960, T=5, stride 1,
            60 entity slots) on a seeded uint8 video of 30 frames with
            seeded random weights; launch counts per kernel must equal
            6 x (window encodes); a profile of one more run (device time
            by kernel; the idle share over the wall time of the unprofiled
            runs, and over the profiled run's own wall time, which the
            profiler lengthens); and the whole path against a reference
            on a small input: the tiny config's ``run_vis`` in float32 on
            the card (through the kernels) and on the CPU (plain laws).

Prints one JSON line per kernel check, the ``kernels`` summary line and
the card line, and last ``{"ok": true, "device": {...}}``.  Exits with a
non-zero code, printing no result, when no CUDA device is present or the
package cannot be imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# full-width encoder geometry (UniVS-R50 pixel decoder at 640x960)
FULL_SHAPES = ((20, 30), (40, 60), (80, 120))
FULL = dict(C=256, M=8, P=4, F=1024)
TINY_SHAPES = ((2, 3), (4, 6), (8, 12))
TINY = dict(C=32, M=4, P=2, F=64)
MAIN_PATH_FRAMES = 30

REPLACES = {
    "msda_rows": "univs_tpu/ops/msda_rows.py:39",
    "msda_sample": "univs_tpu/ops/deformable_attention.py:411 and :490",
    "fused_ffn_ln": "univs_tpu/ops/fused_mlp.py:27",
}
SOURCES = {
    "msda_rows": "univs_tpu_torch/csrc/msda_rows.cu",
    "msda_sample": "univs_tpu_torch/csrc/msda_sample.cu",
    "fused_ffn_ln": "univs_tpu_torch/csrc/fused_ffn_ln.cu",
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# kernel inputs at a given geometry (seeded, on the card)
# ---------------------------------------------------------------------------


def make_inputs(shapes, geo, n_frames, dtype, seed):
    import torch

    from univs_tpu_torch.utils.weights import msda_offset_bias

    g = torch.Generator(device="cpu").manual_seed(seed)
    C, M, P, F = geo["C"], geo["M"], geo["P"], geo["F"]
    L = len(shapes)
    Lq = sum(h * w for h, w in shapes)
    D = C // M

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda()

    q = rn(n_frames, Lq, C).to(dtype)
    wo = rn(C, M * L * P * 2, scale=0.05).to(dtype)
    bo = torch.as_tensor(msda_offset_bias(M, L, P)).cuda() + rn(M * L * P * 2, scale=0.1)
    wa = rn(C, M * L * P, scale=0.05).to(dtype)
    ba = rn(M * L * P, scale=0.1)
    value = rn(n_frames, Lq, M, D).to(dtype)
    src = rn(n_frames, Lq, C).to(dtype)
    attn = rn(n_frames, Lq, C).to(dtype)
    ffn = dict(
        g1=1.0 + rn(C, scale=0.1), c1=rn(C, scale=0.1),
        # Dense kernels [in, out] as the model passes them: views of
        # nn.Linear's [out, in] weights
        w1=rn(F, C, scale=C ** -0.5).to(dtype).t(), b1=rn(F, scale=0.1),
        w2=rn(C, F, scale=F ** -0.5).to(dtype).t(), b2=rn(C, scale=0.1),
        g2=1.0 + rn(C, scale=0.1), c2=rn(C, scale=0.1),
    )
    return dict(q=q, wo=wo, bo=bo, wa=wa, ba=ba, value=value, src=src, attn=attn,
                ffn=ffn, M=M, P=P, L=L, Lq=Lq, D=D, C=C, F=F)


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def kernel_checks(results: dict) -> bool:
    """Every kernel against its plain version; fills ``results`` with the
    main-path-shape (bf16) numbers.  Returns True when all agree."""
    import torch

    from univs_tpu_torch.ops import deformable_attention as da
    from univs_tpu_torch.ops import fused_mlp, msda_rows

    ok = True
    cases = [
        ("main", FULL_SHAPES, FULL, MAIN_PATH_FRAMES, torch.bfloat16),
        ("main", FULL_SHAPES, FULL, 2, torch.float32),
        ("tiny", TINY_SHAPES, TINY, 2, torch.float32),
        ("tiny", TINY_SHAPES, TINY, 2, torch.bfloat16),
    ]
    for case, shapes, geo, n, dtype in cases:
        x = make_inputs(shapes, geo, n, dtype, seed=1234)
        M, P, L = x["M"], x["P"], x["L"]
        is_bf16 = dtype == torch.bfloat16
        timed = case == "main" and is_bf16
        ff = x["ffn"]
        ffn_args = (ff["g1"], ff["c1"], ff["w1"], ff["b1"], ff["w2"], ff["b2"], ff["g2"], ff["c2"])

        # tolerances, relative to the reference's largest magnitude:
        #  - rows: float32 results of products of identical inputs, only
        #    the summation order differs -> 1e-4 in both dtypes, the x / y
        #    lanes (pixel coordinates) and the weight lanes each against
        #    their own magnitude;
        #  - sample: float32 accumulation of identical products; the bf16
        #    output rounds once -> 1e-4 (f32), 1e-2 (bf16: ~2 ulp);
        #  - ffn: the bf16 hidden activation and output round once each
        #    -> 1e-4 (f32), 2e-2 (bf16: ~4 ulp of the largest output).
        tol = {"msda_rows": 1e-4, "msda_sample": 1e-2 if is_bf16 else 1e-4,
               "fused_ffn_ln": 2e-2 if is_bf16 else 1e-4}
        calls = {
            "msda_rows": (
                lambda: msda_rows.msda_rows_cuda(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], shapes, M, P),
                lambda: msda_rows.msda_rows_plain(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], shapes, M, P),
            ),
        }
        loc = msda_rows.msda_rows_plain(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], shapes, M, P)
        calls["msda_sample"] = (
            lambda: da.msda_sample_cuda(x["value"], shapes, loc),
            lambda: da.msda_sample_plain(x["value"], shapes, loc),
        )
        calls["fused_ffn_ln"] = (
            lambda: fused_mlp.fused_ffn_ln_cuda(x["src"], x["attn"], *ffn_args),
            lambda: fused_mlp.fused_ffn_ln_plain(x["src"], x["attn"], *ffn_args),
        )
        for name, (kern, plain) in calls.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            # loc [..., 3] holds (x, y, w): coordinates and weights apart
            parts = ((got[..., :2], want[..., :2]), (got[..., 2], want[..., 2])) \
                if name == "msda_rows" else ((got, want),)
            errs = [float((g.float() - w.float()).abs().max()) for g, w in parts]
            scales = [float(w.float().abs().max()) for _, w in parts]
            finite = bool(torch.isfinite(got.float()).all())
            passed = finite and all(e <= tol[name] * max(s, 1e-6) for e, s in zip(errs, scales))
            ok &= passed
            err = max(errs)
            rec = {"check": name, "case": case, "dtype": str(dtype).replace("torch.", ""),
                   "frames": n, "max_abs_err": err, "ref_max_abs": max(scales),
                   "tol_rel": tol[name], "pass": passed}
            if name == "msda_rows":
                rec.update(xy_max_abs_err=errs[0], xy_ref_max_abs=scales[0],
                           w_max_abs_err=errs[1], w_ref_max_abs=scales[1])
            if timed:
                rec["kernel_ms"] = time_cuda(kern, iters=10)
                rec["plain_ms"] = time_cuda(plain, iters=3, warmup=1)
                results[name] = dict(rec, **bound_of(name, x, shapes, loc, got))
            emit(rec)
            del got, want
        del x, loc
        torch.cuda.empty_cache()
    return ok


def bound_of(name, x, shapes, loc, out):
    """Least time the card could take for the same work: max(bytes /
    HBM rate, operations / peak rate of their type), each input read once
    and each output written once."""
    N, Lq, C, M, P, L, D, F = (x["q"].shape[0], x["Lq"], x["C"], x["M"], x["P"], x["L"],
                               x["D"], x["F"])
    if name == "msda_rows":
        byts = nbytes(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], out)
        ops = 2.0 * N * Lq * C * (3 * M * L * P)
        rate = BF16_TENSOR_FLOPS
    elif name == "msda_sample":
        byts = nbytes(x["value"], loc, out)
        ops = 2.0 * N * Lq * M * L * P * 4 * D  # 4 corner FMAs per channel
        rate = F32_FLOPS
    else:
        ff = x["ffn"]
        byts = nbytes(x["src"], x["attn"], out, *ff.values())
        ops = 4.0 * N * Lq * C * F
        rate = BF16_TENSOR_FLOPS
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": byts, "ops": ops}


def check_results(results, V, H, W, capacity, K) -> bool:
    """The driver's output is well formed: at most ``capacity`` entities,
    each with V RLEs that decode to [H, W] and finite class scores [K]."""
    from univs_tpu_torch.utils import rle

    ok = len(results) <= capacity
    for r in results:
        segs = r["segmentations"]
        ok &= len(segs) == V
        ok &= all(tuple(rle.decode(s).shape) == (H, W) for s in segs)
        score = np.asarray(r["score"])
        ok &= score.shape == (K,) and bool(np.isfinite(score).all())
        ok &= bool(np.isfinite(r["mask_quality_score"]))
    return bool(ok)


def profile_run(driver, video, cls_emb, unprofiled_s):
    """One extra ``run_vis`` under torch.profiler: device time by kernel
    (top 12) and the device's idle share.  The profiler lengthens the
    host's side of the run, so the idle share is taken over the wall time
    of each unprofiled run of the same call (``unprofiled_s``); the share
    over the profiled run's own wall time is printed beside it.  Returns
    None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        driver.run_vis(video, cls_emb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kern:
        return None
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    idle = [max(0.0, 1.0 - busy_ms / (s * 1e3)) for s in unprofiled_s]
    return {"profile": "run_vis", "device_busy_ms": busy_ms,
            "unprofiled_wall_ms": [s * 1e3 for s in unprofiled_s],
            "device_idle_share": idle,
            "profiled_wall_ms": wall_ms,
            "device_idle_share_profiled_wall": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels_ms": [[n[:80], t] for n, t in top]}


def reference_check() -> bool:
    """The whole path against a reference on a small input: the tiny
    config's ``run_vis`` in float32 on the card (through the kernels,
    head width D=8) and on the CPU (plain laws), from the same seeded
    weights and video.  The same entities must come out, each frame's
    mask with IoU >= 0.99 and class scores within 1e-3: float32 results
    that differ only in summation order (cuDNN vs CPU convolutions, the
    kernels vs the plain laws) may flip a pixel whose logit is ~0."""
    import dataclasses

    import torch

    from univs_tpu_torch.config import tiny_test_config
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.ops import kernels
    from univs_tpu_torch.utils import rle

    cfg = tiny_test_config()
    cfg = dataclasses.replace(
        cfg, inference=dataclasses.replace(
            cfg.inference, num_frames=2, clip_stride=1, num_frames_window=6,
            apply_cls_thres=0.0, consistency_thres=(-1.0, 0.5), topk_per_video=4),
        prompt=dataclasses.replace(cfg.prompt, num_prev_frames_memory=3))
    V, H, W, K = 8, 64, 96, 5
    rng = np.random.RandomState(7)
    video = rng.randint(0, 256, (V, H, W, 3)).astype(np.uint8)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    before = kernels.launch_counts()
    got = EntityDriver(cfg, None, num_classes=K, capacity=6, device="cuda", seed=3).run_vis(video, cls_emb)
    torch.cuda.synchronize()
    launched = all(kernels.LAUNCHES[k] > before[k] for k in kernels.KERNELS)
    want = EntityDriver(cfg, None, num_classes=K, capacity=6, device="cpu", seed=3).run_vis(video, cls_emb)
    ok = launched and len(want) >= 1 and [r["obj_id"] for r in got] == [r["obj_id"] for r in want]
    min_iou, max_score_err = 1.0, 0.0
    if ok:
        for g, w in zip(got, want):
            for sg, sw in zip(g["segmentations"], w["segmentations"]):
                a, b = rle.decode(sg).astype(bool), rle.decode(sw).astype(bool)
                union = (a | b).sum()
                min_iou = min(min_iou, float((a & b).sum() / union) if union else 1.0)
            max_score_err = max(max_score_err, float(np.abs(np.asarray(g["score"]) -
                                                            np.asarray(w["score"])).max()))
        ok = min_iou >= 0.99 and max_score_err <= 1e-3
    emit({"check": "run_vis_tiny_cuda_vs_cpu", "entities_cuda": len(got),
          "entities_cpu": len(want), "kernels_launched": launched, "min_mask_iou": min_iou,
          "max_score_abs_err": max_score_err, "pass": bool(ok)})
    return bool(ok)


def run_main_path():
    """``EntityDriver.run_vis`` for UniVS-R50 VIS at full width on the card.
    Returns (ok, launches of each kernel in the first timed run)."""
    import dataclasses

    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.inference import memory_pool as mp
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.inference.entity import entity_clip_step
    from univs_tpu_torch.ops import kernels

    cfg = UniVSConfig(dtype="bfloat16")
    V, H, W, K = MAIN_PATH_FRAMES, 640, 960, 40
    E = cfg.inference.max_num_instances
    rng = np.random.RandomState(0)
    video = (rng.rand(V, H, W, 3) * 255).astype(np.uint8)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    driver = EntityDriver(cfg, None, num_classes=K, capacity=E, seed=0)
    n_enc = driver.num_window_encodes(V)
    n_clips = sum(1 for _ in driver._iter_clips(V))

    t0 = time.perf_counter()
    driver.run_vis(video, cls_emb)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = driver.run_vis(video, cls_emb)
    torch.cuda.synchronize()
    run_s = [time.perf_counter() - t0]
    launches = kernels.launch_counts()

    expected = cfg.pixel_decoder.num_layers * n_enc
    counts_ok = all(launches[k] == expected for k in kernels.KERNELS)
    out_ok = check_results(results, V, H, W, E, K)
    for _ in range(2):  # the spread of the host-clock reading
        t0 = time.perf_counter()
        driver.run_vis(video, cls_emb)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)

    # the first 10 frames with the class and consistency gates open, so
    # that entities are admitted and the drain (upsample, threshold,
    # bit-pack on the card) and the host RLE run at full resolution; same
    # model, one run (the host's numpy RLE grows with the runs in each
    # mask, so the frame count bounds this phase)
    relaxed = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, apply_cls_thres=0.0, consistency_thres=(-1.0, 0.5)))
    open_driver = EntityDriver(relaxed, driver.model, num_classes=K, capacity=E)
    Vo = 10
    t0 = time.perf_counter()
    handle = open_driver.start_vis(video[:Vo], cls_emb)
    open_driver._queue_drain(handle)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    open_results = open_driver.finish_vis(handle)
    t2 = time.perf_counter()
    out_ok &= len(open_results) > 0 and check_results(open_results, Vo, H, W, E, K)
    gates_open = {"frames": Vo, "entities": len(open_results), "device_s": t1 - t0,
                  "host_assembly_s": t2 - t1,
                  "rle_ms_per_mask": (t2 - t1) * 1e3 / max(1, Vo * len(open_results))}

    # stage times outside the counted run
    frames_d = torch.as_tensor(video).cuda()
    window = frames_d[:driver.window]
    encode_ms = time_cuda(lambda: driver.encode_window(window), iters=3, warmup=1)
    mf, ms = driver.encode_window(window)
    T = driver.T
    feats = (mf[:T], tuple(m[:T] for m in ms))
    pool = mp.create_entity_memory(E, K, cfg.decoder.hidden_dim, (H // 4, W // 4),
                                   window=driver.out_window + T,
                                   num_prompt_points=driver.cc.num_dense_points,
                                   embd_history=8, prompt_history=T + driver.stride, device="cuda")
    cls_d = cls_emb.cuda()
    with torch.no_grad():
        entity_clip_step(driver._modules, feats, pool, list(range(T)), 0, True, cls_d, driver.cc)
        clip_ms = time_cuda(lambda: entity_clip_step(driver._modules, feats, pool,
                                                     list(range(1, T + 1)), 1, False, cls_d,
                                                     driver.cc), iters=10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    emit({"path": "EntityDriver.run_vis", "config": "UniVS-R50 VIS, bf16",
          "frames": V, "height": H, "width": W, "T": T, "stride": driver.stride,
          "window": driver.window, "capacity": E, "classes": K,
          "window_encodes": n_enc, "clips": n_clips, "warmup_s": warm_s, "run_s": run_s,
          "fps": V / run_s[0], "fps_runs": [V / t for t in run_s],
          "encode_ms_per_frame": encode_ms / driver.window,
          "clip_step_ms": clip_ms, "entities": len(results),
          "gates_open": gates_open,
          "peak_mem_gb": peak_gb,
          "launches": launches, "launches_expected": expected,
          "launches_ok": counts_ok, "outputs_ok": out_ok})
    prof = profile_run(driver, video, cls_emb, run_s)
    emit(prof if prof is not None else {"profile": "run_vis", "device_time": "not measured"})
    return counts_ok and out_ok, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this script measures the port on a GPU only")
        return 2
    try:
        import univs_tpu_torch  # noqa: F401
        from univs_tpu_torch.ops import kernels
    except ImportError as e:
        log(f"univs_tpu_torch is not importable from here: {e}")
        return 3

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({card}), torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = kernels.build()
    for n, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {n}: {line.strip()}")
    log(f"build: {len(logs)} kernel(s) in {time.perf_counter() - t0:.1f} s")

    results: dict = {}
    ok = kernel_checks(results)
    path_ok, launches = run_main_path()
    ok &= path_ok
    ok &= reference_check()

    rows = []
    for name in kernels.KERNELS:
        r = results[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    if not ok:
        log("FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
