"""Drive the PyTorch/CUDA port (``univs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, on one card
    python3 chip_smoke.py pipeline   # the pipelining phase alone (two cards)
    python3 chip_smoke.py eval       # the evaluation phase alone (one card)
    python3 chip_smoke.py entry      # weight intake and the entry points alone (one card)
    python3 chip_smoke.py ddp        # data parallelism over NCCL alone (two cards)
    python3 chip_smoke.py tools      # run_net --train under torchrun and the tools alone

With no arguments it runs every phase, in order (any failure exits
non-zero):
  device  — torch.cuda present; the card's name and power limit
            (``nvidia-smi --query-gpu=name,power.limit``);
  build   — nvcc builds every kernel from ``univs_tpu_torch/csrc`` for sm_90a;
  kernels — each kernel against its plain PyTorch version on the card, at
            the shapes the main path gives it (30 frames at 640x960,
            bf16 and float32) and at a tiny shape with D=8; times, bound
            and errors per kernel (B beside ``F.linear`` of its product
            alone; C beside the unfused bf16 sequence and its two
            ``F.linear`` products, with the body it ran, which must be the
            wgmma body at the main path's shape); at each of these, A also
            on samples on and past every border of every level, B at a query
            count that is not a multiple of its query tile, and C below one
            token tile, straddling tiles and frames, on inputs with a large
            common offset and on constant rows; kernel D in both its modes
            (int8 slab, value dtype), also on the border samples, on a
            query count that leaves a partial warp of lane groups and on
            weights of up to 300 (the int8 mode's wide-tap path), and the
            whole ``ms_deform_attn`` op with ``impl='tent-int8'``
            (quantisation included) beside ``impl='tent'`` (kernel A), each
            against the float32 law;
            kernels E (the point-summed tent plane: psum / outer, whole
            level / y-window) and F (the separable tent probe laws: kernel,
            base, b16t1, b16all, exp, exp-b16) at the probes' geometry (the
            1/8 level, 5 frames, 8 heads, 4 points, D=32; bf16 timed, and
            float32, timed for E) and at a tiny shape, E also on coincident
            taps, footprints across chunk borders, 300 of 320 queries and
            windows of 64 queries that hit and miss at D = 16, 24, 32 and
            64 (its records name the body the wrapper ran and the plane
            bound over the RQ rows), F also at every law in both slab
            layouts on a head and row count whose lane groups straddle the
            last warp; F and D bit-exact, their timed records with the
            sector traffic of their gathers;
  paths   — each path driven with the launch counts set to 0 just before
            and read just after, every kernel's count equal to the path's
            expectation:
            * the tools probes: the runners of the five ported probes of
              ``tools/`` (``univs_tpu_torch.tools.probe_tent_*.run``) at
              their own geometry, kernels E and F beside kernel A on the
              same inputs, each formulation's error against the float32
              law within its tolerance; E's records beside its function
              bound and plane bound at each level;
            * the MSDA op's tent entry points at the encoder's shape
              (``impl='tent-int8'`` and ``level_impl='base'`` -> kernel D,
              ``impl='tent'`` -> kernel A);
            * ``EntityDriver.run_vis`` for UniVS-R50 VIS at full width
              (default UniVSConfig, bf16, 640x960, T=5, stride 1, 60 entity
              slots, K=40) on a seeded uint8 video of 30 frames with seeded
              random weights, A/B/C at 6 x (window encodes), the encode
              split into backbone and pixel decoder, the host time of the
              counted run's parts (window encode, clip steps, JV walks,
              result assembly, RLE); the first 10
              frames again with the class and consistency gates open; a
              profile of one more run (device time by kernel; the idle share
              over the wall time of the unprofiled runs, and over the
              profiled run's own wall time, which the profiler lengthens);
            * ``run_vss`` (VSPW, K=124) at the same size, A/B/C at 6 x
              ceil(V / T) clip encodes;
            * ``run_vps`` (VIPSeg, K=124, its 58 thing classes, 60 slots),
              A/B/C at 6 x (window encodes), device and host-stitching time
              apart, and the first 10 frames with the gates open; the host
              stitching alone on seeded windows of 15 and 60 valid slots
              (the random weights admit at most one entity), its cost per
              entity and frame;
            * ``VOSDriver.run`` (VOS / PVOS) with the same model and a
              seeded video: N=5 seeded elliptical GT targets first appearing
              at frames 0, 0, 3, 11 and 20, 'prompt' timed (3 runs after a
              warm-up) with one clip step timed alone, 'learn' and
              'prompt+learn' once each, a PVOS-sized run of 24 targets; per
              run the launches (A/B/C at 6 x window encodes), the label maps
              and how many objects passed the first-appearance gate, the
              consistency gate and the learn-branch match (0 is possible
              with random weights, and shown);
            * ``VOSDriver.run_grounding`` (RefVOS): 4 expressions through
              ``TextPromptEncoder`` at the RN50x4 text geometry in float32
              (timed alone), padded to capacity 4; 3 timed runs after a
              warm-up with the peak device memory, and one run with the
              previous clip's visual prompts;
            * ``MSDeformAttnPixelDecoderVL`` at full width on the R50
              features of a 30-frame window and one expression's word
              features [1, 77, 640] from the seeded RN50x4 tower (padding
              invalid): ms per window, A/B/C 6 each, outputs finite and
              of the expected shapes;
            * the fast and image drivers with the VIS phase's model:
              ``FastVISDriver.run`` (K=40, after a warm-up),
              ``MDQEVISDriver.run`` (K=40, the first 15 frames: 15 clips
              of stride 1, one window rollover), ``FastVPSDriver.run_vps``
              (VIPSeg, K=124, 58 things), ``SemanticExtractionDriver.run``
              + ``semantic_features_to_masks`` and ``ImageDriver.run`` on
              one frame (COCO panoptic, K=133) + ``panoptic_inference``;
              A/B/C at 6 x clips (6 for the image);
            * ``BatchedVISServer.run_vis`` (serving) with the VIS phase's
              model: batch 2, capacity 40, K=40, two seeded videos of 30
              and 25 frames; videos/s, aggregate FPS beside the same batch
              with the backbone folded over both videos, peak memory;
              A/B/C at 6 x batched window encodes (the backbone once per
              video, the pixel decoder once over both videos' frames);
              with the gates open, RLEs identical to
              ``EntityDriver.run_vis`` for the longer video and for both
              videos of an equal-length batch, each with entities;
            * ``EntityDriver(pipeline_devices=...)`` on (cuda:0, cuda:1)
              when two cards are visible, else (cuda:0, cuda:0), over a
              45-frame video (two windows, the second encoded ahead): FPS
              of both, with the gates open RLEs identical to the
              unpipelined driver (``python3 chip_smoke.py pipeline`` runs
              this phase alone, for a machine with two cards);
            * a reading, not a gate: ``run_vis`` and ``run_vps`` on the
              first 10 frames with the gates open, the seeded R50 weights
              in float32 and in bf16 (kept entities, RLE IoU of the
              entities both keep, panoptic segments and pixel agreement);
            * the UniVS-R50 train step at full width (bf16 over float32
              masters, B=2 clips of T=2 frames of ``synth_blob_video`` on
              the 1024x1024 canvas, 40 instance slots, 12,544 points, the
              10 supervised layers, a seeded [3938, 640] category bank):
              detection (1 warm-up + 5 timed steps), sot and grounding
              (1 + 2 each); step ms split into forward, backward and
              optimizer, host JV s a step, peak memory, every logged loss
              finite, A/B/C at 6 a forward and 0 outside it; a profile
              of one detection step;
            * BoxVIS: the same detection step on box-region targets (each
              ellipse's bounding rectangle) with the EMA teacher and the
              pseudo-mask gate at 0 (1 warm-up + 2 timed steps): step ms
              split into teacher forward, student forward, backward,
              gradient upcast and optimizer, peak memory, the
              projection and pseudo losses finite, the targets through
              the gate, A/B/C at 12 a step (6 student, 6 teacher);
            * stage 3: ``long_video_loss`` on one 7-frame video in clips of
              3 (starts 0, 2, 4), 1 warm-up + 2 timed forward + backward
              passes: forward and backward ms, peak memory, every clip's
              losses and the inter-clip terms finite, A/B/C at 6 x 2
              encodes x 3 clips = 36 a pass;
            * data parallelism: the one-process detection step on the B=2
              batch, then two processes (``torch.multiprocessing.spawn``)
              on gloo over cuda:0, one video each, from the same masters
              and key: every rank's losses, the global gradient and the
              parameters after the step against the one-process step's,
              step and all-reduce ms, A/B/C 6 a rank (``python3
              chip_smoke.py ddp`` runs it alone on NCCL over cuda:0 and
              cuda:1, for a machine with two cards);
            * activation checkpointing: one detection step of UniVS Swin-L
              (window 12) without and with ``swin_use_checkpoint`` +
              ``remat_heads``, and of R50 without and with
              ``remat_heads``: peak memory and step ms of both, losses
              bit-identical, each label group's float32 master gradient
              within 1e-2, A/B/C 6 a forward and 0 outside it;
            * ``EntityDriver.run_vis`` for UniVS Swin-L (window 12, as
              Mask2Former's Swin-L configs) with the R50 headline's
              settings and video: 3 timed runs after a warm-up, peak
              memory, encode ms/frame split into backbone and pixel
              decoder, the host time of the counted run's parts, one clip
              step alone, a profile of one more run and of one window's
              backbone; and for PVTv2-b2 (linear SRA) one run; A/B/C at
              6 x window encodes, D/E/F 0;
            * the evaluation path (``python3 chip_smoke.py eval`` runs it
              alone): ``engine._eval_ytvis`` (30 frames, K=40, default
              gates and gates open), ``_eval_vss`` (K=124), ``_eval_vps``
              (K=124, 58 things, default gates and gates open),
              ``_eval_vos`` and ``_eval_vos(pvos=True)`` (N=5, a class in
              each VIPOSeg bucket), ``_eval_refvos`` (4 expressions,
              random prompts) on 10 frames and ``_eval_image`` (one
              frame, K=133) for UniVS-R50 at full width (bf16, 640x960,
              one seeded model shared by every driver), over seeded
              ``synth_blob_video`` frames and seeded moving ellipses
              stored as native RLEs, through an in-memory mapper (the
              card's machine has neither cv2 nor PIL); per task A/B/C at
              6 x the driver's encodes, every metric finite, the host
              seconds of the driver, the GT decode and the evaluator; the
              oracle scores (the run's own predictions as ground truth:
              AP, J, F and VPQ = 1); the native RLE byte-identical to the
              numpy law on every mask produced and ``area`` /
              ``intersection`` / ``iou`` on every GT x prediction pair;
              ``YTVISEval`` on either backend; the native and numpy encode
              of a fragmented 640x960 mask; a driver built per video from
              a state_dict against one handed the built model;
  tools   — ``run_net --train`` as two ``torchrun`` ranks (gloo over
            cuda:0; ``python -m torch.distributed.run`` over this script's
            ``run_net_rank``, which writes each rank's launch counts) at
            the training cell's shape in float32 for 2 steps, then
            ``--resume`` for 1, against the one-process CLI on the same
            tree: losses within 1e-5 x max(1, |v|), ``ckpt_final``'s masters
            within 1e-5 where both share the gradient to 1 %, within two
            Adam steps elsewhere, the first moment within 1e-2, only rank 0
            writing; then the ten tools of ``univs_tpu_torch/tools/`` at
            full width, each call's launches checked
            (``python3 chip_smoke.py tools`` runs this phase alone;
            ``ddp`` adds the same CLI run on NCCL over two cards);
  grads   — kernels A, B and C as ``autograd.Function``s (the kernel
            forward, the plain law's VJP backward) against their plain
            laws at the full-width encoder shape of the training batch
            (4 frames at 1024x1024), float32 and bfloat16: the forward
            within the kernel checks' tolerance, the input gradients
            against ``torch.autograd.grad`` of the plain law;
  tiny    — each driver path against a reference on a small input: the
            tiny config's ``run_vis`` (over R50, ``swin_tiny`` with every
            stage map padded, and ``pvt_v2_b0``) / ``run_vss`` /
            ``run_vps`` / ``VOSDriver.run`` / ``run_grounding`` /
            ``FastVISDriver.run`` / ``ImageDriver.run`` and the VL pixel
            decoder in float32 on the card (through the kernels) and on
            the CPU (plain laws); the expressions tokenized once for both
            sides; one train step of each task (detection, sot,
            grounding) at a tiny training config, losses within 1e-3 and
            Hungarian assignments identical; ``engine._eval_ytvis`` and
            ``engine._eval_vos`` (the same entities, RLE IoU >= 0.99,
            metrics within 1e-3).

Prints one JSON line per check, the ``kernels`` summary line and the card
line, and last ``{"ok": true, "device": {...}}``.  Exits with a non-zero
code, printing no result, when no CUDA device is present or the package
cannot be imported.
"""

from __future__ import annotations

import copy
import json
import os
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

FULL_HW = (640, 960)
VSPW_CLASSES = VIPSEG_CLASSES = 124
# VIPSeg's thing classes, 1-based, 58 of 124 (univs_tpu/data/datasets.py:43-49)
VIPSEG_THING_IDS = (
    3, 5, 9, 11, 42, 44, 45, 47, 48, 49, 50, 51, 52, 53, 55, 56, 57,
    61, 62, 63, 64, 65, 66, 73, 75, 77, 78, 79, 80, 83, 84, 85, 86,
    87, 88, 89, 90, 91, 92, 93, 96, 97, 98, 100, 101, 102, 103, 107,
    108, 109, 110, 115, 116, 117, 118, 119, 123, 124,
)

REPLACES = {
    "msda_rows": "univs_tpu/ops/msda_rows.py:39",
    "msda_sample": "univs_tpu/ops/deformable_attention.py:411 and :490",
    "fused_ffn_ln": "univs_tpu/ops/fused_mlp.py:27",
    "msda_tent_base": "univs_tpu/ops/deformable_attention.py:276",
    "msda_tent_plane": "tools/probe_tent_psum.py:59 and :105, tools/probe_tent_outer.py:39 and :92",
    "msda_tent_probe": "tools/probe_tent_kernel.py:42, tools/probe_tent_variants.py:43, "
                       "tools/probe_tent_v5.py:64",
}
SOURCES = {k: f"univs_tpu_torch/csrc/{k}.cu" for k in REPLACES}


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
    # Dense kernels [in, out] as the model passes them: views of
    # nn.Linear's [out, in] weights
    wo = rn(M * L * P * 2, C, scale=0.05).to(dtype).t()
    bo = torch.as_tensor(msda_offset_bias(M, L, P)).cuda() + rn(M * L * P * 2, scale=0.1)
    wa = rn(M * L * P, C, scale=0.05).to(dtype).t()
    ba = rn(M * L * P, scale=0.1)
    value = rn(n_frames, Lq, M, D).to(dtype)
    src = rn(n_frames, Lq, C).to(dtype)
    attn = rn(n_frames, Lq, C).to(dtype)
    ffn = dict(
        g1=1.0 + rn(C, scale=0.1), c1=rn(C, scale=0.1),
        w1=rn(F, C, scale=C ** -0.5).to(dtype).t(), b1=rn(F, scale=0.1),
        w2=rn(C, F, scale=F ** -0.5).to(dtype).t(), b2=rn(C, scale=0.1),
        g2=1.0 + rn(C, scale=0.1), c2=rn(C, scale=0.1),
    )
    return dict(q=q, wo=wo, bo=bo, wa=wa, ba=ba, value=value, src=src, attn=attn,
                ffn=ffn, M=M, P=P, L=L, Lq=Lq, D=D, C=C, F=F)


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# tolerances, relative to the reference's largest magnitude:
#  - rows: float32 results of products of identical inputs, only the
#    summation order differs -> 1e-4 in both dtypes, the x / y lanes
#    (pixel coordinates) and the weight lanes each against their own
#    magnitude;
#  - sample: float32 accumulation of identical products; a bf16 output
#    rounds once -> 1e-4 (f32), 1e-2 (bf16: ~2 ulp);
#  - ffn: the bf16 hidden activation and output round once each -> 1e-4
#    (f32), 2e-2 (bf16: ~4 ulp of the largest output).
#  - tent_plane: the plane is the same to the bit, its product with the
#    value sums in another order (mma vs cuBLAS) -> 1e-4 (f32 output);
#  - tent_base, tent_probe: the plain versions repeat the kernels' rounding
#    order, so they must agree to the bit -> 0.
TOL = {"msda_rows": (1e-4, 1e-4), "msda_sample": (1e-4, 1e-2), "fused_ffn_ln": (1e-4, 2e-2),
       "msda_tent_base": (0.0, 0.0), "msda_tent_plane": (1e-4, 1e-4),
       "msda_tent_probe": (0.0, 0.0)}


def kernel_checks(results: dict) -> bool:
    """Every kernel against its plain version; fills ``results`` with the
    main-path-shape (bf16) numbers (kernel D: the int8 slab under its
    name, the value-dtype mode under ``msda_tent_base/dtype``) and the
    ``ms_deform_attn`` op timings.  Returns True when all agree."""
    import torch

    from univs_tpu_torch.ops import deformable_attention as da
    from univs_tpu_torch.ops import fused_mlp, msda_rows
    from univs_tpu_torch.tools import time_ms

    ok = True
    cases = [
        ("main", FULL_SHAPES, FULL, MAIN_PATH_FRAMES, torch.bfloat16),
        ("main", FULL_SHAPES, FULL, 2, torch.float32),
        ("tiny", TINY_SHAPES, TINY, 2, torch.float32),
        ("tiny", TINY_SHAPES, TINY, 2, torch.bfloat16),
    ]
    for case, shapes, geo, n, dtype in cases:
        x = make_inputs(shapes, geo, n, dtype, seed=1234)
        M, P = x["M"], x["P"]
        is_bf16 = dtype == torch.bfloat16
        timed = case == "main" and is_bf16
        ff = x["ffn"]
        ffn_args = (ff["g1"], ff["c1"], ff["w1"], ff["b1"], ff["w2"], ff["b2"], ff["g2"], ff["c2"])
        loc = msda_rows.msda_rows_plain(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], shapes, M, P)
        q8, scale = da.quantize_int8_slab(x["value"], shapes)
        deq = scale * torch.tensor(da._DEQUANT, dtype=torch.float32, device=scale.device)
        # name -> (kernel call, plain call, the inputs it reads)
        calls = {
            "msda_rows": (
                lambda: msda_rows.msda_rows_cuda(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], shapes, M, P),
                lambda: msda_rows.msda_rows_plain(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], shapes, M, P),
                (x["q"], x["wo"], x["bo"], x["wa"], x["ba"])),
            "msda_sample": (
                lambda: da.msda_sample_cuda(x["value"], shapes, loc),
                lambda: da.msda_sample_plain(x["value"], shapes, loc),
                (x["value"], loc)),
            "fused_ffn_ln": (
                lambda: fused_mlp.fused_ffn_ln_cuda(x["src"], x["attn"], *ffn_args),
                lambda: fused_mlp.fused_ffn_ln_plain(x["src"], x["attn"], *ffn_args),
                (x["src"], x["attn"], *ff.values())),
            "msda_tent_base": (
                lambda: da.msda_tent_base_cuda(q8, shapes, loc, deq, dtype),
                lambda: da.msda_tent_base_plain(q8, shapes, loc, deq, dtype),
                (q8, deq, loc)),
            "msda_tent_base/dtype": (
                lambda: da.msda_tent_base_cuda(x["value"], shapes, loc),
                lambda: da.msda_tent_base_plain(x["value"], shapes, loc),
                (x["value"], loc)),
        }
        for name, (kern, plain, inputs) in calls.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            rec = dict({"check": name, "case": case, "dtype": str(dtype).replace("torch.", ""),
                        "frames": n}, **compare(name, got, want, dtype))
            if name == "fused_ffn_ln":
                # the body the wrapper launched; the main path's shape must
                # take the wgmma body
                rec["body"] = fused_mlp.ffn_body(dtype, x["C"], x["F"])
                if timed:
                    rec["pass"] &= rec["body"] == "wgmma"
            ok &= rec["pass"]
            if timed:
                rec["kernel_ms"] = time_ms(kern, "cuda", iters=10)
                rec["plain_ms"] = time_ms(plain, "cuda", iters=3, warmup=1)
                if name == "msda_rows":
                    # the yardstick of B's product part alone: one bf16
                    # product with the concatenated [Wo | Wa] (never called
                    # by the port)
                    w_cat = torch.cat([x["wo"].t(), x["wa"].t()]).contiguous()
                    rec["product_linear_ms"] = time_ms(
                        lambda: torch.nn.functional.linear(x["q"], w_cat), "cuda", iters=10)
                if name == "fused_ffn_ln":
                    rec.update(ffn_yardsticks(x))
                if name.startswith("msda_tent_base"):
                    rec.update(gather_traffic(n * x["Lq"] * M * x["L"] * P, 4, x["D"],
                                              inputs[0].element_size(), rec["kernel_ms"]))
                results[name] = dict(rec, **bound_of(name.split("/")[0], x, inputs, got))
            emit(rec)
            del got, want
        ok &= edge_checks(case, shapes, geo, dtype, x)
        if timed:
            ok &= op_timing(x["value"], shapes, loc, results)
        del x, loc, q8, deq
        torch.cuda.empty_cache()
    return ok


def compare(name, got, want, dtype) -> dict:
    """A kernel's output against its plain version, within ``TOL``
    relative to the reference's largest magnitude; kernel B's rows
    [..., 3] hold (x, y, w), so coordinates and weights apart."""
    import torch

    rows = name.startswith("msda_rows")
    parts = ((got[..., :2], want[..., :2]), (got[..., 2], want[..., 2])) if rows else ((got, want),)
    errs = [float((g.float() - w.float()).abs().max()) for g, w in parts]
    scales = [float(w.float().abs().max()) for _, w in parts]
    finite = bool(torch.isfinite(got.float()).all())
    tol = TOL[name.split("/")[0]][int(dtype == torch.bfloat16)]
    passed = finite and all(e <= tol * max(s, 1e-6) for e, s in zip(errs, scales))
    rec = {"max_abs_err": max(errs), "ref_max_abs": max(scales), "tol_rel": tol, "pass": passed}
    if rows:
        rec.update(xy_max_abs_err=errs[0], xy_ref_max_abs=scales[0],
                   w_max_abs_err=errs[1], w_ref_max_abs=scales[1])
    return rec


# level sizes whose query count is not a multiple of kernel B's query
# tile (64 on the tensor cores, 32 on the CUDA cores): 12,600 - 37 at full
# width, 126 - 8 at the tiny one
RAGGED_SHAPES = {"main": ((20, 30), (40, 60), (73, 131)), "tiny": ((2, 3), (4, 6), (8, 11))}


def border_rows(shapes, N, M, P, seed):
    """Rows [N, Lq, M, L, P, 3] whose samples lie on and past every border
    of every level: x and y each one of {-1.5, -1, -0.5, 0, size - 1,
    size - 0.5, size, size + 0.5} (the 64 pairs drawn per sample), a
    quarter of the weights exactly 0."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    Lq, L = sum(h * w for h, w in shapes), len(shapes)
    loc = torch.empty(N, Lq, M, L, P, 3)
    for lid, (h, w) in enumerate(shapes):
        xs = torch.tensor([-1.5, -1.0, -0.5, 0.0, w - 1.0, w - 0.5, float(w), w + 0.5])
        ys = torch.tensor([-1.5, -1.0, -0.5, 0.0, h - 1.0, h - 0.5, float(h), h + 0.5])
        k = torch.randint(0, 64, (N, Lq, M, P), generator=g)
        loc[:, :, :, lid, :, 0] = xs[k % 8]
        loc[:, :, :, lid, :, 1] = ys[k // 8]
    wts = torch.rand(N, Lq, M, L, P, generator=g)
    loc[..., 2] = torch.where(torch.rand(N, Lq, M, L, P, generator=g) < 0.25, 0.0, wts)
    return loc.cuda()


def edge_checks(case, shapes, geo, dtype, x) -> bool:
    """Kernels A, B and C at their edges against their plain versions,
    with the ``TOL`` tolerances: A on samples on and past every border of
    every level (the case's value, 2 frames), B at a query count that is
    not a multiple of its query tile (``RAGGED_SHAPES``, 2 frames, so a
    tile also straddles the frames), C at ``FFN_EDGES``."""
    from univs_tpu_torch.ops import deformable_attention as da
    from univs_tpu_torch.ops import msda_rows

    head = {"case": case, "dtype": str(dtype).replace("torch.", ""), "frames": 2}
    value = x["value"][:2]
    loc = border_rows(shapes, 2, x["M"], x["P"], seed=5)
    got = da.msda_sample_cuda(value, shapes, loc)
    rec_a = dict(head, check="msda_sample/border", D=x["D"],
                 **compare("msda_sample", got, da.msda_sample_plain(value, shapes, loc), dtype))
    emit(rec_a)
    rs = RAGGED_SHAPES[case]
    y = make_inputs(rs, geo, 2, dtype, seed=77)
    args = (y["q"], y["wo"], y["bo"], y["wa"], y["ba"], rs, y["M"], y["P"])
    got = msda_rows.msda_rows_cuda(*args)
    rec_b = dict(head, check="msda_rows/ragged", Lq=y["Lq"], D=y["D"],
                 **compare("msda_rows", got, msda_rows.msda_rows_plain(*args), dtype))
    emit(rec_b)
    ffn_ok = ffn_edge_checks(case, geo, dtype, x["ffn"])
    tent_ok = tent_base_edge_checks(head, shapes, value, loc)
    return rec_a["pass"] and rec_b["pass"] and ffn_ok and tent_ok


def tent_base_edge_checks(head, shapes, value, loc) -> bool:
    """Kernel D in both modes (int8 slab, value dtype) at its edges, to
    the bit: on the border rows of every level (2 frames); on their first
    Lq - 37 queries of one frame, a count that leaves a partial warp of
    lane groups where a query's groups fill less than a warp (at full
    width the int8 slab and a bf16 value, every mode at the tiny one; the
    record gives the launch's threads modulo 32); and on one frame of them
    with the weights scaled by 300."""
    import torch

    from univs_tpu_torch.ops import deformable_attention as da

    dtype = value.dtype
    q8, scale = da.quantize_int8_slab(value, shapes)
    deq = scale * torch.tensor(da._DEQUANT, dtype=torch.float32, device=scale.device)
    M, D = value.shape[2:]
    ok = True
    # wide taps: weights of up to 300 make |mq| = rint(tx * 127) pass the
    # int16 range of the int8 mode's dp2a, whose other path must agree too
    wide = loc.clone()
    wide[..., 2] *= 300.0
    for where, n, lq, src in (("border", 2, loc.shape[1], loc),
                              ("ragged", 1, loc.shape[1] - 37, loc),
                              ("wide_taps", 1, loc.shape[1], wide)):
        rows = src[:n, :lq].contiguous()
        for mode, args in (("int8", (q8[:n], shapes, rows, deq[:n], dtype)),
                           ("dtype", (value[:n], shapes, rows))):
            got = da.msda_tent_base_cuda(*args)
            want = da.msda_tent_base_plain(*args)
            # a lane's piece (msda_tent_base.cu): 16 bytes of the slab, 32 of a value
            size = args[0].element_size()
            lanes = D * size // min(16 if mode == "int8" else 32, D * size)
            rec = dict(head, check=f"msda_tent_base/{where}", mode=mode, frames=n, Lq=lq, D=D,
                       threads_mod_32=n * lq * M * min(lanes, 32) % 32,
                       **compare("msda_tent_base", got, want, dtype))
            emit(rec)
            ok &= rec["pass"]
    return ok


# kernel C's edges (frames, tokens a frame, inputs): fewer tokens than one
# 128-token tile; two frames whose tokens straddle tiles and the frame
# border; src + attn with mean 100 and std 1 (a one-pass variance cancels
# there); every other row constant (variance 0: the eps path)
FFN_EDGES = {"main": (("below_tile", 1, 37, "random"), ("straddle", 2, 12563, "random"),
                      ("offset", 1, 4000, "offset"), ("constant_rows", 1, 4000, "constant")),
             "tiny": (("below_tile", 1, 37, "random"), ("straddle", 2, 125, "random"),
                      ("offset", 1, 200, "offset"), ("constant_rows", 1, 200, "constant"))}


def ffn_edge_inputs(N, S, C, kind, dtype, seed):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    src, attn = torch.randn(N, S, C, generator=g), torch.randn(N, S, C, generator=g)
    if kind == "offset":
        src, attn = 100.0 + 0.6 * src, 0.8 * attn
    elif kind == "constant":
        # values with 8 significant bits, so that a row's float32 sum and
        # mean are exact in either dtype and its deviations exactly 0
        const = torch.arange(S) % 2 == 0
        v = (torch.randn(N, int(const.sum()), 1, generator=g) * 3.0).to(torch.bfloat16).float()
        src[:, const] = v
        attn[:, const] = 0.0
    return src.to(dtype).cuda(), attn.to(dtype).cuda()


def ffn_edge_checks(case, geo, dtype, ff) -> bool:
    """Kernel C at its edges (``FFN_EDGES``) against its plain version,
    with the case's weights and the ``TOL`` tolerances."""
    from univs_tpu_torch.ops import fused_mlp

    args = (ff["g1"], ff["c1"], ff["w1"], ff["b1"], ff["w2"], ff["b2"], ff["g2"], ff["c2"])
    ok = True
    for i, (edge, N, S, kind) in enumerate(FFN_EDGES[case]):
        src, attn = ffn_edge_inputs(N, S, geo["C"], kind, dtype, seed=300 + i)
        got = fused_mlp.fused_ffn_ln_cuda(src, attn, *args)
        want = fused_mlp.fused_ffn_ln_plain(src, attn, *args)
        rec = dict({"check": f"fused_ffn_ln/{edge}", "case": case,
                    "dtype": str(dtype).replace("torch.", ""), "frames": N, "tokens": S,
                    "body": fused_mlp.ffn_body(dtype, geo["C"], geo["F"])},
                   **compare("fused_ffn_ln", got, want, dtype))
        emit(rec)
        ok &= rec["pass"]
    return ok


def ffn_yardsticks(x) -> dict:
    """Kernel C's yardsticks on the timed case's inputs, calls the port
    never makes: the unfused bf16 sequence (add, ``F.layer_norm``,
    ``F.linear``, relu, ``F.linear``, add, ``F.layer_norm``) and its two
    ``F.linear`` products alone."""
    import torch
    import torch.nn.functional as tf

    from univs_tpu_torch.tools import time_ms

    ff, dt, C = x["ffn"], x["src"].dtype, x["C"]
    v = {k: ff[k].to(dt) for k in ("g1", "c1", "b1", "b2", "g2", "c2")}
    w1, w2 = ff["w1"].t(), ff["w2"].t()  # nn.Linear's [out, in]: contiguous

    def unfused():
        u = tf.layer_norm(x["src"] + x["attn"], (C,), v["g1"], v["c1"], 1e-5)
        y = tf.linear(torch.relu(tf.linear(u, w1, v["b1"])), w2, v["b2"])
        return tf.layer_norm(u + y, (C,), v["g2"], v["c2"], 1e-5)

    u = tf.layer_norm(x["src"] + x["attn"], (C,), v["g1"], v["c1"], 1e-5)
    hdn = torch.relu(tf.linear(u, w1, v["b1"]))
    return {"unfused_ms": time_ms(unfused, "cuda", iters=10),
            "products_ms": time_ms(lambda: (tf.linear(u, w1, v["b1"]), tf.linear(hdn, w2, v["b2"])),
                                   "cuda", iters=10)}


def rows_to_locations(shapes, loc):
    """Kernel rows -> the JAX API's (sampling_locations in [0, 1],
    attention_weights)."""
    import torch

    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=loc.device)
    return (loc[..., :2] + 0.5) / size[:, None, :], loc[..., 2]


def op_timing(value, shapes, loc, results) -> bool:
    """The whole ``ms_deform_attn`` op at the main path's shape (bf16):
    ``impl='tent-int8'`` (quantisation + kernel D) beside ``impl='tent'``
    (kernel A), each output's error against the float32 law on the same
    locations: the card's reading of the int8 trade."""
    import torch

    from univs_tpu_torch.ops import deformable_attention as da
    from univs_tpu_torch.tools import time_ms

    sl, aw = rows_to_locations(shapes, loc)
    exact = da.msda_sample_plain(value.float(), shapes, da.locations_to_rows(shapes, sl, aw))
    scale = float(exact.abs().max())
    rec = {"op": "ms_deform_attn", "dtype": str(value.dtype).replace("torch.", ""),
           "frames": value.shape[0], "f32_law_max_abs": scale}
    for impl in ("tent-int8", "tent"):
        fn = lambda impl=impl: da.ms_deform_attn(value, shapes, sl, aw, impl=impl)  # noqa: E731
        out = fn()
        rec[f"{impl}_max_abs_err_vs_f32_law"] = float((out.float() - exact).abs().max())
        rec[f"{impl}_mean_abs_err_vs_f32_law"] = float((out.float() - exact).abs().mean())
        rec[f"{impl}_ms"] = time_ms(fn, "cuda", iters=10)
    # int8: ~|v|_max / 127 per sample (tests/test_ops.py:108's bound);
    # tent: one bf16 rounding of the output
    passed = (rec["tent-int8_max_abs_err_vs_f32_law"] <= 0.05 * scale
              and rec["tent_max_abs_err_vs_f32_law"] <= 1e-2 * scale)
    rec["pass"] = passed
    results["op"] = rec
    emit(rec)
    return passed


def bound_of(name, x, inputs, out):
    """Least time the card could take for the same work: max(bytes /
    HBM rate, operations / peak rate of their type), each input read once
    and each output written once."""
    from univs_tpu_torch.tools.analyze_model import encoder_layer_ops

    N, Lq, C, M, P, L, F = x["q"].shape[0], x["Lq"], x["C"], x["M"], x["P"], x["L"], x["F"]
    byts = nbytes(*inputs, out)
    # D samples as A does: 4 corner products and sums per channel
    ops = encoder_layer_ops(N, Lq, C, M, L, P, F)[
        "msda_sample" if name == "msda_tent_base" else name]
    rate = F32_FLOPS if name in ("msda_sample", "msda_tent_base") else BF16_TENSOR_FLOPS
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": byts, "ops": ops}


# the probes' geometry (tools/probe_tent_*.py): the 1/8 level of 640x960,
# 5 frames, 8 heads, 4 points, D=32; E's window of 16 rows (a height both
# psum and outer sweep there) over chunks of 512 queries in blocks of 2048;
# a tiny shape beside it
PROBE_CASES = {
    "probe": dict(shapes=((80, 120), (40, 60), (20, 30)), M=8, P=4, N=5, D=32, Hw=16, bqq=2048,
                  subq=512, Lq=12600),
    "tiny": dict(shapes=((16, 12), (8, 6)), M=2, P=2, N=1, D=8, Hw=8, bqq=64, subq=64, Lq=20),
}


def plane_inputs(case, dtype, lid=0, Hw=None):
    """Kernel E's inputs: the psum probe's rows and raster slab of level
    ``lid`` (0: the first, largest), and the window meta of height ``Hw``
    (the case's by default)."""
    import torch

    from univs_tpu_torch.ops import msda_probes
    from univs_tpu_torch.tools import probe_tent_psum

    c = dict(PROBE_CASES[case])
    c["Hw"] = Hw or c["Hw"]
    slab, rows, RQ, (H, W), _, _ = probe_tent_psum.level_inputs(
        c["shapes"], lid, c["M"], c["P"], c["N"], c["D"], np.random.RandomState(1),
        torch.device("cuda"), dtype, c["bqq"])
    meta = msda_probes.window_meta(rows, c["M"], c["P"], H, W, c["Hw"], c["bqq"], c["subq"])
    return dict(c, slab=slab, rows=rows, RQ=RQ, H=H, W=W, meta=meta)


def tent_probe_inputs(case, dtype):
    """Kernel F's inputs on the first level of the case: one value in the
    d-major and the j-major slab, and uniform samples a little past every
    edge."""
    import torch

    c = PROBE_CASES[case]
    (H, W), N, M, D = c["shapes"][0], c["N"], c["M"], c["D"]
    R = c["Lq"] * c["P"]
    rng = np.random.RandomState(0)
    v = torch.as_tensor(rng.randn(N, M, H, W, D).astype(np.float32)).to(dtype).cuda()
    f32 = [torch.as_tensor(a.astype(np.float32)).cuda() for a in (
        rng.uniform(-1.5, W + 0.5, (N, R, M)), rng.uniform(-1.5, H + 0.5, (N, R, M)),
        rng.rand(N, R, M))]
    return dict(c, H=H, W=W, R=R, xs=f32[0], ys=f32[1], was=f32[2],
                dmajor=v.permute(0, 1, 3, 4, 2).reshape(N, M, W, D * H).contiguous(),
                jmajor=v.permute(0, 1, 3, 2, 4).reshape(N, M, W, H * D).contiguous())


def gather_traffic(samples, reads, D, size, ms) -> dict:
    """The 32-byte sectors a gather kernel's samples touch, each sample's
    ``reads`` reads of ``D`` contiguous elements of ``size`` bytes counted
    once per sample (an upper bound on the L2 traffic: hits in L1 are not
    subtracted, a read straddling two sectors counts one), and the rate
    that traffic would need at the kernel's time."""
    byts = float(samples) * reads * -(-D * size // 32) * 32
    return {"gather_bytes": byts, "gather_tb_per_s": byts / (ms * 1e-3) / 1e12}


def probe_bound(inputs, out, ops) -> dict:
    """The function's minimal work, as kernel A's (one level): each input
    the output depends on read once (E: the RQ query rows, not the padded
    ones or the window meta), the output written once, ``ops`` float32
    operations."""
    byts = nbytes(*inputs, out)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": byts, "ops": ops}


def plane_work(x, window: bool) -> dict:
    """Kernel E's own algorithmic work: the plane entries of the window's
    rows where a chunk hits and of the whole level elsewhere, over all Qp
    query rows (``plane_*``) and over the RQ rows the result depends on
    (``plane_rq_*``); their product with the value (``*_flops``) at the
    peak of the body the slab's dtype runs (``plane_peak``: bf16 tensor
    cores, or float32 FMA), and the law's products and sums per entry and
    point (2P; the narrow tents are negligible).  ``plane_rq_ms_at_peak``
    is the formulation's bound (the plane bound)."""
    S, Qp, RQ = x["H"] * x["W"], x["rows"].shape[1], x["RQ"]
    if window:
        k = np.where(x["meta"][..., 1].cpu().numpy() == 1, x["Hw"] * x["W"], S)
        k = k.reshape(x["N"], Qp // x["subq"], x["M"])
        rq_rows = np.clip(RQ - np.arange(Qp // x["subq"]) * x["subq"], 0, x["subq"])
        entries = float(k.sum()) * x["subq"]
        entries_rq = float((k * rq_rows[None, :, None]).sum())
    else:
        entries = float(x["N"] * x["M"] * Qp * S)
        entries_rq = float(x["N"] * x["M"] * RQ * S)
    bf16 = str(x["slab"].dtype) == "torch.bfloat16"
    rec = {"plane_peak": "bf16 tensor" if bf16 else "float32 FMA"}
    peak = BF16_TENSOR_FLOPS if bf16 else F32_FLOPS
    for key, e in (("plane", entries), ("plane_rq", entries_rq)):
        flops = 2.0 * e * x["D"]
        build = 2.0 * x["P"] * e
        rec.update({f"{key}_entries": e, f"{key}_flops": flops, f"{key}_build_ops": build,
                    f"{key}_ms_at_peak": flops / peak * 1e3,
                    f"{key}_build_ms_at_f32_peak": build / F32_FLOPS * 1e3})
    return rec


def plane_level_bounds(level, Hw) -> dict:
    """Kernel E's function bound and plane bound on the tools path's inputs
    of one level of the probes (bf16, ``Hw`` None for the whole level)."""
    import torch

    c = PROBE_CASES["probe"]
    e = plane_inputs("probe", torch.bfloat16, c["shapes"].index(tuple(level)), Hw)
    out = torch.empty((e["N"], e["RQ"], e["M"], e["D"]), dtype=torch.float32, device="cuda")
    ops = 2.0 * e["N"] * e["RQ"] * e["M"] * e["P"] * 4 * e["D"]
    work = plane_work(e, Hw is not None)
    return dict(probe_bound((e["slab"], e["rows"][:, :e["RQ"]]), out, ops),
                plane_bound_ms=work["plane_rq_ms_at_peak"], plane_peak=work["plane_peak"])


# kernel E's edges: a level of 16 x 20 (64-pixel chunks end inside rows),
# 2 frames, 2 heads, 4 points, 320 query rows of which RQ = 300 are kept
# (the second block of 256 queries holds one partial tile, the last block
# of 64 a partial one), windows of 8 rows over chunks of 64 queries
PLANE_EDGE = dict(H=16, W=20, M=2, P=4, N=2, Qp=320, RQ=300, Hw=8, subq=64)


def plane_edge_inputs(D, dtype):
    """Kernel E's edge rows: queries 0-15 with all four points in one
    pixel cell (coincident taps), 16-31 with points whose taps straddle a
    64-pixel chunk of the whole level or of the window (its kbeg is 40 for
    those chunks) and a 16-pixel k-step, the first two query
    chunks clustered in rows 2-9 (their windows hit), the others spread
    over the level (they miss), rows RQ.. the probes' padding."""
    import torch

    from univs_tpu_torch.ops import msda_probes

    c = PLANE_EDGE
    N, M, P, H, W, Qp, RQ = (c[k] for k in ("N", "M", "P", "H", "W", "Qp", "RQ"))
    rng = np.random.RandomState(5)
    x = rng.uniform(-1.5, W + 0.5, (N, Qp, M, P))
    y = rng.uniform(-1.5, H + 0.5, (N, Qp, M, P))
    wa = rng.uniform(-1.0, 1.0, (N, Qp, M, P))
    y[:, :128] = rng.uniform(3.0, 8.0, (N, 128, M, P))
    x[:, :16] = np.floor(x[:, :16, :, :1]) + rng.uniform(0.0, 1.0, (N, 16, M, P))
    y[:, :16] = np.floor(y[:, :16, :, :1]) + rng.uniform(0.0, 1.0, (N, 16, M, P))
    # taps (s, s + 1) across the whole level's chunks (63, 127), the
    # window's chunk (103) and k-step (87)
    border = np.array([63, 103, 127, 87])
    x[:, 16:32] = border % W + rng.uniform(0.0, 1.0, (N, 16, M, P))
    y[:, 16:32] = border // W + rng.uniform(0.0, 1.0, (N, 16, M, P))
    x[:, RQ:], y[:, RQ:], wa[:, RQ:] = -10.0, float(H // 2), 0.0
    rows = np.concatenate([a.reshape(N, Qp, M * P) for a in (x, y, wa)], axis=2)
    rows = torch.as_tensor(rows.astype(np.float32)).cuda()
    slab = torch.as_tensor(rng.randn(N, M, H * W, D).astype(np.float32)).to(dtype).cuda()
    meta = msda_probes.window_meta(rows, M, P, H, W, c["Hw"], c["subq"], c["subq"])
    return dict(c, D=D, slab=slab, rows=rows, meta=meta)


def plane_edge_checks() -> bool:
    """Kernel E against its plain version (``TOL``) in both dtypes and
    modes, whole level and windowed, on ``plane_edge_inputs`` at D = 32,
    24, 16 and 64 (every product width the kernel builds: D rounded up to
    8, 16, 32 or 64; D = 8 is the tiny case), and the window's hit rate
    strictly between 0 and 1."""
    import torch

    from univs_tpu_torch.ops import msda_probes as mp

    ok = True
    for D in (32, 24, 16, 64):
        for dtype in (torch.bfloat16, torch.float32):
            e = plane_edge_inputs(D, dtype)
            hit = float(e["meta"][..., 1].float().mean())
            ok &= 0.0 < hit < 1.0
            for mode in mp.PLANE_MODES:
                want = mp.msda_tent_plane_plain(e["slab"], e["rows"], e["RQ"], e["W"], e["P"],
                                                mode)
                for window in (False, True):
                    kw = dict(meta=e["meta"], Hw=e["Hw"], subq=e["subq"]) if window else {}
                    got = mp.msda_tent_plane_cuda(e["slab"], e["rows"], e["RQ"], e["W"], e["P"],
                                                  mode, **kw)
                    torch.cuda.synchronize()
                    rec = dict({"check": "msda_tent_plane/edges", "mode": mode,
                                "window": window, "D": D, "RQ": e["RQ"], "Qp": e["Qp"],
                                "window_hit": hit, "dtype": str(dtype).replace("torch.", ""),
                                "body": mp.plane_body(dtype)},
                               **compare("msda_tent_plane", got, want, dtype))
                    emit(rec)
                    ok &= rec["pass"]
            del e
    return ok


def probe_kernel_checks(results: dict) -> bool:
    """Kernels E (four modes) and F (six laws) against their plain
    versions on the card at the probes' geometry (bf16, timed, and
    float32) and at a tiny shape; fills ``results`` with the timed
    numbers (``msda_tent_plane`` = psum over the whole level,
    ``msda_tent_probe`` = the base law, the others under
    ``<kernel>/<mode>``).  Returns True when all agree."""
    import torch

    from univs_tpu_torch.ops import msda_probes as mp
    from univs_tpu_torch.tools import time_ms

    ok = True
    for case, dtype in (("probe", torch.bfloat16), ("probe", torch.float32),
                        ("tiny", torch.float32), ("tiny", torch.bfloat16)):
        is_bf16 = dtype == torch.bfloat16
        timed = case == "probe" and is_bf16
        e, f = plane_inputs(case, dtype), tent_probe_inputs(case, dtype)
        calls = {}
        for mode in mp.PLANE_MODES:
            for window in (False, True):
                kw = dict(meta=e["meta"], Hw=e["Hw"], subq=e["subq"]) if window else {}
                name = "msda_tent_plane" + ("" if (mode, window) == ("psum", False) else
                                            f"/{mode}{'-win' if window else ''}")
                calls[name] = (
                    lambda mode=mode, kw=kw: mp.msda_tent_plane_cuda(
                        e["slab"], e["rows"], e["RQ"], e["W"], e["P"], mode, **kw),
                    lambda mode=mode: mp.msda_tent_plane_plain(
                        e["slab"], e["rows"], e["RQ"], e["W"], e["P"], mode),
                    (e["slab"], e["rows"][:, :e["RQ"]]),
                    2.0 * e["N"] * e["RQ"] * e["M"] * e["P"] * 4 * e["D"], window)
        for law, (use_wa, *_) in mp.PROBE_LAWS.items():
            layout = "jmajor" if law.startswith("exp") else "dmajor"
            group = f["P"] if use_wa else 1
            args = (f[layout], f["xs"], f["ys"], f["was"] if use_wa else None, f["D"], group, law,
                    layout)
            calls["msda_tent_probe" + ("" if law == "base" else f"/{law}")] = (
                lambda args=args: mp.msda_tent_probe_cuda(*args),
                lambda args=args: mp.msda_tent_probe_plain(*args),
                tuple(a for a in args[:4] if a is not None),
                2.0 * f["N"] * f["R"] * f["M"] * 4 * f["D"], None)
        for name, (kern, plain, inputs, ops, window) in calls.items():
            base = name.split("/")[0]
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            tol = TOL[base][int(is_bf16)]
            passed = bool(torch.isfinite(got).all()) and err <= tol * max(scale, 1e-6)
            ok &= passed
            rec = {"check": name, "case": case, "dtype": str(dtype).replace("torch.", ""),
                   "frames": e["N"] if base == "msda_tent_plane" else f["N"],
                   "max_abs_err": err, "ref_max_abs": scale, "tol_rel": tol, "pass": passed}
            if window is not None:
                rec.update(plane_work(e, window), window_hit=float(e["meta"][..., 1].float().mean())
                           if window else None, body=mp.plane_body(dtype))
            # bf16 timed for every kernel; kernel E's float32 modes as well
            if timed or (case == "probe" and base == "msda_tent_plane"):
                rec["kernel_ms"] = time_ms(kern, "cuda", iters=10)
                rec["plain_ms"] = time_ms(plain, "cuda", iters=2, warmup=1)
                rec.update(probe_bound(inputs, got, ops))
                if base == "msda_tent_probe":
                    # d-major: each channel's rows (j, j + 1) at two columns;
                    # j-major: four corners of contiguous channels
                    dmajor = inputs[0] is f["dmajor"]
                    rec.update(gather_traffic(
                        f["N"] * f["R"] * f["M"], 2 * f["D"] if dmajor else 4,
                        1 if dmajor else f["D"], inputs[0].element_size(), rec["kernel_ms"]))
                if timed:
                    results[name] = rec
                else:  # beside the bf16 modes in the kernels line, as <mode>-f32
                    key = name.split("/", 1)[1] if "/" in name else "psum"
                    results[f"msda_tent_plane/{key}-f32"] = rec
            emit(rec)
            del got, want
        ok &= tent_probe_straddle_checks(case, dtype, f)
        del e, f, calls
        torch.cuda.empty_cache()
    return ok


def tent_probe_straddle_checks(case, dtype, f) -> bool:
    """Kernel F at every law in both slab layouts, to the bit, on the
    case's first M - 1 heads and all its rows but the last group: a count
    of lane groups that does not fill the last warp, so groups straddle
    its end (the record gives the launch's threads modulo 32)."""
    from univs_tpu_torch.ops import msda_probes as mp

    ok = True
    N, M1, D = f["N"], f["M"] - 1, f["D"]
    for law, (use_wa, *_) in mp.PROBE_LAWS.items():
        group = f["P"] if use_wa else 1
        R1 = f["R"] - group
        xs, ys, was = (f[k][:, :R1, :M1].contiguous() for k in ("xs", "ys", "was"))
        for layout in mp.SLAB_LAYOUTS:
            slab = f[layout][:, :M1].contiguous()
            args = (slab, xs, ys, was if use_wa else None, D, group, law, layout)
            got = mp.msda_tent_probe_cuda(*args)
            want = mp.msda_tent_probe_plain(*args)
            # lanes a group (msda_tent_probe.cu): d-major min(D, 4) channels
            # a lane, j-major a piece of min(16, D * size) bytes
            size = slab.element_size()
            pieces = D // min(D, 4) if layout == "dmajor" else D * size // min(16, D * size)
            rec = dict({"check": "msda_tent_probe/straddle", "case": case, "law": law,
                        "layout": layout, "dtype": str(dtype).replace("torch.", ""),
                        "frames": N, "rows": R1, "heads": M1,
                        "threads_mod_32": N * (R1 // group) * M1 * min(pieces, 32) % 32},
                       **compare("msda_tent_probe", got, want, dtype))
            emit(rec)
            ok &= rec["pass"]
    return ok


def run_probe_path():
    """The tools probes: each ported probe's runner at its geometry (5
    frames, bf16) on the card, with the launch counts set to 0 just
    before and read after all five; each record's kernel calls make the
    expectation (kernel E for psum / outer, F for kernel / variants / v5,
    A beside each level).  Returns (ok, launches)."""
    from univs_tpu_torch.tools import (probe_tent_kernel, probe_tent_outer, probe_tent_psum,
                                       probe_tent_v5, probe_tent_variants)

    runners = {"probe_tent_psum": probe_tent_psum.run, "probe_tent_outer": probe_tent_outer.run,
               "probe_tent_kernel": probe_tent_kernel.run,
               "probe_tent_variants": probe_tent_variants.run, "probe_tent_v5": probe_tent_v5.run}
    records, launches = counted(lambda: [dict(r, runner=name) for name, run in runners.items()
                                         for r in run()])
    expected = expected_launches()
    for r in records:
        expected[r["kernel"]] += r["calls"]
    counts_ok = check_launches("tools probes", launches, expected)
    counts_ok &= launches["msda_tent_plane"] > 0 and launches["msda_tent_probe"] > 0
    bounds = {}
    for r in records:
        if r["kernel"] == "msda_tent_plane":
            key = (tuple(r["level"]), r.get("Hw"))
            if key not in bounds:
                bounds[key] = plane_level_bounds(*key)
            r.update(bounds[key])
        emit(dict(r, path="tools probes"))
    out_ok = all(r["pass"] for r in records)
    # the card's reading: each formulation's ms per probe and level, kernel A beside it
    reading = {}
    for r in records:
        key = f"{r['probe']} {r['level'][0]}x{r['level'][1]}"
        label = r["formulation"] + (f" Hw={r['Hw']}" if r.get("hit") is not None else "")
        reading.setdefault(key, {})[label] = r["ms"]
    emit({"path": "tools probes", "records": len(records), "ms_by_probe_level": reading,
          "launches_ok": counts_ok, "outputs_ok": out_ok})
    return counts_ok and out_ok, launches


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


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (its wall ms, the device's
    busy ms, the top 12 device kernels by ms), or None where the profiler
    saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kern:
        return None
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return wall_ms, sum(by_name.values()), [[n[:80], t] for n, t in top]


def profile_run(driver, video, cls_emb, unprofiled_s, label: str = "run_vis"):
    """One extra ``run_vis`` under torch.profiler: device time by kernel
    (top 12) and the device's idle share.  The profiler lengthens the
    host's side of the run, so the idle share is taken over the wall time
    of each unprofiled run of the same call (``unprofiled_s``); the share
    over the profiled run's own wall time is printed beside it.  The
    record says "not measured" where the profiler saw no device time."""
    got = device_profile(lambda: driver.run_vis(video, cls_emb))
    if got is None:
        return {"profile": label, "device_time": "not measured"}
    wall_ms, busy_ms, top = got
    idle = [max(0.0, 1.0 - busy_ms / (s * 1e3)) for s in unprofiled_s]
    return {"profile": label, "device_busy_ms": busy_ms,
            "unprofiled_wall_ms": [s * 1e3 for s in unprofiled_s],
            "device_idle_share": idle,
            "profiled_wall_ms": wall_ms,
            "device_idle_share_profiled_wall": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels_ms": top}


def profile_call(label: str, fn) -> dict:
    """``device_profile`` of one call as a record: device busy ms and its
    top kernels (no idle share: the call has no host phase of its own)."""
    got = device_profile(fn)
    if got is None:
        return {"profile": label, "device_time": "not measured"}
    return {"profile": label, "wall_ms": got[0], "device_busy_ms": got[1], "top_kernels_ms": got[2]}


# the kernels of the pixel decoder's encoder layers, run 6 times per encode
ENCODER_KERNELS = ("msda_sample", "msda_rows", "fused_ffn_ln")


def expected_launches(encodes: int = 0, layers: int = 6, **extra) -> dict:
    """Per-kernel launch expectation of one path: the encoder's kernels
    once per layer and encode, every other kernel 0 unless named."""
    from univs_tpu_torch.ops import kernels

    want = {k: 0 for k in kernels.KERNELS}
    want.update({k: layers * encodes for k in ENCODER_KERNELS})
    want.update(extra)
    return want


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before it; returns
    (its result, the counts read just after a synchronise)."""
    import torch

    from univs_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


class HostTime:
    """Calls and host seconds of ``owner.name`` (a module's function or a
    class's method) while the ``with`` block runs: the host's wall time
    inside each call, no synchronise added, so a call that waits for the
    device counts the wait."""

    def __init__(self, owner, name: str):
        self._owner, self._name = owner, name

    def __enter__(self):
        self._fn = getattr(self._owner, self._name)
        self.calls, self.s = 0, 0.0

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self._fn(*args, **kwargs)
            finally:
                self.calls += 1
                self.s += time.perf_counter() - t0

        setattr(self._owner, self._name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._owner, self._name, self._fn)

    def record(self) -> dict:
        return {"calls": self.calls, "host_s": self.s}


def host_times(fn):
    """(fn's result, the host time of a VIS run's parts): the window
    encodes, the clip steps (the JV walks inside them), the host assembly
    of the results (the RLE encodes inside it)."""
    import contextlib

    from univs_tpu_torch.inference import driver
    from univs_tpu_torch.losses import hungarian
    from univs_tpu_torch.utils import rle

    spots = {"encode": (driver._StreamingDriver, "encode_window"),
             "clip_steps": (driver, "entity_clip_step"), "jv": (hungarian, "hungarian_numpy"),
             "assembly": (driver, "assemble_vis_results"), "rle": (rle, "encode")}
    with contextlib.ExitStack() as stack:
        timers = {k: stack.enter_context(HostTime(*v)) for k, v in spots.items()}
        out = fn()
    return out, {k: t.record() for k, t in timers.items()}


def tiny_setup():
    """The tiny config with relaxed gates (as tests/test_torch_driver.py),
    a seeded 8-frame 64x96 video and a seeded 5-class bank."""
    import dataclasses

    import torch

    from univs_tpu_torch.config import tiny_test_config

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
    return cfg, video, cls_emb


def tiny_drivers(cfg, K, seed):
    """The same seeded tiny model on the card and on the CPU."""
    from univs_tpu_torch.inference.driver import EntityDriver

    return (EntityDriver(cfg, None, num_classes=K, capacity=6, device="cuda", seed=seed),
            EntityDriver(cfg, None, num_classes=K, capacity=6, device="cpu", seed=seed))


def reference_check(cfg=None, label: str = "run_vis_tiny") -> bool:
    """The whole path against a reference on a small input: the tiny
    config's ``run_vis`` (or ``cfg``'s, with its backbone) in float32 on
    the card (through the kernels, head width D=8) and on the CPU (plain
    laws), from the same seeded weights and video.  The same entities must come out, each frame's
    mask with IoU >= 0.99 and class scores within 1e-3: float32 results
    that differ only in summation order (cuDNN vs CPU convolutions, the
    kernels vs the plain laws) may flip a pixel whose logit is ~0."""
    from univs_tpu_torch.utils import rle

    tiny_cfg, video, cls_emb = tiny_setup()
    cuda_d, cpu_d = tiny_drivers(cfg or tiny_cfg, cls_emb.shape[0], seed=3)
    got, launches = counted(lambda: cuda_d.run_vis(video, cls_emb))
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    want = cpu_d.run_vis(video, cls_emb)
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
    emit({"check": f"{label}_cuda_vs_cpu", "entities_cuda": len(got),
          "entities_cpu": len(want), "kernels_launched": launched, "min_mask_iou": min_iou,
          "max_score_abs_err": max_score_err, "pass": bool(ok)})
    return bool(ok)


def reference_check_vss() -> bool:
    """``run_vss`` on the tiny config, float32, card vs CPU (weights of
    seed 0, which predict two classes): every frame's label map agrees on
    >= 99 % of its pixels (a pixel whose two best classes are ~tied may
    flip with the summation order)."""
    cfg, video, cls_emb = tiny_setup()
    cuda_d, cpu_d = tiny_drivers(cfg, cls_emb.shape[0], seed=0)
    got, launches = counted(lambda: cuda_d.run_vss(video, cls_emb))
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    want = cpu_d.run_vss(video, cls_emb)
    agree = [float((g == w).mean()) for g, w in zip(got, want)]
    ok = launched and got.shape == want.shape and min(agree) >= 0.99
    emit({"check": "run_vss_tiny_cuda_vs_cpu", "frames": len(agree),
          "classes_cpu": np.unique(want).tolist(), "kernels_launched": launched,
          "min_frame_agreement": min(agree), "pass": bool(ok)})
    return bool(ok)


def reference_check_vps() -> bool:
    """``run_vps`` on the tiny config, float32, card vs CPU, things
    {1, 3} of 5 classes (weights of seed 0: a thing and a stuff
    segment): the same segments (ids, classes, thing flags) and every
    frame's panoptic map agreeing on >= 99 % of its pixels."""
    cfg, video, cls_emb = tiny_setup()
    cuda_d, cpu_d = tiny_drivers(cfg, cls_emb.shape[0], seed=0)
    things = (1, 3)
    (got, got_info), launches = counted(lambda: cuda_d.run_vps(video, cls_emb, things))
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    want, want_info = cpu_d.run_vps(video, cls_emb, things)
    agree = [float((g == w).mean()) for g, w in zip(got, want)]
    ok = (launched and len(want_info) >= 1 and got_info == want_info
          and got.shape == want.shape and min(agree) >= 0.99)
    emit({"check": "run_vps_tiny_cuda_vs_cpu", "segments_cuda": got_info,
          "segments_cpu": want_info, "kernels_launched": launched,
          "min_frame_agreement": min(agree), "pass": bool(ok)})
    return bool(ok)


def check_launches(path: str, launches: dict, expected: dict) -> bool:
    ok = launches == expected
    emit({"launches": path, "counted": launches, "expected": expected, "pass": ok})
    return ok


def run_op_path(results):
    """The MSDA op's tent entry points at the encoder's shape (30 frames,
    bf16): ``ms_deform_attn(impl='tent-int8')`` and
    ``ms_deform_attn_tent(level_impl='base')`` take kernel D,
    ``ms_deform_attn(impl='tent')`` kernel A; each output finite and
    within its tolerance of the float32 law.  Returns (ok, launches)."""
    import torch

    from univs_tpu_torch.ops import deformable_attention as da
    from univs_tpu_torch.ops import msda_rows

    x = make_inputs(FULL_SHAPES, FULL, MAIN_PATH_FRAMES, torch.bfloat16, seed=99)
    loc = msda_rows.msda_rows_cuda(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], FULL_SHAPES,
                                   x["M"], x["P"])
    sl, aw = rows_to_locations(FULL_SHAPES, loc)
    value = x["value"]

    def drive():
        return (da.ms_deform_attn(value, FULL_SHAPES, sl, aw, impl="tent-int8"),
                da.ms_deform_attn_tent(value, FULL_SHAPES, sl, aw, level_impl="base"),
                da.ms_deform_attn(value, FULL_SHAPES, sl, aw, impl="tent"))

    outs, launches = counted(drive)
    counts_ok = check_launches("ms_deform_attn", launches,
                               expected_launches(msda_tent_base=2, msda_sample=1))
    exact = da.msda_sample_plain(value.float(), FULL_SHAPES, da.locations_to_rows(FULL_SHAPES, sl, aw))
    scale = float(exact.abs().max())
    errs = [float((o.float() - exact).abs().max()) for o in outs]
    out_ok = (all(bool(torch.isfinite(o.float()).all()) and o.shape == exact.shape for o in outs)
              and errs[0] <= 0.05 * scale and max(errs[1:]) <= 1e-2 * scale)
    emit({"path": "ms_deform_attn tent entry points", "frames": MAIN_PATH_FRAMES,
          "f32_law_max_abs": scale, "max_abs_err_tent_int8": errs[0],
          "max_abs_err_tent_base": errs[1], "max_abs_err_tent": errs[2], "outputs_ok": out_ok})
    del x, loc, outs
    torch.cuda.empty_cache()
    return counts_ok and out_ok, launches


def timed_runs(fn, n: int = 3):
    """Host-clock seconds of ``n`` calls, each ending in a synchronise."""
    import torch

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def run_main_path():
    """``EntityDriver.run_vis`` for UniVS-R50 VIS at full width on the card.
    Returns (ok, launches of each kernel in the first timed run, the
    driver)."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.inference.driver import EntityDriver

    cfg = UniVSConfig(dtype="bfloat16")
    (H, W), V, K = FULL_HW, MAIN_PATH_FRAMES, 40
    E = cfg.inference.max_num_instances
    rng = np.random.RandomState(0)
    video = (rng.rand(V, H, W, 3) * 255).astype(np.uint8)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    driver = EntityDriver(cfg, None, num_classes=K, capacity=E, seed=0)
    n_enc = driver.num_window_encodes(V)
    n_clips = sum(1 for _ in driver._iter_clips(V))

    warm_s = timed_runs(lambda: driver.run_vis(video, cls_emb), 1)[0]  # cuDNN plans, allocator
    t0 = time.perf_counter()
    (results, host), launches = counted(lambda: host_times(lambda: driver.run_vis(video, cls_emb)))
    run_s = [time.perf_counter() - t0]
    expected = expected_launches(n_enc, cfg.pixel_decoder.num_layers)
    counts_ok = check_launches("run_vis", launches, expected)
    out_ok = check_results(results, V, H, W, E, K)
    run_s += timed_runs(lambda: driver.run_vis(video, cls_emb), 2)  # the host clock's spread

    # the first 10 frames with the class and consistency gates open, so
    # that entities are admitted and the drain (upsample, threshold,
    # bit-pack on the card) and the host RLE run at full resolution; same
    # model, one run (the host's numpy RLE grows with the runs in each
    # mask, so the frame count bounds this phase)
    relaxed = with_gates_open(cfg)
    open_driver = EntityDriver(relaxed, driver.model, num_classes=K, capacity=E)
    Vo = 10
    t0 = time.perf_counter()
    handle = open_driver.start_vis(video[:Vo], cls_emb)
    open_driver._queue_drain(handle, handle["sizes"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    open_results = open_driver.finish_vis(handle)
    t2 = time.perf_counter()
    out_ok &= len(open_results) > 0 and check_results(open_results, Vo, H, W, E, K)
    gates_open = {"frames": Vo, "entities": len(open_results), "device_s": t1 - t0,
                  "host_assembly_s": t2 - t1,
                  "rle_ms_per_mask": (t2 - t1) * 1e3 / max(1, Vo * len(open_results))}

    stages = vis_stage_times(driver, video, cls_emb)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    emit({"path": "EntityDriver.run_vis", "config": "UniVS-R50 VIS, bf16",
          "frames": V, "height": H, "width": W, "T": driver.T, "stride": driver.stride,
          "window": driver.window, "capacity": E, "classes": K,
          "window_encodes": n_enc, "clips": n_clips, "warmup_s": warm_s, "run_s": run_s,
          "fps": V / run_s[0], "fps_runs": [V / t for t in run_s], **stages,
          "entities": len(results), "host": host,
          "gates_open": gates_open,
          "peak_mem_gb": peak_gb,
          "launches": launches, "launches_expected": expected,
          "launches_ok": counts_ok, "outputs_ok": out_ok})
    emit(profile_run(driver, video, cls_emb, run_s))
    torch.cuda.empty_cache()
    return counts_ok and out_ok, launches, driver


def vis_stage_times(driver, video, cls_emb) -> dict:
    """Stage times outside the counted runs (CUDA events): one window
    encode per frame, split into the backbone (normalisation included)
    and the pixel decoder, and one clip step alone (the video's second
    clip, on an empty pool)."""
    import torch

    from univs_tpu_torch.inference import memory_pool as mp
    from univs_tpu_torch.inference.entity import entity_clip_step
    from univs_tpu_torch.tools import time_ms

    model = driver.model
    (H, W), T, n = video.shape[1:3], driver.T, driver.window
    window = torch.as_tensor(video[:n]).cuda()
    with torch.no_grad():
        encode_ms = time_ms(lambda: driver.encode_window(window), "cuda", iters=3, warmup=1)
        backbone_ms = time_ms(lambda: model.backbone(model.normalize(window)), "cuda", iters=3,
                              warmup=0)
        feats = model.backbone(model.normalize(window))
        pd_ms = time_ms(lambda: model.pixel_decoder(feats), "cuda", iters=3, warmup=0)
        del feats
        mf, ms = driver.encode_window(window)
        clip_feats = (mf[:T], tuple(m[:T] for m in ms))
        E, K = driver.capacity, driver.num_classes
        pool = mp.create_entity_memory(E, K, driver.cfg.decoder.hidden_dim, (H // 4, W // 4),
                                       window=driver.out_window + T,
                                       num_prompt_points=driver.cc.num_dense_points,
                                       embd_history=8, prompt_history=T + driver.stride,
                                       device=driver.device)
        cls_d = cls_emb.to(driver.device)
        entity_clip_step(driver._modules, clip_feats, pool, list(range(T)), 0, True, cls_d,
                         driver.cc)
        clip_ms = time_ms(lambda: entity_clip_step(driver._modules, clip_feats, pool,
                                                   list(range(1, T + 1)), 1, False, cls_d,
                                                   driver.cc), "cuda", iters=10)
    return {"encode_ms_per_frame": encode_ms / n, "backbone_ms_per_frame": backbone_ms / n,
            "pixel_decoder_ms_per_frame": pd_ms / n, "clip_step_ms": clip_ms}


def full_width_video(seed: int):
    """A seeded uint8 video at the full-width size and a seeded VSPW /
    VIPSeg-sized class bank."""
    import torch

    from univs_tpu_torch.config import UniVSConfig

    rng = np.random.RandomState(seed)
    video = (rng.rand(MAIN_PATH_FRAMES, *FULL_HW, 3) * 255).astype(np.uint8)
    dim = UniVSConfig().decoder.clip_cls_emb_dim
    return video, torch.as_tensor(rng.randn(VSPW_CLASSES, dim).astype(np.float32))


def run_vss_path(model):
    """``EntityDriver.run_vss`` (VSPW, K=124) at full width with the VIS
    phase's model: three timed runs after a warm-up; labels [V, H, W]
    int32 in [0, K).  Returns (ok, launches of the first timed run)."""
    import math

    import torch

    from univs_tpu_torch.inference.driver import EntityDriver

    cfg = model.cfg
    (H, W), V, K = FULL_HW, MAIN_PATH_FRAMES, VSPW_CLASSES
    video, cls_emb = full_width_video(1)
    driver = EntityDriver(cfg, model, num_classes=K, capacity=cfg.inference.max_num_instances)
    warm_s = timed_runs(lambda: driver.run_vss(video, cls_emb), 1)[0]
    t0 = time.perf_counter()
    labels, launches = counted(lambda: driver.run_vss(video, cls_emb))
    run_s = [time.perf_counter() - t0]
    encodes = math.ceil(V / driver.T)
    counts_ok = check_launches("run_vss", launches,
                               expected_launches(encodes, cfg.pixel_decoder.num_layers))
    run_s += timed_runs(lambda: driver.run_vss(video, cls_emb), 2)
    out_ok = (labels.shape == (V, H, W) and labels.dtype == np.int32
              and 0 <= int(labels.min()) and int(labels.max()) < K)
    emit({"path": "EntityDriver.run_vss", "config": "UniVS-R50 VSS (VSPW), bf16",
          "frames": V, "height": H, "width": W, "T": driver.T, "classes": K,
          "clip_encodes": encodes, "warmup_s": warm_s, "run_s": run_s,
          "fps_runs": [V / t for t in run_s], "classes_predicted": len(np.unique(labels)),
          "launches": launches, "launches_ok": counts_ok, "outputs_ok": out_ok})
    torch.cuda.empty_cache()
    return counts_ok and out_ok, launches


def vps_split(driver, video, cls_emb):
    """One ``run_vps`` in its two halves: the device stream (clip loop,
    drain, fetch) and the host's panoptic stitching, each timed."""
    import torch

    from univs_tpu_torch.inference.driver import assemble_vps_results, vps_thing_mask

    V, H, W = video.shape[:3]
    t0 = time.perf_counter()
    stream = driver._stream(video, cls_emb, divide=False,
                            thing_mask=vps_thing_mask(VIPSEG_THING_IDS, cls_emb.shape[0]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pan, info = assemble_vps_results(*stream[:4], V, VIPSEG_THING_IDS,
                                     driver.cfg.inference.overlap_threshold, (H, W), (H, W), (H, W))
    t2 = time.perf_counter()
    return pan, info, {"frames": V, "segments": len(info),
                       "pool_entities": int(stream[4].valid.sum()),
                       "device_s": t1 - t0, "host_stitching_s": t2 - t1}


def check_panoptic(pan, info, V, H, W, K) -> bool:
    ids = {r["id"] for r in info}
    return bool(pan.shape == (V, H, W) and pan.dtype == np.int32
                and set(np.unique(pan).tolist()) <= ids | {0}
                and all(1 <= r["category_id"] <= K for r in info))


def stitching_at(entities: int, capacity: int, frames: int, K: int, overlap_thr: float, seed: int):
    """The host stitching (``assemble_vps_results``) alone at full
    resolution on one seeded window of ``capacity`` slots, the first
    ``entities`` valid: each a moving rectangle of raw accumulated logits
    (+3 inside, -3 outside, noise 0.5) at quarter resolution, a class
    drawn from the K (things and stuff), its score 0.9 against 0.1 noise.
    The random weights admit at most one entity, so this is where the
    stitching's cost per entity is read."""
    from univs_tpu_torch.inference.driver import assemble_vps_results

    rng = np.random.RandomState(seed)
    (H, W) = FULL_HW
    h4, w4 = H // 4, W // 4
    yy, xx = np.mgrid[0:h4, 0:w4]
    win = np.full((capacity, frames, h4, w4), -8.0, np.float16)
    for e in range(entities):
        h, w = rng.uniform(0.1, 0.4) * h4, rng.uniform(0.1, 0.4) * w4
        y, x, vy, vx = rng.uniform(0, h4 - h), rng.uniform(0, w4 - w), *rng.uniform(-1, 1, 2)
        for t in range(frames):
            inside = ((yy >= y + vy * t) & (yy < y + vy * t + h)
                      & (xx >= x + vx * t) & (xx < x + vx * t + w))
            win[e, t] = np.where(inside, 3.0, -3.0) + rng.randn(h4, w4) * 0.5
    scores = (rng.rand(capacity, K) * 0.1).astype(np.float32)
    scores[np.arange(entities), rng.randint(0, K, entities)] = 0.9
    valid = np.arange(capacity) < entities
    t0 = time.perf_counter()
    pan, info = assemble_vps_results([win], [0], [scores], [valid], frames, VIPSEG_THING_IDS,
                                     overlap_thr, (H, W), (H, W), (H, W))
    s = time.perf_counter() - t0
    return pan, info, {"entities": entities, "frames": frames, "segments": len(info),
                       "things": sum(r["isthing"] for r in info), "host_stitching_s": s,
                       "ms_per_entity_frame": s * 1e3 / (entities * frames)}


def run_vps_path(model):
    """``EntityDriver.run_vps`` (VIPSeg: K=124, its 58 thing classes, 60
    slots) at full width with the VIS phase's model: three timed runs
    after a warm-up, then one run split into device and host-stitching
    time; the first 10 frames again with the class and consistency gates
    open so that the stitching runs at full resolution on what the
    random weights admit; the stitching alone on seeded windows of 15
    and 60 valid slots.  Returns (ok, launches of the first timed run)."""
    import torch

    from univs_tpu_torch.inference.driver import EntityDriver

    cfg = model.cfg
    (H, W), V, K = FULL_HW, MAIN_PATH_FRAMES, VIPSEG_CLASSES
    E = cfg.inference.max_num_instances
    video, cls_emb = full_width_video(2)
    driver = EntityDriver(cfg, model, num_classes=K, capacity=E)
    n_enc = driver.num_window_encodes(V)
    warm_s = timed_runs(lambda: driver.run_vps(video, cls_emb, VIPSEG_THING_IDS), 1)[0]
    t0 = time.perf_counter()
    (pan, info), launches = counted(lambda: driver.run_vps(video, cls_emb, VIPSEG_THING_IDS))
    run_s = [time.perf_counter() - t0]
    counts_ok = check_launches("run_vps", launches,
                               expected_launches(n_enc, cfg.pixel_decoder.num_layers))
    out_ok = check_panoptic(pan, info, V, H, W, K)
    run_s += timed_runs(lambda: driver.run_vps(video, cls_emb, VIPSEG_THING_IDS), 2)
    _, _, split = vps_split(driver, video, cls_emb)
    rec = {"path": "EntityDriver.run_vps", "config": "UniVS-R50 VPS (VIPSeg), bf16",
           "frames": V, "height": H, "width": W, "T": driver.T, "capacity": E, "classes": K,
           "things": len(VIPSEG_THING_IDS), "window_encodes": n_enc, "warmup_s": warm_s,
           "run_s": run_s, "fps_runs": [V / t for t in run_s], "segments": len(info),
           "split": split, "launches": launches, "launches_ok": counts_ok}
    relaxed = with_gates_open(cfg)
    open_driver = EntityDriver(relaxed, model, num_classes=K, capacity=E)
    Vo = 10
    open_pan, open_info, rec["gates_open"] = vps_split(open_driver, video[:Vo], cls_emb)
    out_ok &= len(open_info) > 0 and check_panoptic(open_pan, open_info, Vo, H, W, K)
    rec["gates_open"]["things"] = sum(r["isthing"] for r in open_info)
    rec["stitching_alone"] = []
    for n_ent in (15, E):
        st_pan, st_info, st = stitching_at(n_ent, E, Vo, K, cfg.inference.overlap_threshold, seed=n_ent)
        out_ok &= len(st_info) > 0 and check_panoptic(st_pan, st_info, Vo, H, W, K)
        rec["stitching_alone"].append(st)
    rec["outputs_ok"] = out_ok
    emit(rec)
    torch.cuda.empty_cache()
    return counts_ok and out_ok, launches


# ---------------------------------------------------------------------------
# prompt-guided paths: VOS / PVOS and RefVOS through VOSDriver
# ---------------------------------------------------------------------------

# DAVIS-17-sized targets: 5 objects, first appearing in the first clip and
# mid-video (injection at frames 0, 3, 11 and 20)
VOS_FAF = (0, 0, 3, 11, 20)
PVOS_OBJECTS = 24
EXPRESSIONS = ("a man in a red shirt riding a bike", "the brown dog running on the left",
               "the second car from the right", "a small white boat near the shore")


def elliptical_targets(faf, V, h4, w4, seed) -> np.ndarray:
    """[N, V, h4, w4] uint8 GT masks at quarter resolution: object n a
    seeded ellipse inside its own cell of a grid (so no two overlap) at
    its first-appearance frame faf[n] (-1: never), zeros elsewhere."""
    import math

    rng = np.random.RandomState(seed)
    N = len(faf)
    cols = math.ceil(math.sqrt(N))
    rows = math.ceil(N / cols)
    ch, cw = h4 / rows, w4 / cols
    yy, xx = np.mgrid[0:h4, 0:w4]
    gt = np.zeros((N, V, h4, w4), np.uint8)
    for n, f in enumerate(faf):
        cy = (n // cols + rng.uniform(0.35, 0.65)) * ch
        cx = (n % cols + rng.uniform(0.35, 0.65)) * cw
        ry, rx = rng.uniform(0.2, 0.35) * ch, rng.uniform(0.2, 0.35) * cw
        if f >= 0:
            gt[n, f] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return gt


class GateCounts:
    """Counts the clip step's decisions over one driver run, by wrapping
    the driver's ``vos_clip_step`` while the ``with`` block runs: objects
    written at their first appearance (``first_ok``), objects accumulated
    through the consistency gate (``gated``) and learn-branch matches
    (``cons_l``), as distinct objects and as (clip, object) pairs.  With
    random weights these may be 0; the record shows it."""

    def __enter__(self):
        from univs_tpu_torch.inference import driver

        self._module, self._step = driver, driver.vos_clip_step
        self.aux = []

        def step(*args, **kwargs):
            pool, aux = self._step(*args, **kwargs)
            self.aux.append(aux)
            return pool, aux

        driver.vos_clip_step = step
        return self

    def __exit__(self, *exc):
        self._module.vos_clip_step = self._step

    def summary(self) -> dict:
        import torch

        out = {"clips": len(self.aux)}
        for key in ("first_ok", "gated", "cons_l"):
            got = [a[key] for a in self.aux if a.get(key) is not None]
            if got:
                st = torch.stack(got)
                out[key] = {"objects": int(st.any(0).sum()), "clip_objects": int(st.sum())}
        return out


def gated_run(fn):
    """(fn's result, its GateCounts summary)."""
    with GateCounts() as g:
        out = fn()
    return out, g.summary()


def check_label_maps(labels, gt, faf, V, H, W):
    """[V, H, W] uint8 maps with labels in [0, N].  Returns (ok, the share
    of each appearing object's GT pixels at its first frame that carry
    its label).  Frame 0 holds nothing but the injected GT (the first
    clip writes only frames after it), so the objects appearing there
    must keep > 90 % of it; later objects compete with the accumulated
    predictions of earlier ones and are only reported."""
    N = len(faf)
    ok = labels.shape == (V, H, W) and labels.dtype == np.uint8 and int(labels.max()) <= N
    up = (H // gt.shape[2], W // gt.shape[3])
    kept = {}
    for n, f in enumerate(faf):
        if f >= 0 and ok:
            inside = np.kron(gt[n, f], np.ones(up, np.uint8)) > 0
            kept[n] = float((labels[f][inside] == n + 1).mean())
            if f == 0:
                ok &= kept[n] > 0.9
    return bool(ok), kept


def clip_step_ms(driver, video, n, cls_emb=None, gt=None, faf=None, text_prompts=None) -> float:
    """One clip step alone (CUDA events): the video's second clip, after
    its first has run.  VOS: GT injected from ``gt`` / ``faf`` as the
    driver does; RefVOS (``text_prompts``): every expression valid from
    frame 0, as ``run_grounding`` sets the pool."""
    import torch

    from univs_tpu_torch.inference import memory_pool as mp
    from univs_tpu_torch.inference.vos import inject_gt_first_appearance, vos_clip_step
    from univs_tpu_torch.tools import time_ms

    (H, W), T = video.shape[1:3], driver.T
    mf, ms = driver.encode_window(torch.as_tensor(video[:driver.window]).cuda())
    pool = driver._new_pool(n, 1, H, W)
    kw = {}
    if text_prompts is not None:
        pool.valid[:] = True
        pool.first_appear[:] = 0
        kw = dict(text_prompts=text_prompts, task="grounding")
    else:
        gt_d = torch.as_tensor(gt).cuda()
        faf_d = torch.as_tensor(np.asarray(faf), dtype=torch.int32, device="cuda")
        ov = torch.ones(n, dtype=torch.bool, device="cuda")
    cls_d = None if cls_emb is None else cls_emb.cuda()
    with torch.no_grad():
        for i in (0, 1):
            frames = list(range(i, i + T))
            feats = (mf[i:i + T], tuple(m[i:i + T] for m in ms))
            if text_prompts is None:
                inject_gt_first_appearance(pool, gt_d[:, frames].float(), faf_d, ov, frames, i)
            if i == 0:
                vos_clip_step(driver._modules, feats, pool, frames, 0, cls_d, driver.cc, **kw)
                mp.shift_clip(pool, driver.stride)
        return time_ms(lambda: vos_clip_step(driver._modules, feats, pool, frames, 1, cls_d,
                                             driver.cc, **kw), "cuda", iters=10)


def run_vos_path(model):
    """``VOSDriver.run`` for UniVS-R50 VOS at full width with the VIS
    phase's model (bf16, 640x960, V=30, T=5, stride 1, window 30): N=5
    DAVIS-17-sized seeded elliptical targets first appearing at frames 0,
    0, 3, 11 and 20; 'prompt' timed (3 runs after a warm-up, the first
    counted), 'learn' and 'prompt+learn' once each, then a PVOS-sized run
    of 24 targets (a warm-up, one timed).  Each run's launches are
    checked (A, B, C 6 each), its label maps and its gate counts printed.
    Returns (ok, launches of the counted 'prompt' run)."""
    import torch

    from univs_tpu_torch.inference.driver import VOSDriver

    cfg = model.cfg
    (H, W), V = FULL_HW, MAIN_PATH_FRAMES
    layers = cfg.pixel_decoder.num_layers
    video, _ = full_width_video(3)
    cls_emb = torch.as_tensor(np.random.RandomState(3).randn(1, cfg.decoder.clip_cls_emb_dim)
                              .astype(np.float32))
    ok = True
    rec = {"path": "VOSDriver.run", "config": "UniVS-R50 VOS (DAVIS-17-sized), bf16",
           "frames": V, "height": H, "width": W}

    def one_mode(mode, faf, seed, timed, warm):
        gt = elliptical_targets(faf, V, H // 4, W // 4, seed)
        ov = np.ones(len(faf), bool)
        driver = VOSDriver(cfg, model, capacity=len(faf), num_classes=1, query_mode=mode)
        run = lambda: driver.run(video, gt, faf, ov, cls_emb)  # noqa: E731
        r = {"query_mode": mode, "objects": len(faf), "first_appear": list(faf),
             "window_encodes": driver.num_window_encodes(V)}
        if warm:
            r["warmup_s"] = timed_runs(run, 1)[0]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (labels, r["gates"]), launches = counted(lambda: gated_run(run))
        r["run_s"] = [time.perf_counter() - t0]
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["launches_ok"] = check_launches(f"run_vos {mode} N={len(faf)}", launches,
                                          expected_launches(r["window_encodes"], layers))
        if timed > 1:
            r["run_s"] += timed_runs(run, timed - 1)
        r["fps_runs"] = [V / t for t in r["run_s"]]
        r["objects_labelled"] = int(len(np.unique(labels)) - (labels == 0).any())
        r["outputs_ok"], r["gt_kept_at_first_frame"] = check_label_maps(labels, gt, faf, V, H, W)
        return r, launches, driver, gt

    r, launches, driver, gt = one_mode("prompt", VOS_FAF, 3, timed=3, warm=True)
    r["clip_step_ms"] = clip_step_ms(driver, video, len(VOS_FAF), cls_emb, gt, VOS_FAF)
    rec["runs"] = [r]
    for mode in ("learn", "prompt+learn"):
        rec["runs"].append(one_mode(mode, VOS_FAF, 3, timed=1, warm=False)[0])
    # PVOS: first appearances spread over the video's clip starts
    pvos_faf = np.sort(np.random.RandomState(4).randint(0, V - driver.T, PVOS_OBJECTS))
    pvos_faf = tuple(int(f) for f in pvos_faf)
    pvos_faf = (0,) + pvos_faf[1:]
    r, _, driver, gt = one_mode("prompt", pvos_faf, 4, timed=1, warm=True)
    r["config"] = "PVOS-sized (24 targets)"
    r["clip_step_ms"] = clip_step_ms(driver, video, PVOS_OBJECTS, cls_emb, gt, pvos_faf)
    rec["runs"].append(r)
    for r in rec["runs"]:
        ok &= r["launches_ok"] and r["outputs_ok"]
    rec["ok"] = bool(ok)
    emit(rec)
    torch.cuda.empty_cache()
    return bool(ok), launches


def run_grounding_path(model):
    """``VOSDriver.run_grounding`` (RefVOS) at full width with the VIS
    phase's model: 4 expressions through ``TextPromptEncoder`` at the
    RN50x4 text geometry in float32 on the card (4 x 81 templates x 77
    tokens, timed alone; the tokenizer's fallback ids, timed apart),
    padded to capacity 4 by ``PrepareTargets.grounding_inputs``; 3 timed
    runs after a warm-up (the first counted, with its peak memory: the
    lang->vision attention holds float32 logits [5, 8, 312, 12600]) and
    one run with the previous clip's visual prompts.  Returns (ok,
    launches of the counted run)."""
    import dataclasses

    import torch

    from univs_tpu_torch.inference.driver import VOSDriver
    from univs_tpu_torch.models.clip_text import ClipTextEncoder, TextPromptEncoder
    from univs_tpu_torch.models.tokenizer import pre_tokenize
    from univs_tpu_torch.prompts.prepare_targets import PrepareTargets
    from univs_tpu_torch.tools import time_ms

    cfg = model.cfg
    (H, W), V = FULL_HW, MAIN_PATH_FRAMES
    layers = cfg.pixel_decoder.num_layers
    video, _ = full_width_video(5)
    n = len(EXPRESSIONS)
    Dt = cfg.decoder.clip_cls_emb_dim  # 640, the RN50x4 tower's embedding
    tpe = TextPromptEncoder(encoder=ClipTextEncoder(embed_dim=Dt), seed=5)
    t0 = time.perf_counter()
    tokens = pre_tokenize(list(EXPRESSIONS), tpe.tokenizer, text_type="expression")
    tokenize_ms = (time.perf_counter() - t0) * 1e3
    text_ms = time_ms(lambda: tpe.encode_tokens(tokens), "cuda", iters=5, warmup=2)
    tp = PrepareTargets(np.zeros((1, 1), np.float32), tpe).grounding_inputs(EXPRESSIONS, pad_to=n)
    rec = {"path": "VOSDriver.run_grounding", "config": "UniVS-R50 RefVOS, bf16; text tower "
           "RN50x4 float32", "frames": V, "height": H, "width": W, "expressions": n,
           "text_tokens": list(tokens.shape), "tokenizer_has_vocab": tpe.tokenizer.has_vocab,
           "tokenize_ms_host": tokenize_ms, "text_encode_ms": text_ms,
           "text_embs": list(tp.embs.shape),
           "text_prompts_distinct": distinct_prompts(tp.embs[0], n)}
    ok = (bool(torch.isfinite(tp.embs).all()) and tuple(tp.embs.shape) == (1, n, 78, Dt)
          and rec["text_prompts_distinct"])

    def check(masks):
        return bool(masks.shape == (n, V, H, W) and masks.dtype == np.uint8 and masks.max() <= 1)

    driver = VOSDriver(cfg, model, capacity=n, num_classes=1)
    run = lambda d: d.run_grounding(video, tp.embs, tp.valid, n_expressions=n)  # noqa: E731
    rec["window_encodes"] = driver.num_window_encodes(V)
    rec["warmup_s"] = timed_runs(lambda: run(driver), 1)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (masks, rec["gates"]), launches = counted(lambda: gated_run(lambda: run(driver)))
    rec["run_s"] = [time.perf_counter() - t0]
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ok &= check_launches("run_grounding", launches, expected_launches(rec["window_encodes"], layers))
    rec["run_s"] += timed_runs(lambda: run(driver), 2)
    rec["fps_runs"] = [V / t for t in rec["run_s"]]
    rec["clip_step_ms"] = clip_step_ms(driver, video, n, text_prompts=tp)
    rec["mask_fraction"] = masks.reshape(n, -1).mean(-1).tolist()
    ok &= check(masks)

    prev_cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, enabled_prev_visual_prompts_for_grounding=True))
    prev = VOSDriver(prev_cfg, model, capacity=n, num_classes=1)
    t0 = time.perf_counter()
    (masks_prev, gates_prev), launches_prev = counted(lambda: gated_run(lambda: run(prev)))
    prev_rec = {"run_s": time.perf_counter() - t0, "gates": gates_prev,
                "mask_fraction": masks_prev.reshape(n, -1).mean(-1).tolist()}
    prev_rec["launches_ok"] = check_launches("run_grounding prev visual prompts", launches_prev,
                                             expected_launches(rec["window_encodes"], layers))
    ok &= prev_rec["launches_ok"] and check(masks_prev)
    rec["prev_visual_prompts"] = prev_rec
    rec["ok"] = bool(ok)
    emit(rec)
    del tpe
    torch.cuda.empty_cache()
    return bool(ok), launches


def tiny_vos_setup():
    """The tiny config for the prompt-guided driver (T=2, stride 1, a
    6-frame window), a seeded 8-frame 64x96 video, GT for three objects
    first appearing at frames 0, 0 and 3 and one that never appears."""
    import dataclasses

    from univs_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg = dataclasses.replace(
        cfg, inference=dataclasses.replace(cfg.inference, num_frames=2, clip_stride=1,
                                           num_frames_window=6),
        prompt=dataclasses.replace(cfg.prompt, num_prev_frames_memory=3))
    V, H, W = 8, 64, 96
    video = np.random.RandomState(8).randint(0, 256, (V, H, W, 3)).astype(np.uint8)
    faf = (0, 0, 3, -1)
    return cfg, video, faf, elliptical_targets(faf, V, H // 4, W // 4, seed=8)


def min_iou(a_masks, b_masks) -> float:
    """Smallest IoU over paired binary masks (1 where both are empty)."""
    out = 1.0
    for a, b in zip(a_masks, b_masks):
        union = int((a | b).sum())
        out = min(out, float((a & b).sum() / union) if union else 1.0)
    return out


def reference_check_vos() -> bool:
    """``VOSDriver.run`` on the tiny config in float32, card (through the
    kernels) vs CPU (plain laws), same seeded weights, video and GT: the
    same objects labelled, each object's mask on each frame with IoU >=
    0.99."""
    from univs_tpu_torch.inference.driver import VOSDriver

    cfg, video, faf, gt = tiny_vos_setup()
    cls_emb = np.random.RandomState(9).randn(1, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    ov = np.ones(len(faf), bool)
    outs = {}
    for dev in ("cuda", "cpu"):
        d = VOSDriver(cfg, None, capacity=len(faf), num_classes=1, query_mode="prompt+learn",
                      device=dev, seed=4)
        if dev == "cuda":
            outs[dev], launches = counted(lambda: d.run(video, gt, faf, ov, cls_emb))
        else:
            outs[dev] = d.run(video, gt, faf, ov, cls_emb)
    got, want = outs["cuda"], outs["cpu"]
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    objs = sorted(set(np.unique(want).tolist()) - {0})
    iou = min(min_iou([g == o for g in got], [w == o for w in want]) for o in range(1, len(faf) + 1))
    ok = (launched and objs == sorted(set(np.unique(got).tolist()) - {0}) and len(objs) >= 1
          and iou >= 0.99)
    emit({"check": "run_vos_tiny_cuda_vs_cpu", "objects_cpu": objs,
          "objects_cuda": sorted(set(np.unique(got).tolist()) - {0}), "kernels_launched": launched,
          "min_mask_iou": iou, "pass": bool(ok)})
    return bool(ok)


def distinct_prompts(embs, n: int) -> bool:
    """The first ``n`` prompt rows of ``embs`` [capacity, 1 + 77, D]
    ([sentence; words]) are non-zero and pairwise different, so the
    driver gets ``n`` real expressions rather than copies of one."""
    import torch

    rows = embs[:n].flatten(1)
    return bool(rows.abs().amax(1).gt(0).all()) and all(
        not torch.equal(rows[a], rows[b]) for a in range(n) for b in range(a))


def reference_check_grounding() -> bool:
    """``VOSDriver.run_grounding`` on the tiny config in float32, card vs
    CPU: two expressions tokenized once (the fallback ids hold within one
    process) and encoded by the same seeded tiny text tower on each side,
    padded to capacity 3; the same expressions segmented, each mask on
    each frame with IoU >= 0.99."""
    import torch

    from univs_tpu_torch.inference.driver import VOSDriver
    from univs_tpu_torch.models.clip_text import ClipTextEncoder, TextPromptEncoder
    from univs_tpu_torch.models.tokenizer import pre_tokenize

    cfg, video, _, _ = tiny_vos_setup()
    Dt = cfg.decoder.clip_cls_emb_dim
    tokens = None
    outs, emb_err = {}, None
    for dev in ("cuda", "cpu"):
        tpe = TextPromptEncoder(encoder=ClipTextEncoder(embed_dim=Dt, width=32, heads=4,
                                                        num_layers=2), device=dev, seed=6)
        if tokens is None:
            tokens = pre_tokenize(list(EXPRESSIONS[:2]), tpe.tokenizer, text_type="expression")
        word, eot = tpe.encode_tokens(tokens)
        embs = torch.cat([eot.mean(1)[:, None], word[:, 0]], dim=1)  # [sentence; words]
        embs = torch.cat([embs, torch.zeros_like(embs[:1])])[None]  # padded to 3
        valid = torch.tensor([[True, True, False]])
        d = VOSDriver(cfg, None, capacity=3, num_classes=1, device=dev, seed=4)
        if dev == "cuda":
            cuda_embs = embs.cpu()
            distinct = distinct_prompts(embs[0], 2)
            outs[dev], launches = counted(lambda: d.run_grounding(video, embs, valid,
                                                                  n_expressions=2))
        else:
            emb_err = float((cuda_embs - embs).abs().max())
            outs[dev] = d.run_grounding(video, embs, valid, n_expressions=2)
    got, want = outs["cuda"], outs["cpu"]
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    iou = min(min_iou(g.astype(bool), w.astype(bool)) for g, w in zip(got, want))
    ok = (launched and distinct and got.shape == want.shape and bool(want.any())
          and emb_err <= 1e-4 and iou >= 0.99)
    emit({"check": "run_grounding_tiny_cuda_vs_cpu", "expressions": 2,
          "text_prompts_distinct": distinct, "text_embs_max_abs_err": emb_err,
          "kernels_launched": launched,
          "mask_fraction_cpu": want.reshape(2, -1).mean(-1).tolist(), "min_mask_iou": iou,
          "pass": bool(ok)})
    return bool(ok)


# ---------------------------------------------------------------------------
# the other backbones, the VL pixel decoder, the fast and image drivers
# ---------------------------------------------------------------------------

# Mask2Former's Swin-L configs (maskformer2_swin_large_IN21k_384_bs16_100ep.yaml:
# WINDOW_SIZE 12, PRETRAIN_IMG_SIZE 384), on which UniVS's Swin-L configs build
SWIN_L = dict(name="swin_large", swin_window_size=12)
# COCO panoptic: 133 categories, the 80 things first in contiguous order
COCO_PANOPTIC_CLASSES, COCO_THINGS = 133, 80
# the MDQE tracker keeps every frame's 1/4-resolution logits of every
# instance on the host: one window rollover fits in this many frames
MDQE_FRAMES = 15


def backbone_vis_path(backbone: dict, label: str, timed: int, profile: bool = False):
    """``EntityDriver.run_vis`` at full width (default UniVSConfig, bf16,
    640x960, T=5, stride 1, 60 slots, K=40, the 30-frame seeded video of
    the R50 headline) over another backbone with seeded random weights: a
    warm-up, then ``timed`` runs (the first counted, with its peak
    device memory and the host time of its parts), the encode split into backbone and pixel decoder and
    one clip step alone; with ``profile``, one more run and one window's
    backbone under the profiler.  Returns (ok, launches of the counted
    run)."""
    import torch

    from univs_tpu_torch.config import BackboneConfig, UniVSConfig
    from univs_tpu_torch.inference.driver import EntityDriver

    cfg = UniVSConfig(dtype="bfloat16", backbone=BackboneConfig(**backbone))
    (H, W), V, K = FULL_HW, MAIN_PATH_FRAMES, 40
    E = cfg.inference.max_num_instances
    rng = np.random.RandomState(0)
    video = (rng.rand(V, H, W, 3) * 255).astype(np.uint8)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    t0 = time.perf_counter()
    driver = EntityDriver(cfg, None, num_classes=K, capacity=E, seed=0)
    build_s = time.perf_counter() - t0
    n_enc = driver.num_window_encodes(V)
    warm_s = timed_runs(lambda: driver.run_vis(video, cls_emb), 1)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (results, host), launches = counted(lambda: host_times(lambda: driver.run_vis(video, cls_emb)))
    run_s = [time.perf_counter() - t0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_launches(n_enc, cfg.pixel_decoder.num_layers)
    counts_ok = check_launches(f"run_vis {label}", launches, expected)
    out_ok = check_results(results, V, H, W, E, K)
    if timed > 1:
        run_s += timed_runs(lambda: driver.run_vis(video, cls_emb), timed - 1)
    stages = vis_stage_times(driver, video, cls_emb)
    n_params = sum(p.numel() for p in driver.model.backbone.parameters())
    emit({"path": f"EntityDriver.run_vis {label}", "config": f"UniVS {label} VIS, bf16",
          "backbone": backbone, "backbone_params": n_params,
          "backbone_channels": driver.model.backbone.out_channels,
          "frames": V, "height": H, "width": W, "T": driver.T, "stride": driver.stride,
          "capacity": E, "classes": K, "window_encodes": n_enc, "build_s": build_s,
          "warmup_s": warm_s, "run_s": run_s, "fps_runs": [V / t for t in run_s], **stages,
          "backbone_share_of_encode": stages["backbone_ms_per_frame"]
          / (stages["backbone_ms_per_frame"] + stages["pixel_decoder_ms_per_frame"]),
          "entities": len(results), "host": host, "peak_mem_gb": peak_gb,
          "launches": launches, "launches_expected": expected, "launches_ok": counts_ok,
          "outputs_ok": out_ok})
    if profile:
        model = driver.model
        window = torch.as_tensor(video[:driver.window]).cuda()
        emit(profile_run(driver, video, cls_emb, run_s, f"run_vis {label}"))
        with torch.no_grad():
            emit(profile_call(f"backbone {label}, one window",
                              lambda: model.backbone(model.normalize(window))))
        del model, window
    del driver
    torch.cuda.empty_cache()
    return counts_ok and out_ok, launches


def run_swin_path():
    return backbone_vis_path(SWIN_L, "Swin-L (window 12)", timed=3, profile=True)


def run_pvt_path():
    return backbone_vis_path(dict(name="pvt_v2_b2"), "PVTv2-b2 (linear SRA)", timed=1)


def language_features(expression: str, device="cuda"):
    """[1, 77, 640] word features of one expression from the seeded RN50x4
    text tower (template '{}.'), and its [1, 77] validity (token id != 0:
    the padding after the end token is invalid)."""
    import torch

    from univs_tpu_torch.models.clip_text import ClipTextEncoder, TextPromptEncoder
    from univs_tpu_torch.models.tokenizer import pre_tokenize

    tpe = TextPromptEncoder(encoder=ClipTextEncoder(embed_dim=640), seed=5, device=device)
    tokens = pre_tokenize([expression], tpe.tokenizer, text_type="expression")[:, :1]
    word, _ = tpe.encode_tokens(tokens)
    return word[:, 0], torch.as_tensor(tokens[:, 0] != 0, device=device)


def vl_decoder(channels, geo: dict, lang_dim: int, seed: int, dtype: str, device):
    """A seeded ``MSDeformAttnPixelDecoderVL`` placed as the model builders
    place a model (``dtype`` "bfloat16" keeps its LayerNorms and gammas
    float32)."""
    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.models.pixel_decoder_vl import MSDeformAttnPixelDecoderVL
    from univs_tpu_torch.models.univs import _place
    from univs_tpu_torch.utils.weights import init_params

    pd = MSDeformAttnPixelDecoderVL(channels, lang_dim=lang_dim, **geo)
    init_params(pd, seed)
    return _place(pd, UniVSConfig(dtype=dtype), device)


def run_vl_decoder_path(model):
    """``MSDeformAttnPixelDecoderVL`` at full width (C=256, 8 heads, 4
    points, FFN 1024, 6 layers, VLFuse embed 1024, language width 640),
    bf16, seeded: the R50 features of a 30-frame window from the VIS
    phase's model, and the word features [1, 77, 640] of one expression
    from the seeded RN50x4 text tower with ``lang_valid`` False on the
    padding.  One counted call (A, B, C 6 each), the ms per window (CUDA
    events), outputs finite and of the expected shapes.  No driver builds
    this module, so it is driven as a module.  Returns (ok, launches)."""
    import torch

    from univs_tpu_torch.tools import time_ms

    cfg = model.cfg
    (H, W), V = FULL_HW, MAIN_PATH_FRAMES
    c = cfg.pixel_decoder
    geo = dict(hidden_dim=c.hidden_dim, mask_dim=c.mask_dim, num_layers=c.num_layers,
               num_heads=c.num_heads, num_points=c.num_points, ffn_dim=c.ffn_dim)
    lang, lang_valid = language_features(EXPRESSIONS[0])
    pd = vl_decoder(model.backbone.out_channels, geo, 640, 7, "bfloat16", "cuda")
    video, _ = full_width_video(6)
    with torch.no_grad():
        feats = model.backbone(model.normalize(torch.as_tensor(video).cuda()))
        outs, launches = counted(lambda: pd(feats, lang, lang_valid))
        ms_window = time_ms(lambda: pd(feats, lang, lang_valid), "cuda", iters=3, warmup=1)
        plain_ms = time_ms(lambda: model.pixel_decoder(feats), "cuda", iters=3, warmup=1)
        prof = profile_call("MSDeformAttnPixelDecoderVL, one window",
                            lambda: pd(feats, lang, lang_valid))
    mf, mf_bfe, enc, ms, lang_out = outs
    shapes_ok = (tuple(mf.shape) == (V, H // 4, W // 4, c.mask_dim)
                 and tuple(mf_bfe.shape) == (V, H // 4, W // 4, c.hidden_dim)
                 and tuple(enc.shape) == (V, H // 32, W // 32, c.hidden_dim)
                 and [tuple(m.shape[1:3]) for m in ms] == [(H // 32, W // 32), (H // 16, W // 16),
                                                           (H // 8, W // 8)]
                 and tuple(lang_out.shape) == (V, *lang.shape[1:]))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (mf, mf_bfe, enc, lang_out, *ms))
    counts_ok = check_launches("MSDeformAttnPixelDecoderVL", launches,
                               expected_launches(1, c.num_layers))
    ok = counts_ok and shapes_ok and finite
    emit({"path": "MSDeformAttnPixelDecoderVL", "config": "UniVS-R50 features, RN50x4 words, bf16",
          "frames": V, "height": H, "width": W, "lang_tokens_valid": int(lang_valid.sum()),
          "ms_per_window": ms_window, "pixel_decoder_ms_per_window": plain_ms,
          "launches": launches, "shapes_ok": shapes_ok, "finite": finite, "ok": ok})
    emit(prof)
    del pd, feats, outs
    torch.cuda.empty_cache()
    return ok, launches


def run_fast_paths(model):
    """Item 13's drivers at full width on the VIS phase's R50 model (bf16,
    640x960, T=5): a warm-up of ``FastVISDriver.run``, then one run each
    of ``FastVISDriver.run`` (K=40), ``MDQEVISDriver.run`` (K=40, the
    first MDQE_FRAMES frames: every clip of stride 1, one window
    rollover), ``FastVPSDriver.run_vps`` (VIPSeg, K=124, its 58 things),
    ``SemanticExtractionDriver.run`` + ``semantic_features_to_masks`` and
    ``ImageDriver.run`` on one frame (COCO panoptic, K=133) +
    ``panoptic_inference``.  Each re-encodes per clip: A, B and C at 6 x
    clips (6 for the image).  Returns (ok, {path: launches})."""
    import math

    import torch

    from univs_tpu_torch.inference import fast_vis, image

    cfg = model.cfg
    (H, W), V = FULL_HW, MAIN_PATH_FRAMES
    layers = cfg.pixel_decoder.num_layers
    video, bank124 = full_width_video(8)
    rng = np.random.RandomState(8)
    bank40 = bank124[:40]
    bank133 = torch.as_tensor(rng.randn(COCO_PANOPTIC_CLASSES, cfg.decoder.clip_cls_emb_dim)
                              .astype(np.float32))
    ok, by_path = True, {}

    def one(name, clips, fn, check):
        nonlocal ok
        t0 = time.perf_counter()
        out, launches = counted(fn)
        s = time.perf_counter() - t0
        rec = {"path": name, "frames": 1 if name.startswith("Image") else V, "run_s": s,
               "clips": clips, "launches": launches}
        rec["launches_ok"] = check_launches(name, launches, expected_launches(clips, layers))
        rec.update(check(out))
        ok &= rec["launches_ok"] and rec["outputs_ok"]
        by_path[name] = launches
        return rec, out

    fast = fast_vis.FastVISDriver(cfg, model)
    warm_s = timed_runs(lambda: fast.run(video, bank40), 1)[0]

    def check_fast(res):
        good = len(res) == min(10, cfg.decoder.num_queries) and all(r["mask_logits"].shape == (V, H // 4, W // 4)
                                      and np.isfinite(r["mask_logits"]).all() for r in res)
        return {"instances": len(res), "categories": [r["category_id"] for r in res],
                "outputs_ok": bool(good)}

    rec, _ = one("FastVISDriver.run", math.ceil(V / fast.T), lambda: fast.run(video, bank40),
                 check_fast)
    rec["warmup_s"] = warm_s
    rec["fps"] = V / rec["run_s"]
    emit(rec)

    mdqe = fast_vis.MDQEVISDriver(cfg, model)
    Vm = MDQE_FRAMES

    def check_mdqe(res):
        good = len(res) >= 1 and all(
            sorted(r["masks"]) == list(range(Vm)) and np.isfinite(r["score"]).all()
            and all(m.shape == (H // 4, W // 4) for m in r["masks"].values()) for r in res)
        return {"tracks": len(res), "outputs_ok": bool(good)}

    rec, _ = one("MDQEVISDriver.run", math.ceil(Vm / cfg.inference.clip_stride),
                 lambda: mdqe.run(video[:Vm], bank40), check_mdqe)
    rec["frames"] = Vm
    rec["fps"] = Vm / rec["run_s"]
    emit(rec)

    vps = fast_vis.FastVPSDriver(cfg, model)

    def check_vps(out):
        pan, info = out
        ids = {r["id"] for r in info}
        good = (pan.shape == (V, H // 4, W // 4) and set(np.unique(pan).tolist()) <= ids | {0}
                and all(1 <= r["category_id"] <= VIPSEG_CLASSES for r in info))
        return {"segments": len(info), "things": sum(r["isthing"] for r in info),
                "outputs_ok": bool(good)}

    rec, _ = one("FastVPSDriver.run_vps", math.ceil(V / vps.T),
                 lambda: vps.run_vps(video, bank124, VIPSEG_THING_IDS), check_vps)
    rec["fps"] = V / rec["run_s"]
    emit(rec)

    ext = fast_vis.SemanticExtractionDriver(cfg, model)
    Q, C = cfg.decoder.num_queries, cfg.decoder.hidden_dim

    def check_ext(out):
        toks, mfs = out
        good = (toks.shape == (V, C, Q) and mfs.shape == (V, H // 32, W // 32, cfg.pixel_decoder.mask_dim)
                and np.isfinite(toks).all() and np.isfinite(mfs).all())
        return {"tokens": list(toks.shape), "mask_features": list(mfs.shape),
                "outputs_ok": bool(good)}

    rec, (toks, mfs) = one("SemanticExtractionDriver.run", math.ceil(V / ext.T),
                           lambda: ext.run(video, bank40), check_ext)
    rec["fps"] = V / rec["run_s"]
    t0 = time.perf_counter()
    full = fast_vis.semantic_features_to_masks(cfg, model, toks, mfs, bank40,
                                               only_high_conf_masks=False)
    kept = fast_vis.semantic_features_to_masks(cfg, model, toks, mfs, bank40)
    rec["to_masks_s"] = time.perf_counter() - t0
    to_ok = (full[0].shape == (Q, V, 40) and full[1].shape == (Q, V, H // 32, W // 32)
             and np.isfinite(full[0]).all() and np.isfinite(full[1]).all()
             and set(kept[2].tolist()) <= set(range(Q)))
    rec["to_masks"] = {"cls_logits": list(full[0].shape), "mask_logits": list(full[1].shape),
                       "kept_high_conf": len(kept[2]), "outputs_ok": bool(to_ok)}
    ok &= bool(to_ok)
    emit(rec)

    img = image.ImageDriver(cfg, model, num_classes=COCO_PANOPTIC_CLASSES)
    frame = video[:1].astype(np.float32)
    things = set(range(COCO_THINGS))
    img.run(frame, bank133, (H, W), (H, W))  # warm-up: the prompt-query decoder shapes

    def check_img(out):
        mask_cls, mask_pred = out
        Qi = cfg.decoder.num_queries + COCO_PANOPTIC_CLASSES
        good = (mask_cls.shape == (Qi, COCO_PANOPTIC_CLASSES) and mask_pred.shape == (Qi, H, W)
                and np.isfinite(mask_cls).all() and np.isfinite(mask_pred).all())
        return {"queries": Qi, "outputs_ok": bool(good)}

    rec, (mask_cls, mask_pred) = one("ImageDriver.run", 1,
                                     lambda: img.run(frame, bank133, (H, W), (H, W)), check_img)
    rec["ms"] = rec["run_s"] * 1e3
    t0 = time.perf_counter()
    pan, info = image.panoptic_inference(mask_cls, mask_pred, cfg.decoder.num_queries, things)
    rec["panoptic_inference_s"] = time.perf_counter() - t0
    pan_ok = pan.shape == (H, W) and set(np.unique(pan).tolist()) <= {r["id"] for r in info} | {0}
    rec["panoptic"] = {"segments": len(info), "things": sum(r["isthing"] for r in info),
                       "outputs_ok": bool(pan_ok)}
    ok &= bool(pan_ok)
    emit(rec)
    del fast, mdqe, vps, ext, img
    torch.cuda.empty_cache()
    return bool(ok), by_path


def reference_check_backbone(name: str) -> bool:
    """``run_vis`` on the tiny config over ``name`` (swin_tiny, window 7:
    every stage map of a 64x96 frame needs padding; pvt_v2_b0 with the
    linear SRA) in float32, card vs CPU, as ``reference_check``."""
    from univs_tpu_torch.config import BackboneConfig

    cfg = tiny_setup()[0]
    return reference_check(cfg.replace(backbone=BackboneConfig(name=name)), f"run_vis_tiny_{name}")


def reference_check_vl_decoder() -> bool:
    """``MSDeformAttnPixelDecoderVL`` at the tiny geometry (C=32, 4 heads,
    2 points, FFN 64, 2 layers, language width 16) in float32 with the
    same seeded weights on the card (through the kernels) and the CPU
    (plain laws), on seeded R50-shaped features of 2 frames and 7
    language tokens, the last 2 invalid: all five outputs within 1e-3 of
    each output's largest magnitude."""
    import torch

    geo = dict(hidden_dim=32, mask_dim=32, num_layers=2, num_heads=4, num_points=2, ffn_dim=64)
    ch = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}
    rng = np.random.RandomState(12)
    feats = {k: torch.as_tensor(rng.randn(2, 64 // s, 96 // s, c).astype(np.float32))
             for (k, c), s in zip(ch.items(), (4, 8, 16, 32))}
    lang = torch.as_tensor(rng.randn(1, 7, 16).astype(np.float32))
    valid = torch.tensor([[True] * 5 + [False] * 2])
    outs = {}
    for dev in ("cuda", "cpu"):
        pd = vl_decoder(ch, geo, 16, 13, "float32", dev)
        args = ({k: v.to(dev) for k, v in feats.items()}, lang.to(dev), valid.to(dev))
        with torch.no_grad():
            if dev == "cuda":
                outs[dev], launches = counted(lambda: pd(*args))
            else:
                outs[dev] = pd(*args)
    flat = {d: [o[0], o[1], o[2], *o[3], o[4]] for d, o in outs.items()}
    rel = max(float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
              for g, w in zip(flat["cuda"], flat["cpu"]))
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    ok = launched and rel <= 1e-3
    emit({"check": "vl_pixel_decoder_tiny_cuda_vs_cpu", "outputs": len(flat["cpu"]),
          "kernels_launched": launched, "max_rel_err": rel, "pass": bool(ok)})
    return bool(ok)


def reference_check_fast_vis() -> bool:
    """``FastVISDriver.run`` on the tiny config in float32, card vs CPU,
    same seeded weights and video: the same instances in the same order
    and categories, each frame's mask (logit > 0) with IoU >= 0.99."""
    from univs_tpu_torch.inference.fast_vis import FastVISDriver

    cfg, video, cls_emb = tiny_setup()
    outs = {}
    for dev in ("cuda", "cpu"):
        d = FastVISDriver(cfg, None, device=dev, seed=3)
        if dev == "cuda":
            outs[dev], launches = counted(lambda: d.run(video, cls_emb, topk=4))
        else:
            outs[dev] = d.run(video, cls_emb, topk=4)
    got, want = outs["cuda"], outs["cpu"]
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    cats = [r["category_id"] for r in want]
    iou = min(min_iou(g["mask_logits"] > 0, w["mask_logits"] > 0) for g, w in zip(got, want))
    ok = launched and cats == [r["category_id"] for r in got] and len(want) == 4 and iou >= 0.99
    emit({"check": "fast_vis_tiny_cuda_vs_cpu", "categories_cpu": cats,
          "categories_cuda": [r["category_id"] for r in got], "kernels_launched": launched,
          "min_mask_iou": iou, "pass": bool(ok)})
    return bool(ok)


def reference_check_image() -> bool:
    """``ImageDriver.run`` on the tiny config in float32, card vs CPU, one
    seeded 64x96 frame, things {0, 2} of 5 classes (weights of seed 5:
    two segments): class scores x quality within 1e-3, the same panoptic
    segments, the maps agreeing on >= 99 % of their pixels."""
    from univs_tpu_torch.inference.image import ImageDriver, panoptic_inference

    cfg, video, cls_emb = tiny_setup()
    frame = video[:1].astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        d = ImageDriver(cfg, None, num_classes=cls_emb.shape[0], device=dev, seed=5)
        if dev == "cuda":
            outs[dev], launches = counted(lambda: d.run(frame, cls_emb, (64, 96), (64, 96)))
        else:
            outs[dev] = d.run(frame, cls_emb, (64, 96), (64, 96))
    nq = cfg.decoder.num_queries
    (g_cls, g_pred), (w_cls, w_pred) = outs["cuda"], outs["cpu"]
    g_pan, g_info = panoptic_inference(g_cls, g_pred, nq, {0, 2})
    w_pan, w_info = panoptic_inference(w_cls, w_pred, nq, {0, 2})
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    cls_err = float(np.abs(g_cls - w_cls).max())
    agree = float((g_pan == w_pan).mean())
    ok = launched and cls_err <= 1e-3 and g_info == w_info and len(w_info) >= 1 and agree >= 0.99
    emit({"check": "image_tiny_cuda_vs_cpu", "segments_cuda": g_info, "segments_cpu": w_info,
          "kernels_launched": launched, "max_score_abs_err": cls_err,
          "panoptic_agreement": agree, "pass": bool(ok)})
    return bool(ok)


# ---------------------------------------------------------------------------
# training: gradients of A, B and C, the train step at full width, and
# the tiny train step on the card against the CPU
# ---------------------------------------------------------------------------

# the training canvas: LSJ 1024x1024 (the reference's mapper), levels at
# 1/32, 1/16, 1/8
TRAIN_HW = 1024
TRAIN_SHAPES = ((32, 32), (64, 64), (128, 128))
# gradient tolerances against autograd of the plain law (both backward
# passes are the plain law's; only the order of the gather backward's
# atomic adds differs): float32 1e-5, bfloat16 one rounding, 1e-2, of
# each gradient's largest magnitude
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the training batch's frames: B = 2 clips x T = 2
TRAIN_FRAMES = 4


def grad_checks() -> bool:
    """Each of A, B and C as its ``torch.autograd.Function`` (the kernel
    forward, the plain law's vector-Jacobian product backward) against
    the plain law, at the full-width encoder shape of the training batch
    (4 frames at 1024x1024), float32 and bfloat16: the kernel's forward
    within ``TOL`` of the plain law's (the train path's only forward of
    these kernels), every input's gradient within ``GRAD_TOL`` of
    ``torch.autograd.grad`` of the plain law, relative to its scale, and
    in its input's dtype."""
    import torch

    from univs_tpu_torch.ops import deformable_attention as da
    from univs_tpu_torch.ops import fused_mlp, msda_rows

    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        x = make_inputs(TRAIN_SHAPES, FULL, TRAIN_FRAMES, dtype, seed=4321)
        M, P = x["M"], x["P"]
        leaf = lambda t: t.detach().clone().requires_grad_(True)
        ff = x["ffn"]
        loc0 = msda_rows.msda_rows_plain(x["q"], x["wo"], x["bo"], x["wa"], x["ba"], TRAIN_SHAPES,
                                         M, P).detach()
        cases = {
            "msda_rows": ((x["q"], x["wo"], x["bo"], x["wa"], x["ba"]),
                          lambda a: msda_rows.msda_rows(*a, TRAIN_SHAPES, M, P),
                          lambda a: msda_rows.msda_rows_plain(*a, TRAIN_SHAPES, M, P)),
            "msda_sample": ((x["value"], loc0),
                            lambda a: da.msda_sample(a[0], TRAIN_SHAPES, a[1]),
                            lambda a: da.msda_sample_plain(a[0], TRAIN_SHAPES, a[1])),
            "fused_ffn_ln": ((x["src"], x["attn"], *(ff[k] for k in
                                                      ("g1", "c1", "w1", "b1", "w2", "b2", "g2", "c2"))),
                             lambda a: fused_mlp.fused_ffn_ln(*a),
                             lambda a: fused_mlp.fused_ffn_ln_plain(*a)),
        }
        for name, (inputs, fn, plain) in cases.items():
            a = [leaf(t) for t in inputs]
            out = fn(a)
            g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(out)
            got = torch.autograd.grad(out, a, g)
            b = [leaf(t) for t in inputs]
            want_out = plain(b)
            want = torch.autograd.grad(want_out, b, g)
            fwd = compare(name, out.detach(), want_out.detach(), dtype)
            ok &= fwd["pass"]
            errs, scales = [], []
            for gg, ww, t in zip(got, want, inputs):
                scale = float(ww.float().abs().max())
                errs.append(float((gg.float() - ww.float()).abs().max()))
                scales.append(scale)
                ok_i = gg.dtype == t.dtype and errs[-1] <= GRAD_TOL[str(dtype)[6:]] * max(scale, 1e-30)
                ok &= bool(ok_i)
            rec_ok = all(e <= GRAD_TOL[str(dtype)[6:]] * max(s, 1e-30) for e, s in zip(errs, scales))
            emit({"check": f"{name} forward and gradient", "dtype": str(dtype)[6:],
                  "frames": TRAIN_FRAMES, "height": TRAIN_HW, "width": TRAIN_HW,
                  "forward": fwd, "inputs": len(inputs),
                  "max_abs_err": errs, "grad_scale": scales, "tol": GRAD_TOL[str(dtype)[6:]],
                  "dtypes_ok": all(gg.dtype == t.dtype for gg, t in zip(got, inputs)),
                  "pass": bool(rec_ok and fwd["pass"])})
            del a, b, got, want, out, want_out
        del x, loc0
        torch.cuda.empty_cache()
    return bool(ok)


def full_train_batch(cfg, task: str, seed: int, B: int = 2, n_valid: int = 8,
                     expressions: int = 8):
    """A seeded training batch at the reference's stage-2 shape: B clips of
    T frames of ``synth_blob_video`` on the 1024x1024 canvas, 40 instance
    slots of which ``n_valid`` hold seeded ellipses (GT masks at 1/4,
    moving a few pixels a frame) with seeded labels of the 3938-class
    bank, collated by ``collate_train_batch`` (40 detection prompt slots,
    the negatives drawn by the loader); grounding adds ``expressions``
    seeded [1 + 77, 640] expression stacks bound to the first targets."""
    import torch

    from univs_tpu_torch.data.loader import collate_train_batch
    from univs_tpu_torch.utils.synth import synth_blob_video

    rng = np.random.RandomState(seed)
    T, S, N = cfg.num_frames, TRAIN_HW, cfg.prompt.num_max_instances
    h4 = S // 4
    K, Dt = cfg.decoder.num_classes, cfg.decoder.clip_cls_emb_dim
    bank = rng.randn(K, Dt).astype(np.float32)
    yy, xx = np.mgrid[0:h4, 0:h4]
    samples = []
    for b in range(B):
        masks = np.zeros((N, T, h4, h4), np.float32)
        valid = np.zeros(N, bool)
        valid[:n_valid] = True
        for n in range(n_valid):
            cy, cx = rng.uniform(40, h4 - 40, 2)
            ry, rx = rng.uniform(8, 40, 2)
            vy, vx = rng.uniform(-4, 4, 2)
            for t in range(T):
                masks[n, t] = (((yy - cy - vy * t) / ry) ** 2 + ((xx - cx - vx * t) / rx) ** 2) <= 1
        ids = np.where(valid[:, None], np.arange(N)[:, None], -1).repeat(T, 1).astype(np.int32)
        labels = np.where(valid, rng.randint(1, K + 1, N), 0).astype(np.int32)
        samples.append(dict(images=synth_blob_video(T, S, S, seed=seed * 100 + b),
                            frame_indices=np.arange(T, dtype=np.int32), labels=labels, ids=ids,
                            masks=masks, valid=valid))
    batch = collate_train_batch(samples, bank, np.ones(K, bool), N)
    if task == "grounding":
        Qe = expressions
        batch.exp_embs = torch.as_tensor(rng.randn(B, Qe, 78, Dt).astype(np.float32))
        batch.exp_valid = torch.ones((B, Qe), dtype=torch.bool)
        batch.targets.prompt_obj_ids = torch.arange(Qe)[None].expand(B, Qe).clone()
    return batch


class ForwardLaunches:
    """Launch counts inside the model's forward calls while the ``with``
    block runs (forward pre-hook / hook on the model): the launches
    outside them are the criterion's, the backward's and the optimizer's."""

    def __init__(self, model):
        self.model, self.counts = model, {}

    def __enter__(self):
        from univs_tpu_torch.ops import kernels

        def pre(*_):
            self._before = kernels.launch_counts()

        def post(*_):
            after = kernels.launch_counts()
            for k in after:
                self.counts[k] = self.counts.get(k, 0) + after[k] - self._before[k]

        self._h = [self.model.register_forward_pre_hook(pre), self.model.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self._h:
            h.remove()


def run_train_path():
    """The UniVS-R50 train step at full width on the card: bf16 compute
    over float32 masters, deep supervision, 12,544 points, B=2 clips of
    T=2 frames at 1024x1024, 40 instance slots, a seeded [3938, 640]
    category bank; detection 1 warm-up + 5 timed steps, sot and grounding
    1 + 2 each, one model and state through the three tasks.  Per task:
    step ms split into forward (criterion included), backward, gradient
    upcast and optimizer (CUDA events), host JV seconds a step, peak
    memory, every logged loss (finite), the launches of the timed steps in the forward
    and outside it; a profile of one more detection step (device busy ms,
    top kernels, the idle share over the unprofiled steps' wall time).
    Returns (ok, {path: launches})."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.losses import criterion as crit_mod
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel.train_state import EVENTS, create_train_state, make_train_step
    from univs_tpu_torch.utils.draws import make_key

    cfg = UniVSConfig(dtype="bfloat16")
    masters = seeded_masters(cfg)
    model = build_model(cfg, masters, device="cuda")
    state = create_train_state(cfg, model, masters)
    del masters
    key = make_key(2024)  # on the card, as every entry point
    ok, by_path = True, {}
    for task, timed in (("detection", 5), ("sot", 2), ("grounding", 2)):
        batch = full_train_batch(cfg, task, seed=11).to("cuda")
        timings: dict = {}
        step = make_train_step(cfg, model, task, timings=timings)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, logged = step(state, batch, key)  # warm-up: cuDNN plans, allocator
        warm_s = time.perf_counter() - t0
        timings.clear()
        t0 = time.perf_counter()
        with HostTime(crit_mod, "hungarian_batch") as jv, ForwardLaunches(model) as fwd:
            (state, logged), launches = counted(lambda: [step(state, batch, key)
                                                         for _ in range(timed)][-1])
        wall_s = (time.perf_counter() - t0) / timed
        losses = {k: float(v) for k, v in logged.items()}
        finite = all(np.isfinite(v) for v in losses.values())
        outside = {k: launches[k] - fwd.counts.get(k, 0) for k in launches}
        expected = expected_launches(timed, cfg.pixel_decoder.num_layers)
        counts_ok = (launches == expected and fwd.counts == expected
                     and not any(outside.values()))
        split = {k: timings.get(k, 0.0) / timed for k in EVENTS}
        emit({"path": f"train {task}", "config": "UniVS-R50, bf16 over float32 masters",
              "clips": batch.images.shape[0], "frames": cfg.num_frames, "height": TRAIN_HW,
              "width": TRAIN_HW, "instance_slots": batch.targets.valid.shape[1],
              "prompt_slots": int(batch.targets.prompt_obj_ids.shape[1]) if task != "sot"
              else batch.targets.valid.shape[1],
              "points": cfg.train.num_points, "supervised_layers": cfg.decoder.num_layers + 1,
              "warmup_s": warm_s, "timed_steps": timed,
              "step_ms": sum(split.values()), **split, "step_wall_ms": wall_s * 1e3,
              "host_jv_s_per_step": jv.s / timed, "jv_calls": jv.calls,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "losses": losses, "losses_finite": finite, "step": state.step,
              "launches": launches, "launches_forward": fwd.counts,
              "launches_outside_forward": outside, "launches_expected": expected,
              "launches_ok": counts_ok})
        ok &= finite and counts_ok
        by_path[f"train {task}"] = launches
        if task == "detection":  # one more step under the profiler
            prof = profile_call("train detection step", lambda: step(state, batch, key))
            if "device_busy_ms" in prof:
                prof["device_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"] / (wall_s * 1e3))
            emit(prof)
        del batch
        torch.cuda.empty_cache()
    del model, state
    torch.cuda.empty_cache()
    return bool(ok), by_path


# the tiny train step, card against CPU: float32 on both sides with
# cuDNN's TF32 off, the same draws; the kernels' forward sums in another
# order than the plain laws and cuDNN's convolutions than the CPU's ->
# each logged loss within 1e-3 of its magnitude (at least 1e-3)
TINY_TRAIN_TOL = 1e-3


def reference_check_train() -> bool:
    """One train step of each task (detection, sot, grounding) at the tiny
    training config (depth-10 ResNet, one encoder and one decoder layer,
    64x64 clips) on the card and on the CPU from the same weights, batch
    and draws: every logged loss within ``TINY_TRAIN_TOL`` and every
    layer's Hungarian assignment identical."""
    import dataclasses

    import torch

    from univs_tpu_torch.config import TrainConfig, tiny_test_config
    from univs_tpu_torch.losses.criterion import TrainTargets
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel.train_state import (TrainBatch, create_train_state,
                                                      make_train_step)
    from univs_tpu_torch.utils.draws import make_key

    base = tiny_test_config()
    cfg = base.replace(train=TrainConfig(num_points=32, oversample_ratio=2.0),
                       backbone=dataclasses.replace(base.backbone, resnet_depth=10),
                       decoder=dataclasses.replace(base.decoder, num_layers=1),
                       pixel_decoder=dataclasses.replace(base.pixel_decoder, num_layers=1))
    rng = np.random.RandomState(5)
    B, T, S, N, K = 2, 2, 64, 3, 4
    Dt = cfg.decoder.clip_cls_emb_dim
    bank = torch.as_tensor(rng.randn(K, Dt).astype(np.float32))
    labels = torch.as_tensor(rng.randint(1, K + 1, (B, N)))
    poi = torch.arange(N)[None].expand(B, N).clone()
    targets = TrainTargets(labels=labels, ids=poi[:, :, None].expand(B, N, T).clone(),
                           masks=torch.as_tensor((rng.rand(B, N, T, S // 4, S // 4) > 0.7)
                                                 .astype(np.float32)),
                           valid=torch.ones((B, N), dtype=torch.bool), prompt_obj_ids=poi)
    batch = TrainBatch(images=torch.as_tensor((rng.rand(B, T, S, S, 3) * 255).astype(np.float32)),
                       frame_indices=torch.arange(T)[None].expand(B, T).clone(), targets=targets,
                       prompt_category_embs=bank[labels - 1],
                       prompt_category_valid=torch.ones((B, N), dtype=torch.bool),
                       category_bank=bank, category_bank_valid=torch.ones(K, dtype=torch.bool),
                       exp_embs=torch.as_tensor(rng.randn(B, N, 8, Dt).astype(np.float32)),
                       exp_valid=torch.ones((B, N), dtype=torch.bool))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    ok = True
    try:
        for task in ("detection", "sot", "grounding"):
            res = {}
            for dev in ("cuda", "cpu"):
                model = build_model(cfg, None, seed=9, device=dev)
                state = create_train_state(cfg, model)
                step = make_train_step(cfg, model, task)
                # the same draws on both sides: made on the CPU, moved by the step
                key = make_key(3, device="cpu")
                if dev == "cuda":
                    (_, logged), launches = counted(lambda: step(state, batch.to(dev), key))
                else:
                    _, logged = step(state, batch.to(dev), key)
                res[dev] = ({k: float(v) for k, v in logged.items()},
                            step.criterion.last_matches.cpu().numpy())
            (lc, mc), (lp, mp_) = res["cuda"], res["cpu"]
            errs = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1.0) for k in lp}
            same = bool(np.array_equal(mc, mp_))
            launched = all(launches[k] == cfg.pixel_decoder.num_layers for k in ENCODER_KERNELS)
            task_ok = (set(lc) == set(lp) and max(errs.values()) <= TINY_TRAIN_TOL and same
                       and launched)
            emit({"check": f"train_step_tiny_{task}_cuda_vs_cpu", "losses": len(lp),
                  "max_rel_loss_err": max(errs.values()), "tol": TINY_TRAIN_TOL,
                  "total_loss_cuda": lc["total_loss"], "total_loss_cpu": lp["total_loss"],
                  "matches_identical": same, "kernels_launched": launched, "pass": bool(task_ok)})
            ok &= task_ok
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return bool(ok)


# ---------------------------------------------------------------------------
# the rest of training: BoxVIS with its EMA teacher, the stage-3 long-video
# loss, activation checkpointing, data parallelism
# ---------------------------------------------------------------------------

# the stage-3 geometry: a 7-frame sample in clips of 3 (clip_starts(7, 3)
# = [0, 2, 4]), one video (the reference's stage-3 batch)
LONG_VIDEO_FRAMES, LONG_VIDEO_CLIP = 7, 3
# checkpointing recomputes the forward exactly (the losses must agree bit
# for bit); the float32 master gradients (the working bf16 gradients
# upcast) differ as two runs of one step do: the gather backward's atomic
# adds and the order in which a parameter's uses accumulate its bf16
# gradient.  Each label group's gradient within one bf16 rounding of its
# norm, 1e-2 (a tensor whose gradient is rounding noise, as the attention
# key biases', may differ wholly: it is held by its group's norm)
REMAT_GRAD_TOL = 1e-2
# data parallelism on the card against the one-process step, bf16 over
# float32 masters: a rank encodes one video where the one-process step
# encodes two, so cuDNN picks other algorithms (it picks them by batch
# size) and the bf16 activations round otherwise, and the global gradient is the float32 sum of the ranks' bf16 gradients.  The
# logged losses within the bf16 tolerance (GRAD_TOL["bfloat16"], 1e-2 of
# each loss, at least 1), the global float32 gradient (Adam's first moment
# after the step) within DDP_GRAD_TOL of each label group's norm, each
# parameter's update within two Adam steps (a gradient near its rounding
# noise may take the other sign: lr each way), and each group's update
# within DDP_UPDATE_TOL of its norm
DDP_GRAD_TOL = 2e-2
DDP_UPDATE_TOL = 0.1
DDP_WORLD = 2


def group_rel_err(got: dict, ref: dict, labels: dict, base: dict = None) -> dict:
    """Per label group: ||got - ref|| / ||ref - base|| over the group's
    tensors (base None: ||ref||)."""
    out = {}
    for g in sorted(set(labels.values())):
        names = [k for k in ref if labels[k] == g]
        d = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in names)
        n = sum(float(((ref[k] - (0 if base is None else base[k])) ** 2).sum()) for k in names)
        out[g] = (d / max(n, 1e-30)) ** 0.5
    return out


def seeded_masters(cfg, seed: int = 0) -> dict:
    """The float32 state_dict of the port's seeded init of ``cfg``'s model."""
    from univs_tpu_torch.models.univs import UniVSModel
    from univs_tpu_torch.utils import weights

    f32 = UniVSModel(cfg)
    weights.init_params(f32, seed=seed)
    return {k: v.clone() for k, v in f32.state_dict().items()}


def box_region_masks(masks):
    """[..., h, w] masks -> the box-region masks BoxVIS trains on: each
    mask's bounding rectangle filled (empty masks stay empty)."""
    import torch

    from univs_tpu_torch.ops.mask_ops import masks_to_boxes

    h, w = masks.shape[-2:]
    x0, y0, x1, y1 = masks_to_boxes(masks).unbind(-1)
    ys = torch.arange(h, dtype=torch.float32)
    xs = torch.arange(w, dtype=torch.float32)
    rows = (ys >= y0[..., None]) & (ys < y1[..., None])
    cols = (xs >= x0[..., None]) & (xs < x1[..., None])
    return (rows[..., :, None] & cols[..., None, :]).to(masks.dtype)


def train_losses_record(logged) -> tuple:
    losses = {k: float(v) for k, v in logged.items()}
    return losses, all(np.isfinite(v) for v in losses.values())


def run_boxvis_path():
    """The UniVS-R50 BoxVIS detection step with its EMA teacher at full
    width (bf16 over float32 masters, the train path's batch with each
    ellipse replaced by its bounding rectangle, ``pseudo_score_thresh`` 0
    so the gated pseudo BCE + dice runs on random weights): 1 warm-up and
    2 timed steps, step ms split into teacher forward, student forward
    (criterion included), backward, gradient upcast and optimizer, peak
    memory, every loss finite (``loss_mask_proj`` and the pseudo
    ``loss_mask`` / ``loss_dice`` among them), the targets that passed
    the gate, A/B/C at 12 a step (6 in the student's forward, 6 in the
    teacher's).  Returns (ok, launches of the timed steps)."""
    import dataclasses

    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel import train_state as tts
    from univs_tpu_torch.utils.draws import make_key

    cfg = UniVSConfig(dtype="bfloat16")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, boxvis_enabled=True,
                                                boxvis_ema_enabled=True, pseudo_score_thresh=0.0))
    masters = seeded_masters(cfg)
    model = build_model(cfg, masters, device="cuda")
    state = tts.create_train_state(cfg, model, masters)
    del masters
    batch = full_train_batch(cfg, "detection", seed=11)
    batch.targets.masks = box_region_masks(batch.targets.masks)
    batch = batch.to("cuda")
    timings: dict = {}
    step = tts.make_train_step(cfg, model, "detection", timings=timings)
    key = make_key(2024)
    gated = []
    teacher_law = tts.boxvis_teacher_pseudo_masks

    def spy(*args):
        pm, scores = teacher_law(*args)
        gated.append(int(((scores > cfg.train.pseudo_score_thresh) & args[3].valid).sum()))
        return pm, scores

    tts.boxvis_teacher_pseudo_masks = spy
    try:
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch, key)  # warm-up
        timings.clear()
        timed = 2
        with ForwardLaunches(model) as fwd, ForwardLaunches(step.teacher) as tea:
            (state, logged), launches = counted(lambda: [step(state, batch, key)
                                                         for _ in range(timed)][-1])
    finally:
        tts.boxvis_teacher_pseudo_masks = teacher_law
    losses, finite = train_losses_record(logged)
    layers = cfg.pixel_decoder.num_layers
    expected = expected_launches(2 * timed, layers)
    counts_ok = (launches == expected and fwd.counts == expected_launches(timed, layers)
                 and tea.counts == expected_launches(timed, layers))
    names_ok = all(k in losses for k in ("loss_mask_proj", "loss_mask", "loss_dice"))
    split = {k: timings.get(k, 0.0) / timed for k in tts.EVENTS}
    emit({"path": "train boxvis", "config": "UniVS-R50 BoxVIS + EMA teacher, bf16 over float32 "
          "masters", "clips": batch.images.shape[0], "frames": cfg.num_frames,
          "height": TRAIN_HW, "width": TRAIN_HW, "instance_slots": batch.targets.valid.shape[1],
          "targets": int(batch.targets.valid.sum()), "pseudo_score_thresh": 0.0,
          "targets_through_gate": gated, "timed_steps": timed, "step_ms": sum(split.values()),
          **split, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses,
          "losses_finite": finite, "boxvis_losses_present": names_ok, "launches": launches,
          "launches_student_forward": fwd.counts, "launches_teacher_forward": tea.counts,
          "launches_expected": expected, "launches_ok": counts_ok})
    del model, state, step, batch
    torch.cuda.empty_cache()
    return bool(finite and counts_ok and names_ok), launches


def run_long_video_path():
    """``long_video_loss`` (stage 3) for UniVS-R50 at full width: one seeded
    video of 7 frames on the 1024x1024 canvas in clips of 3 (starts 0, 2,
    4), 40 instance slots of which 8 hold ellipses, bf16 over float32
    masters; 1 warm-up and 2 timed forward + backward passes: forward and
    backward ms, peak memory, every clip's losses and the inter-clip terms
    finite, A/B/C at 6 x 2 encodes x 3 clips = 36 a pass.  Returns (ok,
    launches of the timed passes)."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.losses.criterion import UniCriterion
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel.long_video import clip_starts, long_video_loss
    from univs_tpu_torch.parallel.train_state import create_train_state
    from univs_tpu_torch.utils.draws import make_key

    cfg = UniVSConfig(dtype="bfloat16", num_frames=LONG_VIDEO_CLIP)
    masters = seeded_masters(cfg)
    model = build_model(cfg, masters, device="cuda")
    create_train_state(cfg, model, masters)  # trainable, as in a train step
    del masters
    batch = full_train_batch(cfg.replace(num_frames=LONG_VIDEO_FRAMES), "sot", seed=13,
                             B=1).to("cuda")
    criterion = UniCriterion(cfg.train, cfg.decoder.num_queries, cfg.num_frames)
    key = make_key(2025)
    starts = clip_starts(LONG_VIDEO_FRAMES, LONG_VIDEO_CLIP)

    def one_pass():
        for p in model.parameters():
            p.grad = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        total, logged = long_video_loss(model, criterion, batch.images, batch.frame_indices,
                                        batch.targets, cfg, key)
        ev[1].record()
        total.backward()
        ev[2].record()
        torch.cuda.synchronize()
        return total.detach(), logged, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    torch.cuda.reset_peak_memory_stats()
    one_pass()  # warm-up
    timed = 2
    runs, launches = counted(lambda: [one_pass() for _ in range(timed)])
    total, logged = runs[-1][:2]
    losses, finite = train_losses_record(logged)
    finite &= bool(torch.isfinite(total))
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                       if p.grad is not None)
    expected = expected_launches(2 * len(starts) * timed, cfg.pixel_decoder.num_layers)
    counts_ok = launches == expected
    inter = {k: v for k, v in losses.items() if "interclip" in k}
    emit({"path": "train long_video", "config": "UniVS-R50 stage 3, bf16 over float32 masters",
          "videos": 1, "frames_video": LONG_VIDEO_FRAMES, "frames_clip": LONG_VIDEO_CLIP,
          "clip_starts": starts, "height": TRAIN_HW, "width": TRAIN_HW,
          "instance_slots": batch.targets.valid.shape[1],
          "targets": int(batch.targets.valid.sum()), "timed_passes": timed,
          "forward_ms": [r[2] for r in runs], "backward_ms": [r[3] for r in runs],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "total_loss": float(total),
          "clip_losses": {k: v for k, v in losses.items() if k.startswith("clip")},
          "interclip": inter, "losses_finite": finite, "grads_finite": grads_finite,
          "launches": launches, "launches_expected": expected, "launches_ok": counts_ok})
    del model, batch
    torch.cuda.empty_cache()
    return bool(finite and grads_finite and counts_ok and len(inter) >= 2), launches


def remat_comparison(label: str, cfg, on: dict, masters):
    """One detection step at B=2 x T=2 (1024x1024) of ``cfg`` without and
    with the checkpointing switches ``on`` (``{"backbone": {...},
    "decoder": {...}}`` config fields), from the same masters and key:
    per run the step ms split (its second step, after the first one's
    plans), peak memory and launches; the first step's logged losses equal
    bit for bit and its float32 master gradients (the working gradients
    upcast) within ``REMAT_GRAD_TOL``.  Returns (ok, launches of the
    checkpointed run's timed step)."""
    import dataclasses

    import torch

    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel import train_state as tts
    from univs_tpu_torch.utils.draws import make_key

    batch = full_train_batch(cfg, "detection", seed=11).to("cuda")
    res = {}
    for name in ("plain", "checkpointed"):
        c = cfg
        if name == "checkpointed":
            c = cfg.replace(**{part: dataclasses.replace(getattr(cfg, part), **fields)
                               for part, fields in on.items()})
        model = build_model(c, masters, device="cuda")
        state = tts.create_train_state(c, model, masters)
        timings: dict = {}
        step = tts.make_train_step(c, model, "detection", timings=timings)
        key = make_key(2024)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, logged = step(state, batch, key)
        grads = {k: p.grad.float().cpu() for k, p in model.named_parameters() if p.grad is not None}
        timings.clear()
        with ForwardLaunches(model) as fwd:
            _, launches = counted(lambda: step(state, batch, key))
        expected = expected_launches(1, c.pixel_decoder.num_layers)
        res[name] = dict(losses=train_losses_record(logged), grads=grads, launches=launches,
                         fwd=fwd.counts, expected=expected,
                         split={k: timings.get(k, 0.0) for k in tts.EVENTS},
                         peak=torch.cuda.max_memory_allocated() / 1e9)
        del model, state, step
        torch.cuda.empty_cache()
    p, r = res["plain"], res["checkpointed"]
    same_losses = p["losses"][0] == r["losses"][0]
    labels = {k: "backbone" if k.startswith("backbone.") else "rest" for k in p["grads"]}
    grads_ok = set(p["grads"]) == set(r["grads"])
    errs = group_rel_err(r["grads"], p["grads"], labels) if grads_ok else {}
    grads_ok &= all(e <= REMAT_GRAD_TOL for e in errs.values())
    exact = sum(torch.equal(r["grads"][k], g) for k, g in p["grads"].items())
    counts_ok = all(x["launches"] == x["expected"] == x["fwd"] for x in (p, r))
    finite = p["losses"][1] and r["losses"][1]
    emit({"path": f"train {label} checkpointing", "switches": on, "clips": 2,
          "frames": cfg.num_frames, "height": TRAIN_HW, "width": TRAIN_HW,
          "step_ms": {n: sum(x["split"].values()) for n, x in res.items()},
          "split_ms": {n: x["split"] for n, x in res.items()},
          "peak_mem_gb": {n: x["peak"] for n, x in res.items()},
          "losses_bit_identical": same_losses, "total_loss": p["losses"][0]["total_loss"],
          "losses_finite": finite, "grad_rel_err": errs, "grads_exact": exact,
          "grads": len(p["grads"]), "grad_tol": REMAT_GRAD_TOL, "launches": {n: x["launches"] for n, x in res.items()},
          "launches_forward": {n: x["fwd"] for n, x in res.items()},
          "launches_ok": counts_ok})
    del batch, res
    torch.cuda.empty_cache()
    return bool(same_losses and grads_ok and counts_ok and finite), r["launches"]


def run_remat_paths():
    """Activation checkpointing at full width: UniVS Swin-L (window 12)
    with and without ``swin_use_checkpoint`` + ``remat_heads``, and R50
    with and without ``remat_heads`` (``remat_comparison``).  Returns
    (ok, {path: launches})."""
    from univs_tpu_torch.config import BackboneConfig, UniVSConfig

    ok, by_path = True, {}
    swin_cfg = UniVSConfig(dtype="bfloat16", backbone=BackboneConfig(**SWIN_L))
    r50_cfg = UniVSConfig(dtype="bfloat16")
    for label, cfg, on in (
            ("swin_large", swin_cfg, {"backbone": {"swin_use_checkpoint": True},
                                      "decoder": {"remat_heads": True}}),
            ("r50", r50_cfg, {"decoder": {"remat_heads": True}})):
        masters = seeded_masters(cfg)
        path_ok, by_path[f"train {label} checkpointed"] = remat_comparison(label, cfg, on, masters)
        ok &= path_ok
        del masters
    return bool(ok), by_path


def _ddp_worker(rank, backend, port, out_dir):
    """One rank of the data-parallel check: the R50 detection step on its
    video of the B=2 batch, from the seeded masters and the same key as
    the one-process step; writes its losses, first moment, params,
    launches and the second step's ms split to ``out_dir``."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.ops import kernels
    from univs_tpu_torch.parallel import ddp
    from univs_tpu_torch.parallel.train_state import EVENTS, create_train_state
    from univs_tpu_torch.utils.draws import make_key

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    ddp.init_distributed(backend, f"tcp://127.0.0.1:{port}", rank, DDP_WORLD)
    try:
        cfg = UniVSConfig(dtype="bfloat16")
        masters = seeded_masters(cfg)
        model = build_model(cfg, masters, device=dev)
        state = create_train_state(cfg, model, masters)
        del masters
        batch = ddp.shard_batch(full_train_batch(cfg, "detection", seed=11), rank,
                                DDP_WORLD).to(dev)
        timings: dict = {}
        step = ddp.make_train_step(cfg, model, "detection", timings=timings)
        key = make_key(2024, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        state, logged = step(state, batch, key)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        out = {"losses": {k: float(v) for k, v in logged.items()},
               "mu": {k: v.cpu() for k, v in state.mu.items()},
               "params": {k: v.cpu() for k, v in state.params.items()},
               "launches": launches, "videos": batch.images.shape[0]}
        timings.clear()
        step(state, batch, key)
        out["split_ms"] = {k: timings.get(k, 0.0) for k in EVENTS}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ddp_path(backend: str):
    """Data parallelism at full width: the one-process UniVS-R50 detection
    step on the train path's B=2 batch, then a world of 2 processes (gloo over
    cuda:0 twice, or NCCL over cuda:0 and cuda:1), each on its one video
    from the same masters and key: every rank's logged losses against the
    one-process step's, the global float32 gradient (Adam's first moment)
    and the parameters after the step within their tolerances, A/B/C 6 a
    rank, the step and all-reduce ms of a second step.  The kernels are
    built by the caller, so the ranks only load them.  Returns (ok,
    launches summed over the ranks)."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.parallel.train_state import (create_train_state, make_train_step,
                                                      param_groups)
    from univs_tpu_torch.utils.draws import make_key

    cfg = UniVSConfig(dtype="bfloat16")
    masters = seeded_masters(cfg)
    model = build_model(cfg, masters, device="cuda")
    state = create_train_state(cfg, model, masters)
    labels, _ = param_groups(model)
    step = make_train_step(cfg, model, "detection")
    batch = full_train_batch(cfg, "detection", seed=11).to("cuda")
    state, logged = step(state, batch, make_key(2024))
    want = {"losses": {k: float(v) for k, v in logged.items()},
            "mu": {k: v.cpu() for k, v in state.mu.items()},
            "params": {k: v.cpu() for k, v in state.params.items()}}
    init = {k: v.float() for k, v in masters.items() if k in want["params"]}
    del model, state, step, batch, masters
    torch.cuda.empty_cache()

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ddp_check")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(_ddp_worker, args=(backend, _free_port(), out_dir), nprocs=DDP_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(DDP_WORLD)]
    shutil.rmtree(out_dir, ignore_errors=True)

    lr = cfg.train.lr
    loss_tol = GRAD_TOL["bfloat16"]
    same_names = all(set(r["losses"]) == set(want["losses"]) for r in ranks)
    loss_errs = sorted(((abs(r["losses"][k] - v) / max(abs(v), 1.0), k)
                        for r in ranks for k, v in want["losses"].items()), reverse=True)
    loss_err = loss_errs[0][0]
    grad_err = [group_rel_err(r["mu"], want["mu"], labels) for r in ranks]
    update_err = [group_rel_err(r["params"], want["params"], labels, init) for r in ranks]
    param_max = max(float((r["params"][k] - v).abs().max())
                    for r in ranks for k, v in want["params"].items())
    ranks_equal = all(torch.equal(ranks[0]["params"][k], r["params"][k])
                      for r in ranks[1:] for k in want["params"])
    expected = expected_launches(1, cfg.pixel_decoder.num_layers)
    counts_ok = all(r["launches"] == expected for r in ranks)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in expected}
    ok = (same_names and loss_err <= loss_tol
          and all(e <= DDP_GRAD_TOL for ge in grad_err for e in ge.values())
          and all(e <= DDP_UPDATE_TOL for ue in update_err for e in ue.values())
          and param_max <= 2 * lr * 1.01 and ranks_equal and counts_ok)
    note = ("two processes on ONE card over gloo: this checks the data-parallel code path "
            "and says nothing about scaling" if backend == "gloo" else
            "NCCL over two cards")
    emit({"path": f"train ddp {backend}", "note": note, "world": DDP_WORLD,
          "videos_per_rank": [r["videos"] for r in ranks], "height": TRAIN_HW, "width": TRAIN_HW,
          "frames": cfg.num_frames, "spawn_s": spawn_s,
          "step_ms": [sum(r["split_ms"].values()) for r in ranks],
          "split_ms": [r["split_ms"] for r in ranks],
          "allreduce_ms": [r["split_ms"]["allreduce_ms"] for r in ranks],
          "max_rel_loss_err": loss_err, "worst_losses": [[k, e] for e, k in loss_errs[:3]],
          "loss_tol": loss_tol,
          "total_loss": [r["losses"]["total_loss"] for r in ranks],
          "total_loss_one_process": want["losses"]["total_loss"],
          "grad_rel_err": grad_err, "grad_tol": DDP_GRAD_TOL,
          "update_rel_err": update_err, "update_tol": DDP_UPDATE_TOL,
          "param_max_abs_err": param_max, "param_tol": 2 * lr, "ranks_identical": ranks_equal,
          "launches_per_rank": [r["launches"] for r in ranks], "launches_ok": counts_ok,
          "pass": bool(ok)})
    return bool(ok), launches


def run_dtype_reading(model_bf16):
    """A reading, not a gate: ``run_vis`` (K=40) and ``run_vps`` (VIPSeg)
    on the first 10 frames with the class and consistency gates open, the
    seeded R50 weights in float32 and in bfloat16: kept entities, the RLE
    IoU of the entities both keep, and the panoptic segments and pixel
    agreement.  JAX keeps masks in the compute dtype too, so a difference
    is a finding, not a fault.  Returns (ok: the launches and outputs
    well formed, launches)."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.models.univs import build_model

    (H, W), Vo, K = FULL_HW, 10, 40
    rng = np.random.RandomState(0)
    video = (rng.rand(Vo, H, W, 3) * 255).astype(np.uint8)
    cls_emb = torch.as_tensor(rng.randn(K, UniVSConfig().decoder.clip_cls_emb_dim)
                              .astype(np.float32))
    vps_video, vps_emb = full_width_video(2)
    vps_video = vps_video[:Vo]
    out, ok, total = {}, True, None
    for dtype in ("float32", "bfloat16"):
        cfg = with_gates_open(UniVSConfig(dtype=dtype))
        model = model_bf16 if dtype == "bfloat16" else build_model(cfg, None, seed=0,
                                                                   device="cuda")
        E = cfg.inference.max_num_instances
        drv = EntityDriver(cfg, model, num_classes=K, capacity=E)
        vis, launches = counted(lambda: drv.run_vis(video, cls_emb))
        pan_drv = EntityDriver(cfg, model, num_classes=VIPSEG_CLASSES, capacity=E)
        (pan, info), l2 = counted(lambda: pan_drv.run_vps(vps_video, vps_emb, VIPSEG_THING_IDS))
        want = expected_launches(drv.num_window_encodes(Vo) + pan_drv.num_window_encodes(Vo),
                                 cfg.pixel_decoder.num_layers)
        both = {k: launches[k] + l2[k] for k in launches}
        ok &= both == want and check_results(vis, Vo, H, W, E, K)
        ok &= check_panoptic(pan, info, Vo, H, W, VIPSEG_CLASSES)
        total = both if total is None else {k: total[k] + both[k] for k in both}
        out[dtype] = dict(vis=vis, pan=np.asarray(pan), info=info)
        if dtype == "float32":
            del model
        torch.cuda.empty_cache()
    f, b = out["float32"], out["bfloat16"]
    ids_f, ids_b = {r["obj_id"] for r in f["vis"]}, {r["obj_id"] for r in b["vis"]}
    emit({"reading": "bf16 against float32 decisions", "gate": False, "frames": Vo,
          "height": H, "width": W, "vis_entities": {"float32": len(f["vis"]),
                                                    "bfloat16": len(b["vis"])},
          "vis_entities_both": len(ids_f & ids_b),
          "vis_rles_identical": same_rles(b["vis"], f["vis"]),
          "vis_rle_iou_min_mean": rle_iou(b["vis"], f["vis"]),
          "vps_segments": {"float32": len(f["info"]), "bfloat16": len(b["info"])},
          "vps_things": {d: sum(r["isthing"] for r in out[d]["info"]) for d in out},
          "vps_pixel_agreement": float((f["pan"] == b["pan"]).mean()),
          "launches_ok": bool(ok)})
    return bool(ok), total


# ---------------------------------------------------------------------------
# serving: the batched server and two-device pipelining
# ---------------------------------------------------------------------------

SERVE_LENGTHS = (30, 25)
# the pipelined video spans two windows, so the next window's encode is
# issued ahead of the clip steps
PIPELINE_FRAMES = 45


def same_rles(got, want) -> bool:
    return ([r["obj_id"] for r in got] == [r["obj_id"] for r in want]
            and all(g["segmentations"] == w["segmentations"] for g, w in zip(got, want)))


def rle_iou(got, want):
    """min and mean mask IoU over the entity-frames of the entities both
    result lists hold (by obj_id); None when they share none."""
    from univs_tpu_torch.utils import rle

    by_id = {r["obj_id"]: r for r in want}
    ious = []
    for g in got:
        w = by_id.get(g["obj_id"])
        for a, b in zip(g["segmentations"], w["segmentations"] if w else []):
            ma, mb = rle.decode(a).astype(bool), rle.decode(b).astype(bool)
            union = int((ma | mb).sum())
            ious.append(int((ma & mb).sum()) / union if union else 1.0)
    return [min(ious), float(np.mean(ious))] if ious else None


def with_gates_open(cfg):
    """The config with the class and consistency gates open, so that
    seeded weights admit entities and the emission, the drain (upsample,
    threshold, bit-pack) and the host RLE run."""
    import dataclasses

    return dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, apply_cls_thres=0.0, consistency_thres=(-1.0, 0.5)))


def run_serving_path(model):
    """``BatchedVISServer`` for UniVS-R50 VIS at full width (bf16, 640x960,
    batch 2, capacity 40, K=40, T=5, stride 1, window 30) on two seeded
    videos of 30 and 25 frames, timed after a warm-up (videos/s,
    aggregate FPS), peak memory, A/B/C at 6 x batched window encodes.
    The same batch with the backbone folded over both videos (the encode
    before the per-video backbone) timed beside it.  Then with the gates
    open, against ``EntityDriver.run_vis`` with the same model: the (30,
    25) batch's longer video identical, and both videos of a second batch
    of equal length (30, 30) identical (the batched window encode's
    difference from each video's lone encode printed), each video with
    at least one entity; the 25-frame video's results cut to its length.
    (A shorter video's padded clips still update its pool, the JAX
    server's documented deviation: its equality with the driver is
    printed, not required; the CPU tests hold it to the JAX server.)
    Returns (ok, launches of the timed run)."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.inference.driver import EntityDriver
    from univs_tpu_torch.inference.serving import BatchedVISServer

    cfg = UniVSConfig(dtype="bfloat16")
    K, E = 40, 40
    rng = np.random.RandomState(21)
    videos = [(rng.rand(n, *FULL_HW, 3) * 255).astype(np.uint8) for n in (*SERVE_LENGTHS, 30)]
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    srv = BatchedVISServer(cfg, model, num_classes=K, capacity=E, batch_size=2)
    pair = videos[:2]
    n_enc = srv.num_window_encodes(max(SERVE_LENGTHS))
    warm_s = timed_runs(lambda: srv.run_vis(pair, cls_emb), 1)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, launches = counted(lambda: srv.run_vis(pair, cls_emb))
    run_s = [time.perf_counter() - t0] + timed_runs(lambda: srv.run_vis(pair, cls_emb), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    single = EntityDriver(cfg, model, num_classes=K, capacity=E)
    t0 = time.perf_counter()
    want = [single.run_vis(v, cls_emb) for v in pair]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    expected = expected_launches(n_enc, cfg.pixel_decoder.num_layers)
    counts_ok = check_launches("BatchedVISServer", launches, expected)
    out_ok = all(check_results(r, n, *FULL_HW, E, K) for r, n in zip(got, SERVE_LENGTHS))
    out_ok &= same_rles(got[0], want[0])

    # the cost of the per-video backbone: the same batch with the backbone
    # folded over both videos' frames (one call, the pre-repair encode)
    folded = BatchedVISServer(cfg, model, num_classes=K, capacity=E, batch_size=2)
    folded.driver._encode = lambda m, frames, videos=1: EntityDriver._encode(m, frames)
    folded_s = timed_runs(lambda: folded.run_vis(pair, cls_emb), 2)
    del folded

    relaxed = with_gates_open(cfg)
    srv_open = BatchedVISServer(relaxed, model, num_classes=K, capacity=E, batch_size=2)
    single_open = EntityDriver(relaxed, model, num_classes=K, capacity=E)
    want_open = [single_open.run_vis(v, cls_emb) for v in videos]
    unequal = srv_open.run_vis(videos[:2], cls_emb)
    equal = srv_open.run_vis([videos[0], videos[2]], cls_emb)
    # the batched window encode of the equal pair against each video's lone
    # encode: the backbone runs per video, the pixel decoder over both
    pair_d = torch.as_tensor(np.stack([videos[0], videos[2]])).cuda()
    mf_b, ms_b = srv_open.driver.encode_window(pair_d.reshape(-1, *pair_d.shape[2:]), 2)
    lone = [srv_open.driver.encode_window(pair_d[i]) for i in range(2)]
    batch_err = [[float((h.float() - w.float()).abs().max())
                  for h, w in zip((mf_b[i * 30:(i + 1) * 30], *(m[i * 30:(i + 1) * 30] for m in ms_b)),
                                  (lw[0], *lw[1]))]
                 for i, lw in enumerate(lone)]
    del pair_d, mf_b, ms_b, lone
    open_rec = {
        "entities_unequal": [len(r) for r in unequal], "entities_equal": [len(r) for r in equal],
        "entities_entity_driver": [len(r) for r in want_open],
        "encode_batched_vs_lone_max_abs_err": batch_err,
        "rles_identical_longer": same_rles(unequal[0], want_open[0]),
        "rles_identical_equal": [same_rles(equal[0], want_open[0]),
                                 same_rles(equal[1], want_open[2])],
        "mask_iou_equal": [rle_iou(equal[0], want_open[0]), rle_iou(equal[1], want_open[2])],
        "rles_identical_shorter_not_required": same_rles(unequal[1], want_open[1]),
    }
    open_ok = (open_rec["rles_identical_longer"] and all(open_rec["rles_identical_equal"])
               and all(len(r) >= 1 for r in (*unequal, *equal))
               and all(check_results(r, n, *FULL_HW, E, K)
                       for r, n in zip((*unequal, *equal), (*SERVE_LENGTHS, 30, 30))))
    open_rec["pass"] = bool(open_ok)
    frames = sum(SERVE_LENGTHS)
    emit({"path": "BatchedVISServer.run_vis", "config": "UniVS-R50 VIS, bf16",
          "videos": len(pair), "lengths": list(SERVE_LENGTHS), "height": FULL_HW[0],
          "width": FULL_HW[1], "batch_size": 2, "capacity": E, "classes": K, "T": srv.driver.T,
          "stride": srv.driver.stride, "window": srv.driver.window, "window_encodes": n_enc,
          "encode_frames_per_window": 2 * srv.driver.window, "warmup_s": warm_s, "run_s": run_s,
          "videos_per_s": [len(pair) / t for t in run_s], "fps": [frames / t for t in run_s],
          "entity_driver_s_both_videos": single_s, "entity_driver_fps": frames / single_s,
          "folded_backbone_fps": [frames / t for t in folded_s],
          "entities": [len(r) for r in got],
          "rles_identical_to_entity_driver": [same_rles(g, w) for g, w in zip(got, want)],
          "gates_open": open_rec, "peak_mem_gb": peak, "launches": launches,
          "launches_expected": expected, "launches_ok": counts_ok, "outputs_ok": out_ok})
    del srv, single, srv_open, single_open
    torch.cuda.empty_cache()
    return bool(counts_ok and out_ok and open_ok), launches


def run_pipeline_path(model):
    """``EntityDriver(pipeline_devices=...)`` on (cuda:0, cuda:1) when two
    cards are visible, else (cuda:0, cuda:0), on a seeded 45-frame video
    (two windows, so the second window's encode is issued ahead): FPS of
    the pipelined and the unpipelined driver; with the gates open, the
    pipelined RLEs identical to the unpipelined ones, at least one
    entity.  Returns (ok, launches of the pipelined run)."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.inference.driver import EntityDriver

    cfg = UniVSConfig(dtype="bfloat16")
    K, E = 40, cfg.inference.max_num_instances
    V = PIPELINE_FRAMES
    rng = np.random.RandomState(22)
    video = (rng.rand(V, *FULL_HW, 3) * 255).astype(np.uint8)
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32))
    devs = ("cuda:0", "cuda:1" if torch.cuda.device_count() > 1 else "cuda:0")
    # a driver moves the module it is given to its decode device: on two
    # cards the pipelined drivers take a copy, the shared model stays
    pmodel = model if devs[1] == "cuda:0" else copy.deepcopy(model)
    plain = EntityDriver(cfg, model, num_classes=K, capacity=E)
    piped = EntityDriver(cfg, pmodel, num_classes=K, capacity=E, pipeline_devices=devs)
    piped.run_vis(video, cls_emb)  # warm-up
    t0 = time.perf_counter()
    got, launches = counted(lambda: piped.run_vis(video, cls_emb))
    piped_s = [time.perf_counter() - t0] + timed_runs(lambda: piped.run_vis(video, cls_emb), 1)
    plain_s = timed_runs(lambda: plain.run_vis(video, cls_emb), 2)
    n_enc = piped.num_window_encodes(V)
    expected = expected_launches(n_enc, cfg.pixel_decoder.num_layers)
    counts_ok = check_launches("pipeline_devices", launches, expected)
    same = same_rles(got, plain.run_vis(video, cls_emb))
    relaxed = with_gates_open(cfg)
    want_open = EntityDriver(relaxed, model, num_classes=K, capacity=E).run_vis(video, cls_emb)
    got_open = EntityDriver(relaxed, pmodel, num_classes=K, capacity=E,
                            pipeline_devices=devs).run_vis(video, cls_emb)
    same_open = same_rles(got_open, want_open) and len(got_open) >= 1
    emit({"path": "EntityDriver.run_vis pipeline_devices", "devices": list(devs),
          "frames": V, "window_encodes": n_enc, "entities": len(got), "rles_identical": same,
          "gates_open": {"entities": len(got_open), "rles_identical": same_open},
          "fps_pipelined": [V / t for t in piped_s], "fps_unpipelined": [V / t for t in plain_s],
          "launches": launches, "launches_ok": counts_ok})
    del piped, plain, pmodel
    torch.cuda.empty_cache()
    return bool(counts_ok and same and same_open), launches


# ---------------------------------------------------------------------------
# the evaluation path: engine._eval_* -> drivers -> evaluators
# ---------------------------------------------------------------------------

# frames of each task but VIS, cut from 30: DAVIS J&F's disk-dilated
# boundaries take ~0.6 s of host time an object-frame at 640x960
EVAL_FRAMES = 6
EVAL_FAF = (0, 0, 2, 3, 4)  # first appearances within EVAL_FRAMES
# 1-based json class ids of the five objects: VIPOSeg's thing seen 60,
# stuff seen 28, thing unseen 102, stuff unseen 9 and thing seen 89, so
# every G bucket holds samples (0-based in the VIPOSeg tables)
PVOS_RAW_CLASSES = (61, 29, 103, 10, 90)
VIPSEG_CLASSES_OF_OBJECTS = (3, 5, 1, 2, 42)  # things 3, 5, 42 and stuff 1, 2
COCO_CLASSES_OF_OBJECTS = (1, 2, 81, 90, 3)  # things 1, 2, 3 and stuff 81, 90


class Recorded(HostTime):
    """``HostTime`` that also keeps every return value (``outputs``)."""

    def __enter__(self):
        super().__enter__()
        self.outputs = []
        fn = getattr(self._owner, self._name)

        def keep(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.outputs.append(out)
            return out

        setattr(self._owner, self._name, keep)
        return self


def importable(name: str) -> bool:
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def moving_ellipses(faf, V, H, W, seed):
    """[N, V, H, W] uint8: object n a seeded ellipse in its own cell of a
    grid, drifting a few pixels a frame, present from frame faf[n] on."""
    import math

    rng = np.random.RandomState(seed)
    N = len(faf)
    cols = math.ceil(math.sqrt(N))
    rows = math.ceil(N / cols)
    ch, cw = H / rows, W / cols
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.zeros((N, V, H, W), np.uint8)
    for n, f in enumerate(faf):
        cy = (n // cols + rng.uniform(0.35, 0.65)) * ch
        cx = (n % cols + rng.uniform(0.35, 0.65)) * cw
        ry, rx = rng.uniform(0.2, 0.35) * ch, rng.uniform(0.2, 0.35) * cw
        vy, vx = rng.uniform(-1, 1, 2) * min(ch, cw) / 60
        for t in range(max(f, 0), V):
            out[n, t] = ((yy - cy - vy * t) / ry) ** 2 + ((xx - cx - vx * t) / rx) ** 2 <= 1
    return out


def eval_records(masks, faf, task, video_id, classes):
    """One video's record with the objects of ``masks`` as annotations,
    their segmentations RLEs from the native encoder (None before their
    first appearance)."""
    from univs_tpu_torch.utils import rle

    N, V, H, W = masks.shape
    anns = []
    for n in range(N):
        segs = [rle.encode(masks[n, t]) if t >= faf[n] else None for t in range(V)]
        anns.append({"id": n + 1, "category_id": classes[n], "raw_category_id": classes[n],
                     "iscrowd": 0, "segmentations": segs})
    return {"video_id": video_id, "video_name": f"chip_{video_id}", "dataset_name": "chip_smoke",
            "file_names": [], "height": H, "width": W, "length": V, "task": task,
            "annotations": anns}


class ArrayMapper:
    """The eval mapper over frames held in memory: the port's eval
    transform (``resize_shortest_edge``; the identity at 640x960, so no
    cv2) on the first ``length`` frames, and no file decode (no PIL)."""

    def __init__(self, frames, short: int, divisibility: int):
        self.frames, self.short, self.div = frames, short, divisibility

    def __call__(self, rec):
        from univs_tpu_torch.data.augment import resize_shortest_edge, transformed_image_size

        h, w, n = rec["height"], rec["width"], rec["length"]
        t = resize_shortest_edge((h, w), self.short, 1333, self.div)
        images = np.stack([t.apply_image(f) for f in self.frames[:n]]).astype(np.float32)
        return {"images": images, "image_size": transformed_image_size(t, (h, w)),
                "out_size": (h, w), "video_id": rec["video_id"], "video_len": n,
                "dataset_name": rec["dataset_name"], "task": rec["task"], "record": rec,
                "transform": t}


def metrics_finite(metrics: dict) -> bool:
    """Every metric finite: the records are built so that JAX's law gives
    no NaN (each G bucket has samples, mVC's window fits the video)."""
    return all(np.isfinite(v) for k, v in metrics.items() if k != "fps")


def rle_agreement(masks=(), rles=()) -> dict:
    """The native encoder against the numpy law: every binary mask of
    ``masks`` encoded by both, every dict of ``rles`` re-encoded from its
    native decode by the numpy law, byte-identical dicts."""
    from univs_tpu_torch.utils import rle

    n = same = 0
    for m in masks:
        n += 1
        same += bool(rle.encode(m) == rle.encode_numpy(m))
    for r in rles:
        n += 1
        same += bool(rle.encode_numpy(rle.decode(r)) == r
                     and int(rle.decode_numpy(r).sum()) == rle.area(r))
    return {"masks": n, "identical": same, "pass": same == n}


def rle_pair_agreement(gts, entities) -> dict:
    """``area`` / ``intersection`` / ``iou``, native against the numpy law,
    on every (GT object, predicted entity, frame) pair."""
    from univs_tpu_torch.utils import rle

    pairs = same = 0
    for g in gts:
        for e in entities:
            for a, b in zip(g["segmentations"], e["segmentations"]):
                if a is None or b is None:
                    continue
                ia, ib, ii = rle.area_numpy(a), rle.area_numpy(b), rle.intersection_numpy(a, b)
                union = ia + ib - ii
                pairs += 1
                same += ((rle.area(a), rle.area(b), rle.intersection(a, b), rle.iou(a, b))
                         == (ia, ib, ii, ii / union if union > 0 else 0.0))
    return {"pairs": pairs, "agree": same, "pass": same == pairs}


def eval_task(label, fn, driver_spot, expected, card, parts=(), extra_spots=()):
    """Run ``fn`` (one ``engine._eval_*`` call) with the launch counts set to
    0 just before it; returns (record, launches, the driver method's
    outputs, the outputs of ``extra_spots``).  Host seconds: the driver's
    calls, the GT decode (``segmentation_to_mask``), the frame mapping,
    the rest of the call (the evaluator: metrics, class lookups, outputs)
    and within it each of ``parts`` ((owner, name) of an evaluator
    function)."""
    import contextlib

    from univs_tpu_torch import engine

    with contextlib.ExitStack() as stack:
        drv = stack.enter_context(Recorded(*driver_spot))
        dec = stack.enter_context(HostTime(engine, "segmentation_to_mask"))
        mapr = stack.enter_context(HostTime(ArrayMapper, "__call__"))
        extra = [stack.enter_context(Recorded(*s)) for s in extra_spots]
        timed = {f"{owner.__name__.rsplit('.', 1)[-1]}.{name}":
                 stack.enter_context(HostTime(owner, name)) for owner, name in parts}
        t0 = time.perf_counter()
        metrics, launches = counted(fn)
        wall = time.perf_counter() - t0
    rec = {"eval": label, "metrics": metrics, "wall_s": wall, "driver_s": drv.s,
           "driver_calls": drv.calls, "gt_decode_s": dec.s, "gt_decodes": dec.calls,
           "mapper_s": mapr.s, "evaluator_host_s": wall - drv.s - dec.s - mapr.s,
           "evaluator_parts_s": {k: t.s for k, t in timed.items()},
           "metrics_finite": metrics_finite(metrics), "card": card}
    rec["launches_ok"] = check_launches(f"eval {label}", launches, expected)
    rec["kernels_launched"] = all(launches[k] > 0 for k in ENCODER_KERNELS)
    return rec, launches, drv.outputs, [e.outputs for e in extra]


def run_eval_path(model):
    """The evaluation path at full width (item 16a/b/d): ``engine._eval_*``
    for UniVS-R50 (default config, bf16, 640x960, seeded random weights,
    the model built once and shared by every driver) over seeded
    ``synth_blob_video`` frames with seeded moving elliptical GT stored as
    native RLEs, through an in-memory mapper.  Per task: launches (A/B/C
    at 6 x the driver's encodes), metrics finite, host seconds split; the
    oracle scores (the run's own predictions as ground truth: AP = 1, J =
    F = 1, VPQ = 1); native RLE byte-identical to the numpy law on every
    mask produced; YTVISEval native against numpy; the native and numpy
    encode of a fragmented 640x960 mask; the cost of building a driver per
    video from a state_dict against handing it the built model.  Returns
    (ok, {path: launches})."""
    import math

    import torch

    from univs_tpu_torch import engine
    from univs_tpu_torch.evaluation import davis, panoptic, pvos as pvos_eval, stq, vpq, vss
    from univs_tpu_torch.evaluation.davis import evaluate_davis_sequence
    from univs_tpu_torch.evaluation.vpq import vpq_single_video
    from univs_tpu_torch.evaluation.ytvis import YTVISEval
    from univs_tpu_torch.inference import image
    from univs_tpu_torch.inference.driver import EntityDriver, VOSDriver
    from univs_tpu_torch.inference.image import ImageDriver
    from univs_tpu_torch.utils import rle
    from univs_tpu_torch.utils.synth import synth_blob_video

    phase_t0 = time.perf_counter()
    card = card_line()
    cfg = model.cfg
    inf = cfg.inference
    (H, W), V = FULL_HW, MAIN_PATH_FRAMES
    layers = cfg.pixel_decoder.num_layers
    env = {"eval": "environment", "cv2": importable("cv2"), "PIL": importable("PIL"),
           "rle_backend": rle.backend(), "card": card}
    emit(env)
    ok = env["rle_backend"] == "native"

    t0 = time.perf_counter()
    frames = synth_blob_video(V, H, W, n_blobs=8, seed=12)  # 8 of 24 blobs: ~3x less host time
    masks = moving_ellipses(EVAL_FAF, V, H, W, seed=12)
    setup_s = time.perf_counter() - t0
    mapper = ArrayMapper(frames, inf.min_size_test, inf.size_divisibility)
    dim = cfg.decoder.clip_cls_emb_dim
    rng = np.random.RandomState(12)
    bank40, bank124, bank133 = (rng.randn(k, dim).astype(np.float32)
                                for k in (40, VIPSEG_CLASSES, COCO_PANOPTIC_CLASSES))
    short = masks[:, :EVAL_FRAMES]
    by_path, records = {}, []

    def probe(cls, **kw):  # the driver the engine builds, for its encode count
        return cls(cfg, model, **kw)

    # -- VIS: 30 frames, K=40, default gates, then gates open ---------------
    vis_rec = eval_records(masks, EVAL_FAF, "detection", 1, (1, 2, 3, 4, 5))
    enc = probe(EntityDriver, num_classes=40, capacity=inf.max_num_instances).num_window_encodes(V)
    ytvis_parts = ((YTVISEval, "evaluate"),)
    r, by_path["eval ytvis"], _, _ = eval_task(
        "ytvis", lambda: engine._eval_ytvis(cfg, model, [vis_rec], mapper, bank40, None),
        (EntityDriver, "run_vis"), expected_launches(enc, layers), card, ytvis_parts)
    records.append(r)
    open_cfg = with_gates_open(cfg)
    r, by_path["eval ytvis gates open"], ents, (jsons,) = eval_task(
        "ytvis gates open",
        lambda: engine._eval_ytvis(open_cfg, model, [vis_rec], mapper, bank40, None),
        (EntityDriver, "run_vis"), expected_launches(enc, layers), card, ytvis_parts,
        extra_spots=((engine, "vis_results_to_ytvis_json"),))
    records.append(r)
    ents, vis_preds = ents[0], jsons[0]
    r["entities"], r["predictions"] = len(ents), len(vis_preds)
    # oracle: the non-empty predictions as their own ground truth
    live = [p for p in vis_preds if any(rle.area(s) for s in p["segmentations"])]
    oracle_gt = [{"video_id": p["video_id"], "category_id": p["category_id"], "id": i,
                  "segmentations": p["segmentations"]} for i, p in enumerate(live)]
    r["oracle_AP"] = YTVISEval(oracle_gt, live).evaluate()["AP"] if live else float("nan")
    r["oracle_ok"] = len(live) > 0 and r["oracle_AP"] == 1.0
    gts = [dict(a, video_id=1, category_id=a["category_id"] - 1)
           for a in vis_rec["annotations"]]
    r["rle_native_vs_numpy"] = rle_agreement(
        rles=[s for e in ents for s in e["segmentations"]]
        + [s for a in vis_rec["annotations"] for s in a["segmentations"] if s])
    r["rle_pairs_native_vs_numpy"] = rle_pair_agreement(gts, ents)
    timings = {}
    for name in ("native", "numpy"):
        native = rle._native
        if name == "numpy":
            rle._native = lambda: None
        try:
            t0 = time.perf_counter()
            out = YTVISEval(gts, vis_preds).evaluate()
            timings[name] = {"s": time.perf_counter() - t0, "metrics": out}
        finally:
            rle._native = native
    r["ytvis_eval_s"] = {k: v["s"] for k, v in timings.items()}
    r["ytvis_eval_same"] = timings["native"]["metrics"] == timings["numpy"]["metrics"]
    ok &= r["oracle_ok"] and r["ytvis_eval_same"] and r["rle_native_vs_numpy"]["pass"] \
        and r["rle_pairs_native_vs_numpy"]["pass"]

    # -- VSS (VSPW, K=124) -------------------------------------------------
    vss_rec = eval_records(short, EVAL_FAF, "detection", 2, VIPSEG_CLASSES_OF_OBJECTS)
    r, by_path["eval vss"], _, _ = eval_task(
        "vss", lambda: engine._eval_vss(cfg, model, [vss_rec], mapper, bank124),
        (EntityDriver, "run_vss"), expected_launches(math.ceil(EVAL_FRAMES / inf.num_frames),
                                                      layers), card,
        ((vss, "confusion_matrix"), (vss, "video_consistency")))
    records.append(r)

    # -- VPS (VIPSeg, K=124, 58 things), default gates, then gates open ----
    vps_rec = eval_records(short, EVAL_FAF, "detection", 3, VIPSEG_CLASSES_OF_OBJECTS)
    enc = probe(EntityDriver, num_classes=124, capacity=inf.max_num_instances).num_window_encodes(
        EVAL_FRAMES)
    things = set(VIPSEG_THING_IDS)
    for label, c in (("vps", cfg), ("vps gates open", open_cfg)):
        r, by_path[f"eval {label}"], pans, _ = eval_task(
            label, lambda: engine._eval_vps(c, model, [vps_rec], mapper, bank124, things),
            (EntityDriver, "run_vps"), expected_launches(enc, layers), card,
            ((vpq, "vpq_single_video"), (stq.STQAccumulator, "update")))
        pan, info = pans[0]
        cats = {si["id"]: si["category_id"] - 1 for si in info}
        r["segments"] = len(info)
        r["rle_native_vs_numpy"] = rle_agreement(
            masks=[(pan[t] == si["id"]).astype(np.uint8) for si in info for t in range(len(pan))])
        ok &= r["rle_native_vs_numpy"]["pass"]
        if info:  # the panoptic map against itself
            r["oracle_VPQ"] = vpq_single_video(list(pan), cats, list(pan), cats,
                                               VIPSEG_CLASSES, (1, 2, 4, 6))["vpq"]
            r["oracle_ok"] = r["oracle_VPQ"] == 1.0
        records.append(r)
    ok &= records[-1].get("oracle_ok", False)

    # -- VOS and PVOS (N=5), RefVOS (4 expressions, random prompts) --------
    enc = probe(VOSDriver, capacity=len(EVAL_FAF)).num_window_encodes(EVAL_FRAMES)
    for label, pvos in (("vos", False), ("pvos", True)):
        rec = eval_records(short, EVAL_FAF, "sot", 4, PVOS_RAW_CLASSES)
        r, by_path[f"eval {label}"], labs, _ = eval_task(
            label, lambda: engine._eval_vos(cfg, model, [rec], mapper, bank40, pvos=pvos),
            (VOSDriver, "run"), expected_launches(enc, layers), card,
            ((davis, "evaluate_davis_sequence"), (pvos_eval, "pvos_video_samples")))
        lab = labs[0]
        pred = np.stack([(lab == n + 1) for n in range(len(EVAL_FAF))]).astype(np.uint8)
        oracle = evaluate_davis_sequence(pred, pred)
        r["oracle_J"], r["oracle_F"] = oracle["J"], oracle["F"]
        r["oracle_ok"] = lab.shape == (EVAL_FRAMES, H, W) and oracle["J"] == oracle["F"] == 1.0
        r["objects_labelled"] = int(len(np.unique(lab)) - (lab == 0).any())
        r["rle_native_vs_numpy"] = rle_agreement(masks=pred.reshape(-1, H, W))
        ok &= r["oracle_ok"] and r["rle_native_vs_numpy"]["pass"]
        records.append(r)
    ref_rec = eval_records(short[:4], EVAL_FAF[:4], "grounding", 5, (1, 2, 3, 4))
    ref_rec["expressions"] = list(EXPRESSIONS)
    ref_rec["exp_obj_ids"] = [1, 2, 3, 4]
    enc = probe(VOSDriver, capacity=4).num_window_encodes(EVAL_FRAMES)
    r, by_path["eval refvos"], outs, _ = eval_task(
        "refvos", lambda: engine._eval_refvos(cfg, model, [ref_rec], mapper, bank40),
        (VOSDriver, "run_grounding"), expected_launches(enc, layers), card,
        ((davis, "evaluate_davis_sequence"),))
    got = outs[0]
    r["oracle_ok"] = got.shape == (4, EVAL_FRAMES, H, W)
    r["rle_native_vs_numpy"] = rle_agreement(masks=got.reshape(-1, H, W))
    ok &= r["oracle_ok"] and r["rle_native_vs_numpy"]["pass"]
    records.append(r)

    # -- image (COCO panoptic, K=133), one frame ---------------------------
    img_rec = eval_records(masks[:, :1], (0,) * 5, "detection", 6, COCO_CLASSES_OF_OBJECTS)
    r, by_path["eval image"], _, _ = eval_task(
        "image", lambda: engine._eval_image(cfg, model, [img_rec], mapper, bank133,
                                            set(range(1, COCO_THINGS + 1))),
        (ImageDriver, "run"), expected_launches(1, layers), card,
        ((image, "instance_inference"), (image, "panoptic_inference"),
         (image, "semantic_inference"), (panoptic.PQStat, "update"), (YTVISEval, "evaluate")))
    records.append(r)

    for r in records:
        ok &= r["launches_ok"] and r["metrics_finite"]
        emit(r)

    # readings: the encoders on a fragmented 640x960 mask, a driver per video
    frag = (np.random.RandomState(13).rand(H, W) > 0.97).astype(np.uint8)
    frag |= masks[:, 0].max(0)
    enc_ms = {}
    for name, fn in (("native", rle.encode), ("numpy", rle.encode_numpy)):
        fn(frag)
        t0 = time.perf_counter()
        for _ in range(3):
            fn(frag)
        enc_ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    build_s = {}
    for name, params in (("state_dict", state), ("built_model", model)):
        t0 = time.perf_counter()
        d = VOSDriver(cfg, params, capacity=len(EVAL_FAF))
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        del d
    del state
    emit({"eval": "readings", "rle_encode_ms_fragmented_640x960": enc_ms,
          "rle_runs": int(len(rle._counts_from_mask(frag))),
          "vos_driver_per_video_s": build_s, "setup_s": setup_s,
          "phase_s": time.perf_counter() - phase_t0, "card": card})
    torch.cuda.empty_cache()
    return bool(ok), by_path


def reference_check_engine() -> bool:
    """``engine._eval_ytvis`` and ``engine._eval_vos`` on the tiny config in
    float32, card (through the kernels) vs CPU (plain laws), the same
    seeded weights, frames and GT: the same entities (ids, each frame's
    RLE IoU >= 0.99), each VOS object's mask per frame IoU >= 0.99, and
    every metric within 1e-3."""
    from univs_tpu_torch import engine
    from univs_tpu_torch.inference.driver import EntityDriver, VOSDriver
    from univs_tpu_torch.utils import rle

    t0 = time.perf_counter()
    cfg, video, _ = tiny_setup()
    V, H, W = video.shape[:3]
    K = 5
    bank = np.random.RandomState(7).randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
    faf = (0, 0, 3)
    masks = moving_ellipses(faf, V, H, W, seed=7)
    mapper = ArrayMapper(video, H, 32)
    vis_rec = eval_records(masks, faf, "detection", 1, (1, 2, 3))
    vos_rec = eval_records(masks, faf, "sot", 2, (1, 2, 3))
    out = {}
    for dev in ("cuda", "cpu"):
        with Recorded(EntityDriver, "run_vis") as ents, Recorded(VOSDriver, "run") as labs:
            (m_vis, m_vos), launches = counted(lambda: (
                engine._eval_ytvis(cfg, None, [vis_rec], mapper, bank, None, device=dev),
                engine._eval_vos(cfg, None, [vos_rec], mapper, bank, device=dev)))
        out[dev] = (m_vis, m_vos, ents.outputs[0], labs.outputs[0], launches)
    (gv, go, ge, gl, launches), (wv, wo, we, wl, _) = out["cuda"], out["cpu"]
    launched = all(launches[k] > 0 for k in ENCODER_KERNELS)
    same_ids = [e["obj_id"] for e in ge] == [e["obj_id"] for e in we] and len(we) >= 1
    iou = 1.0
    if same_ids:
        for g, w in zip(ge, we):
            iou = min(iou, min_iou([rle.decode(a).astype(bool) for a in g["segmentations"]],
                                   [rle.decode(b).astype(bool) for b in w["segmentations"]]))
    vos_iou = min(min_iou([f == o for f in gl], [f == o for f in wl]) for o in range(1, 4))
    err = max(abs(gm[k] - wm[k]) for gm, wm in ((gv, wv), (go, wo)) for k in wm if k != "fps")
    ok = launched and same_ids and iou >= 0.99 and vos_iou >= 0.99 and err <= 1e-3
    emit({"check": "engine_tiny_cuda_vs_cpu", "entities_cuda": len(ge), "entities_cpu": len(we),
          "kernels_launched": launched, "min_entity_rle_iou": iou, "min_vos_mask_iou": vos_iou,
          "metrics_cuda": {"ytvis": gv, "vos": go}, "metrics_cpu": {"ytvis": wv, "vos": wo},
          "max_metric_abs_err": err, "s": time.perf_counter() - t0, "pass": bool(ok)})
    return bool(ok)


# ---------------------------------------------------------------------------
# the entry phase: weight intake, run_net, demo and profiling
# ---------------------------------------------------------------------------

ENTRY_FRAMES = 10
ENTRY_FAF = (0, 0, 2, 4, 6)
ENTRY_DATASET = "ytvis_2019_val"
# the CLI's gates open (yacs pair form), so seeded weights admit entities
ENTRY_OPTS = ("MODEL.BoxVIS.TEST.APPLY_CLS_THRES", "0.0", "inference.consistency_thres",
              "(-1.0, 0.5)")
_MHA_OWNER = r"cross_\d+|self_\d+|proca_\d+|lang2vision"
_REFERENCE_RULES = (  # port state_dict name -> reference name (d2 R50, UniVS heads)
    (r"backbone\.stem_conv\.weight", "backbone.stem.conv1.weight"),
    (r"backbone\.stem_bn\.(\w+)", r"backbone.stem.conv1.norm.\1"),
    (r"backbone\.res(\d)_block(\d+)\.conv(\d)\.weight", r"backbone.res\1.\2.conv\3.weight"),
    (r"backbone\.res(\d)_block(\d+)\.bn(\d)\.(\w+)", r"backbone.res\1.\2.conv\3.norm.\4"),
    (r"backbone\.res(\d)_block(\d+)\.shortcut\.weight", r"backbone.res\1.\2.shortcut.weight"),
    (r"backbone\.res(\d)_block(\d+)\.shortcut_bn\.(\w+)",
     r"backbone.res\1.\2.shortcut.norm.\3"),
    (r"pixel_decoder\.level_embed", "PD.transformer.level_embed"),
    (r"pixel_decoder\.input_proj_(\d+)\.(\w+)", r"PD.input_proj.\1.0.\2"),
    (r"pixel_decoder\.input_proj_gn_(\d+)\.(\w+)", r"PD.input_proj.\1.1.\2"),
    (r"pixel_decoder\.encoder_layer_(\d+)\.(.*)", r"PD.transformer.encoder.layers.\1.\2"),
    (r"pixel_decoder\.adapter_(\d+)\.weight", lambda m: f"PD.adapter_{int(m[1]) + 1}.weight"),
    (r"pixel_decoder\.adapter_gn_(\d+)\.(\w+)",
     lambda m: f"PD.adapter_{int(m[1]) + 1}.norm.{m[2]}"),
    (r"pixel_decoder\.layer_(\d+)\.weight", lambda m: f"PD.layer_{int(m[1]) + 1}.weight"),
    (r"pixel_decoder\.layer_gn_(\d+)\.(\w+)", lambda m: f"PD.layer_{int(m[1]) + 1}.norm.{m[2]}"),
    (r"pixel_decoder\.mask_features\.(\w+)", r"PD.mask_features.\1"),
    (r"decoder\.query_feat", "P.static_query.weight"),  # the historical name
    (r"decoder\.(query_embed|level_embed)", r"P.\1.weight"),
    (r"decoder\.(cls_temp|reid_temp|prompt_detection|prompt_sot|prompt_grounding)",
     r"P.\1.weight"),
    (r"decoder\.(decoder_norm|text_norm|vis2text_projection|text2vis_projection)\.(\w+)",
     r"P.\1.\2"),
    (r"decoder\.cross_(\d+)\.attn\.(.*)", r"P.transformer_cross_attention_layers.\1.multihead_attn.\2"),
    (r"decoder\.cross_(\d+)\.norm\.(\w+)", r"P.transformer_cross_attention_layers.\1.norm.\2"),
    (r"decoder\.self_(\d+)\.attn\.(.*)", r"P.transformer_self_attention_layers.\1.self_attn.\2"),
    (r"decoder\.self_(\d+)\.norm\.(\w+)", r"P.transformer_self_attention_layers.\1.norm.\2"),
    (r"decoder\.proca_(\d+)\.attn\.(.*)",
     r"P.transformer_prompt_self_attention_layers.\1.multihead_attn.\2"),
    (r"decoder\.proca_(\d+)\.norm\.(\w+)", r"P.transformer_prompt_self_attention_layers.\1.norm.\2"),
    (r"decoder\.lang2vision\.attn\.(.*)", r"P.lang2vision_cross_attention_layer.multihead_attn.\1"),
    (r"decoder\.lang2vision\.norm\.(\w+)", r"P.lang2vision_cross_attention_layer.norm.\1"),
    (r"decoder\.ffn_(\d+)\.(.*)", r"P.transformer_ffn_layers.\1.\2"),
    (r"decoder\.mask_embed\.layer(\d)\.(\w+)", r"P.mask_embed.layers.\1.\2"),
)


def reference_checkpoint(sd) -> dict:
    """A UniVS-R50 state_dict of the port -> the reference checkpoint's
    names (d2 ``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
    ``sem_seg_head.predictor.*`` with packed attention projections,
    ``static_query``, the 1-row embeddings as [1, C]); the converters of
    ``utils/convert_univs.py`` read backwards (tests/torch_convert_util.py
    holds the same map for every backbone)."""
    import re

    import torch

    sd = {k: v.detach().cpu() for k, v in sd.items()}
    for k in [k for k in sd if re.fullmatch(rf"decoder\.({_MHA_OWNER})\.attn\.q_proj\.weight", k)]:
        p = k[: -len("q_proj.weight")]
        for leaf in ("weight", "bias"):
            sd[f"{p}in_proj_{leaf}"] = torch.cat([sd.pop(f"{p}{n}_proj.{leaf}") for n in "qkv"])
    out = {}
    for k, v in sd.items():
        for pat, rep in _REFERENCE_RULES:
            m = re.fullmatch(pat, k)
            if m:
                name = rep(m) if callable(rep) else m.expand(rep)
                break
        else:
            raise KeyError(f"no reference name for {k}")
        name = name.replace("PD.", "sem_seg_head.pixel_decoder.", 1).replace(
            "P.", "sem_seg_head.predictor.", 1)
        if re.search(r"predictor\.(cls_temp|reid_temp|prompt_\w+)\.weight$", name):
            v = v.reshape(1, -1)
        out[name] = v.contiguous()
    return out


def write_ytvis_tree(root: str, frames, masks) -> str:
    """``ENTRY_DATASET``'s JSON and JPEG frames under ``root`` (one video;
    each object's per-frame RLE from the native encoder, None before it
    appears); returns the frame folder."""
    from PIL import Image

    from univs_tpu_torch.data.datasets import get_spec
    from univs_tpu_torch.utils import rle

    spec = get_spec(ENTRY_DATASET)
    folder = os.path.join(root, spec.image_root, "chip")
    os.makedirs(folder, exist_ok=True)
    names = []
    for t, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(folder, f"{t:05d}.jpg"), quality=95)
        names.append(f"chip/{t:05d}.jpg")
    N, V, H, W = masks.shape
    anns = [{"id": n + 1, "video_id": 1, "category_id": n + 1, "iscrowd": 0,
             "segmentations": [rle.encode(masks[n, t]) if masks[n, t].any() else None
                               for t in range(V)]} for n in range(N)]
    data = {"videos": [{"id": 1, "file_names": names, "height": H, "width": W, "length": V}],
            "annotations": anns, "categories": [{"id": c, "name": str(c)} for c in range(1, 41)]}
    path = os.path.join(root, spec.json_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)
    return folder


def cli(main, argv):
    """Run an entry point's ``main(argv)`` in-process: (its stdout, s)."""
    (_, text), s = timed_cli(main, argv)
    return text, s


def timed_cli(main, argv):
    """(``main(argv)``'s return value and stdout, s) of an in-process call."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return (out, buf.getvalue()), time.perf_counter() - t0


class TimedSteps:
    """Seconds of every train step the CLI takes (synchronised), through
    ``make_train_step`` while the ``with`` block runs."""

    def __enter__(self):
        import torch

        from univs_tpu_torch.parallel import train_state

        self._mod, self._make = train_state, train_state.make_train_step
        self.s = []

        def make(*args, **kwargs):
            step = self._make(*args, **kwargs)

            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **k)
                torch.cuda.synchronize()
                self.s.append(time.perf_counter() - t0)
                return out
            return timed

        train_state.make_train_step = make
        return self

    def __exit__(self, *exc):
        self._mod.make_train_step = self._make


def video_frame_count(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def run_entry_path():
    """Weight intake and the entry points at full width (UniVS-R50, bf16,
    640x960): a reference-named checkpoint (d2 R50, ``sem_seg_head.*``,
    ``static_query``; the student from the port's seeded init, seed 0, the
    EMA teacher from seed 1 under ``teacher.``) through ``load_params`` and
    ``build_model`` equal to the seed-1 model bit for bit;
    ``run_net --eval-only --weights`` on a synthetic ytvis tree of one
    10-frame video with five GT ellipses (native RLEs) against
    ``engine.evaluate_dataset`` on the seeded model, A/B/C 6 x encodes;
    ``--train`` (B=2 clips of T=2 at 1024, 2 steps, a state a step),
    ``--resume`` (iter 2 -> state_3) and ``--eval-only --weights
    ckpt_final``; ``demo.run`` (VIS and first-frame-mask VOS, rendered with
    ``--parallel``) writing overlays cv2 reads back; one ``run_vis`` under
    ``profiling.trace`` and ``StageTimer``.  The CLI's config through
    ``--opts`` in yacs pair form.  Returns (ok, {path: launches})."""
    import tempfile
    import types

    import torch

    from univs_tpu_torch import engine
    from univs_tpu_torch.data.category_info import TOTAL_CATEGORY_ROWS
    from univs_tpu_torch.inference.driver import EntityDriver, VOSDriver
    from univs_tpu_torch.models.univs import UniVSModel, build_model
    from univs_tpu_torch.prompts.prepare_targets import PrepareTargets
    from univs_tpu_torch.tools import demo, run_net
    from univs_tpu_torch.utils import profiling, weights
    from univs_tpu_torch.utils.checkpoint import load_category_bank, load_params
    from univs_tpu_torch.utils.synth import synth_blob_video

    phase_t0 = time.perf_counter()
    card = card_line()
    env = {"entry": "environment", "cv2": importable("cv2"), "PIL": importable("PIL"),
           "yaml": importable("yaml"), "card": card}
    emit(env)
    if not (env["cv2"] and env["PIL"]):
        log("entry: the demo and the data layer need cv2 and PIL; one is missing")
        return False, {}
    ok, by_path = True, {}
    (H, W), V = FULL_HW, ENTRY_FRAMES
    tmp = tempfile.TemporaryDirectory(prefix="chip_entry_")
    root = tmp.name
    old_root = os.environ.get("UNIVS_TPU_DATA_ROOT")
    os.environ["UNIVS_TPU_DATA_ROOT"] = root
    try:
        argv_cfg = ["--opts", *ENTRY_OPTS]
        cfg, _ = run_net.build_cfg(run_net.parse_args(argv_cfg))
        layers = cfg.pixel_decoder.num_layers

        # -- 1. a full-width reference-named EMA checkpoint ----------------
        t0 = time.perf_counter()
        seeded = {}
        for seed in (0, 1):
            m = UniVSModel(cfg)
            weights.init_params(m, seed)
            seeded[seed] = reference_checkpoint(m.state_dict())
            del m
        ckpt = dict(seeded[0])
        ckpt.update({"teacher." + k: v for k, v in seeded[1].items()})
        pth = os.path.join(root, "univs_r50_ema.pth")
        torch.save({"model": ckpt}, pth)
        n_keys = len(ckpt)
        del ckpt, seeded
        fabricate_s = time.perf_counter() - t0

        # -- 2. intake: load_params + build_model, the teacher bit for bit -
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = load_params(pth, cfg)
        convert_s = time.perf_counter() - t0
        loaded = build_model(cfg, params, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del params
        ref_model = build_model(cfg, None, seed=1, device="cuda")
        got, want = loaded.state_dict(), ref_model.state_dict()
        same = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
        rec = {"entry": "intake", "checkpoint_mb": os.path.getsize(pth) / 2 ** 20,
               "keys": n_keys,
               "fabricate_s": fabricate_s, "load_and_convert_s": convert_s,
               "load_convert_build_s": load_s, "tensors": len(want),
               "equal_to_seed_1_bit_for_bit": same, "card": card}
        emit(rec)
        ok &= same
        del loaded, got, want

        # -- 3. eval through the CLI against evaluate_dataset -------------
        frames = synth_blob_video(V, H, W, n_blobs=8, seed=13)
        masks = moving_ellipses(ENTRY_FAF, V, H, W, seed=13)
        folder = write_ytvis_tree(root, frames, masks)
        argv = ["--eval-only", "--weights", pth, "--dataset", ENTRY_DATASET]
        (text, cli_s), launches = counted(lambda: cli(run_net.main, argv + [
            "--output", os.path.join(root, "cli")] + argv_cfg))
        got = json.loads(text.strip().splitlines()[-1])
        bank = load_category_bank(None, TOTAL_CATEGORY_ROWS, cfg.decoder.clip_cls_emb_dim)
        cls_slice = PrepareTargets(bank).category_slice(ENTRY_DATASET)
        t0 = time.perf_counter()
        want = engine.evaluate_dataset(cfg, ref_model, ENTRY_DATASET, cls_slice,
                                       output_dir=os.path.join(root, "direct"), device="cuda")
        direct_s = time.perf_counter() - t0
        enc = EntityDriver(cfg, ref_model, num_classes=cls_slice.shape[0],
                           capacity=cfg.inference.max_num_instances).num_window_encodes(V)
        demo_cfg, _ = run_net.build_cfg(types.SimpleNamespace(
            backbone="resnet50", num_frames=5, bf16=True, tiny=False))
        demo_enc = {"vis": EntityDriver(demo_cfg, ref_model, num_classes=40).num_window_encodes(V),
                    "mask": VOSDriver(demo_cfg, ref_model, capacity=len(ENTRY_FAF)
                                      ).num_window_encodes(V)}
        with open(os.path.join(root, "cli", "results.json")) as f:
            cli_preds = json.load(f)
        with open(os.path.join(root, "direct", "results.json")) as f:
            direct_preds = json.load(f)
        strip = lambda m: {k: v for k, v in m.items() if k != "fps"}
        rec = {"entry": "run_net --eval-only", "metrics": got, "direct_metrics": want,
               "same_metrics": strip(got) == strip(want),
               "same_results_json": cli_preds == direct_preds, "predictions": len(cli_preds),
               "cli_s": cli_s, "direct_evaluate_dataset_s": direct_s, "frames": V,
               "launches_ok": check_launches("entry run_net eval", launches,
                                             expected_launches(enc, layers)),
               "card": card}
        emit(rec)
        ok &= rec["same_metrics"] and rec["same_results_json"] and rec["launches_ok"]
        by_path["entry run_net eval"] = launches
        del ref_model
        torch.cuda.empty_cache()

        # -- 4. train, resume, reload through the CLI ----------------------
        out = os.path.join(root, "train")
        train = ["--train", "--weights", pth, "--datasets", f"{ENTRY_DATASET}:1.0",
                 "--image-size", "1024", "--batch-size", "2", "--num-frames", "2",
                 "--ckpt-every", "1", "--output", out]
        with TimedSteps() as steps:
            (text, train_s), launches = counted(lambda: cli(run_net.main, train + [
                "--max-iter", "2"] + argv_cfg))
        event_line = [line for line in text.splitlines() if line.startswith("iter ")]
        states = sorted(os.listdir(out))
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        finite = all(np.isfinite(v) for r in logged for v in r.values())
        with TimedSteps() as resume_steps:
            (text, resume_s), resume_launches = counted(lambda: cli(run_net.main, train + [
                "--max-iter", "3", "--resume"] + argv_cfg))
        resumed = "resumed full train state" in text and "(iter 2)" in text
        (text, reload_s), reload_launches = counted(lambda: cli(run_net.main, [
            "--eval-only", "--weights", os.path.join(out, "ckpt_final"), "--dataset",
            ENTRY_DATASET, "--output", os.path.join(root, "final")] + argv_cfg))
        reload_metrics = json.loads(text.strip().splitlines()[-1])
        rec = {"entry": "run_net --train / --resume / ckpt_final", "files": states,
               "state_3": os.path.exists(os.path.join(out, "state_3")),
               "metrics_jsonl": logged, "losses_finite": finite,
               "event_writer_line": event_line, "step_s": steps.s, "resume_step_s": resume_steps.s,
               "train_cli_s": train_s, "resume_cli_s": resume_s, "resumed_at_iter_2": resumed,
               "reload_eval_s": reload_s, "reload_metrics": reload_metrics,
               "state_mb": os.path.getsize(os.path.join(out, "state_1")) / 2 ** 20,
               "launches_ok": all([
                   check_launches("entry run_net train", launches, expected_launches(2, layers)),
                   check_launches("entry run_net resume", resume_launches,
                                  expected_launches(1, layers)),
                   check_launches("entry run_net eval ckpt_final", reload_launches,
                                  expected_launches(enc, layers))]),
               "card": card}
        emit(rec)
        ok &= (rec["launches_ok"] and resumed and finite and rec["state_3"]
               and {"state_1", "state_2", "metrics.jsonl", "ckpt_final"} <= set(states)
               and len(logged) == 1 and set(reload_metrics) >= {"AP", "fps"})
        by_path["entry run_net train"] = launches
        by_path["entry run_net resume"] = resume_launches
        by_path["entry run_net eval ckpt_final"] = reload_launches
        torch.cuda.empty_cache()

        # -- 5. demo: VIS and first-frame-mask VOS, --parallel ------------
        from PIL import Image

        first = np.zeros((H, W), np.uint8)
        present = [n for n in range(len(ENTRY_FAF)) if masks[n, 0].any()]
        for i, n in enumerate(present):
            first[masks[n, 0] > 0] = i + 1
        Image.fromarray(first).save(os.path.join(root, "first_frame.png"))
        for mode, extra in (("vis", {}), ("mask", {"mask": os.path.join(root, "first_frame.png")})):
            path = os.path.join(root, f"demo_{mode}.avi")
            args = types.SimpleNamespace(
                input=folder, output=path, weights=pth, bank=None, dataset_ns="ytvis19",
                backbone="resnet50", score_thres=0.0, tiny=False, max_frames=V, parallel=True,
                num_render_workers=2, **extra)
            (text, demo_s), launches = counted(lambda: cli(demo.run, args))
            n = video_frame_count(path) if os.path.exists(path) else 0
            rec = {"entry": f"demo {mode}", "overlay": os.path.basename(path),
                   "bytes": os.path.getsize(path) if os.path.exists(path) else 0,
                   "frames_read_back": n, "printed": text.strip().splitlines()[-1:],
                   "demo_s": demo_s, "s_per_frame": demo_s / V,
                   "launches_ok": check_launches(f"entry demo {mode}", launches,
                                                 expected_launches(demo_enc[mode], layers)),
                   "card": card}
            emit(rec)
            ok &= rec["launches_ok"] and n == V
            by_path[f"entry demo {mode}"] = launches

        # -- 6. profiling: one run_vis under trace and StageTimer ---------
        model = build_model(cfg, load_params(pth, cfg), device="cuda")
        driver = EntityDriver(cfg, model, num_classes=cls_slice.shape[0],
                              capacity=cfg.inference.max_num_instances)
        cls_emb = torch.as_tensor(cls_slice).cuda()
        video = frames.astype(np.float32)
        driver.run_vis(video, cls_emb)  # warm-up
        timer = profiling.StageTimer()
        trace_dir = os.path.join(root, "trace")

        def profiled():
            with profiling.trace(trace_dir):
                with timer.stage("run_vis", sync=cls_emb):
                    driver.run_vis(video, cls_emb)
                with timer.stage("encode_window", sync=(cls_emb,)):
                    driver.encode_window(torch.as_tensor(frames, device="cuda"))

        _, launches = counted(profiled)
        files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        size = sum(os.path.getsize(os.path.join(trace_dir, f)) for f in files)
        rec = {"entry": "profiling", "trace_files": len(files), "trace_bytes": size,
               "stage_timer": timer.summary().splitlines(),
               "launches_ok": check_launches("entry profile", launches,
                                             expected_launches(enc + 1, layers)),
               "card": card}
        emit(rec)
        ok &= rec["launches_ok"] and len(files) == 1 and size > 0
        by_path["entry profile"] = launches
        del driver, model
    finally:
        if old_root is None:
            os.environ.pop("UNIVS_TPU_DATA_ROOT", None)
        else:
            os.environ["UNIVS_TPU_DATA_ROOT"] = old_root
        tmp.cleanup()
    torch.cuda.empty_cache()
    emit({"entry": "phase", "phase_s": time.perf_counter() - phase_t0, "pass": bool(ok),
          "card": card})
    return bool(ok), by_path


TOOLS_FRAMES = 10
TOOLS_FAF = (0, 0, 2, 4, 6)
# the CLI's data-parallel check: the training cell's shape (1024^2, B=2 x
# T=2) in float32, so that the one-process and two-process masters can be
# held to the CPU test's float32 tolerances (tests/test_torch_ddp.py):
# losses within 1e-5 x max(1, |v|), masters within 1e-5, except elements
# whose gradient the two runs do not share to 1 % (the test exempts its
# zero-gradient leaves alike): there Adam's normalised step turns the
# difference into a move of up to a step.  At full width these are many:
# a rank's one video runs other cuDNN algorithms than the batch of two,
# and the criterion's discrete picks (the 12,544 uncertain points, the
# matching) follow rounding, so the first moment differs by ~1e-3 in norm
# where the losses agree to ~1e-6.  Each such element is held to two steps'
# reach of the other run's, and the first moment to 1e-2 in norm (the
# bf16 DDP check's 2e-2, halved).
CLI_WORLD = 2
CLI_LOSS_TOL = 1e-5  # x max(1, |v|)
CLI_PARAM_TOL = 1e-5  # absolute, on the float32 masters
CLI_SHARED_REL = 1e-2  # |mu_world - mu_one| <= this x |mu_one|: a shared gradient
CLI_MU_TOL = 1e-2  # ||mu_world - mu_one|| / ||mu_one||
CLI_TRAIN = ("--train", "--datasets", f"{ENTRY_DATASET}:1.0", "--image-size", "1024",
             "--batch-size", "2", "--num-frames", "2", "--ckpt-every", "2")
CLI_OPTS = ("--opts", "dtype=float32")  # last: --opts takes the rest of the line
BANK_NAMES = 64
SWEEP_LEVEL = 1  # the 1/16 level (40x60): A, E whole, E at Hw 12 / 16 / 20


class DataTree:
    """A temporary ``ENTRY_DATASET`` tree of one seeded 640x960 video of
    ``TOOLS_FRAMES`` frames (five moving ellipses as GT), set as
    ``UNIVS_TPU_DATA_ROOT`` while the ``with`` block runs."""

    def __enter__(self):
        import tempfile

        from univs_tpu_torch.utils.synth import synth_blob_video

        self._tmp = tempfile.TemporaryDirectory(prefix="chip_tools_")
        self.root = self._tmp.name
        self._old = os.environ.get("UNIVS_TPU_DATA_ROOT")
        os.environ["UNIVS_TPU_DATA_ROOT"] = self.root
        (H, W), V = FULL_HW, TOOLS_FRAMES
        self.frames = synth_blob_video(V, H, W, n_blobs=8, seed=17)
        write_ytvis_tree(self.root, self.frames, moving_ellipses(TOOLS_FAF, V, H, W, seed=17))
        return self

    def __exit__(self, *exc):
        if self._old is None:
            os.environ.pop("UNIVS_TPU_DATA_ROOT", None)
        else:
            os.environ["UNIVS_TPU_DATA_ROOT"] = self._old
        self._tmp.cleanup()


def run_net_rank(out_prefix: str, argv) -> int:
    """One ``torchrun`` rank of ``run_net.main(argv)`` (as ``python -m
    univs_tpu_torch.tools.run_net`` runs it), its launch counts, train step
    seconds and stdout written to ``<out_prefix>.<RANK>.json``: the counts
    of a rank are visible only in its own process."""
    from univs_tpu_torch.tools import run_net

    with TimedSteps() as steps:
        (text, s), launches = counted(lambda: cli(run_net.main, argv))
    rank = int(os.environ["RANK"])
    with open(f"{out_prefix}.{rank}.json", "w") as f:
        json.dump({"rank": rank, "stdout": text, "s": s, "step_s": steps.s,
                   "launches": launches}, f)
    return 0


def torchrun_cli(backend: str, argv, out_prefix: str, device_args=()) -> tuple:
    """``python -m torch.distributed.run --nproc_per_node 2`` over
    ``run_net_rank``: (the ranks' records, s of the command)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(CLI_WORLD), "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), os.path.abspath(__file__), "run_net_rank",
           out_prefix, *argv, "--dist-backend", backend, *device_args, *CLI_OPTS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    s = time.perf_counter() - t0
    if proc.returncode:
        log(f"torchrun failed ({proc.returncode}): {proc.stderr[-3000:]}")
        return None, s
    ranks = []
    for r in range(CLI_WORLD):
        with open(f"{out_prefix}.{r}.json") as f:
            ranks.append(json.load(f))
    return ranks, s


def run_cli_ddp(backend: str):
    """``run_net --train`` as two ``torchrun`` ranks (gloo over cuda:0, or
    NCCL with a card a rank) at the training cell's shape in float32, 2
    steps, then ``--resume`` for 1, against the one-process CLI on the same
    tree for 2 steps: the logged losses within 1e-5 x max(1, |v|), the
    world's ``state_2`` masters within 1e-5 of the one-process
    ``ckpt_final``, only rank 0 writing and printing, the resume at iter 2,
    A/B/C 6 a step on every rank.  Returns (ok, {path: launches})."""
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.tools import run_net

    with DataTree() as tree:
        return _cli_ddp(backend, tree.root, UniVSConfig().pixel_decoder.num_layers, run_net.main)


def _cli_ddp(backend: str, root: str, layers: int, run_net_main):
    import torch

    card = card_line()
    one, world = os.path.join(root, f"one_{backend}"), os.path.join(root, f"world_{backend}")
    device_args = ("--device", "cuda:0") if backend == "gloo" else ()
    with TimedSteps() as steps:
        (_, one_s), one_launches = counted(lambda: cli(
            run_net_main, [*CLI_TRAIN, "--max-iter", "2", "--output", one, *CLI_OPTS]))
    torch.cuda.empty_cache()
    prefix = os.path.join(root, f"rank_{backend}")
    ranks, world_s = torchrun_cli(backend, [*CLI_TRAIN, "--max-iter", "2", "--output", world],
                                  prefix + "_train", device_args)
    if ranks is not None:  # the world's ckpt_final of step 2, before the resume rewrites it
        got_final = torch.load(os.path.join(world, "ckpt_final"), weights_only=True)
    resumed, resume_s = torchrun_cli(backend, [*CLI_TRAIN, "--max-iter", "3", "--resume",
                                               "--output", world],
                                     prefix + "_resume", device_args)
    if ranks is None or resumed is None:
        emit({"tools": f"run_net --train torchrun {backend}", "pass": False, "card": card})
        return False, {}
    with open(os.path.join(one, "metrics.jsonl")) as f:
        want_log = [json.loads(line) for line in f]
    with open(os.path.join(world, "metrics.jsonl")) as f:
        got_log = [json.loads(line) for line in f]
    loss_err = max((abs(got_log[0][k] - v) / max(1.0, abs(v)) for k, v in want_log[0].items()
                    if k != "iteration"), default=float("inf"))
    from univs_tpu_torch.config import UniVSConfig

    want_final = torch.load(os.path.join(one, "ckpt_final"), weights_only=True)
    agree = master_agreement(
        want_final["params"], got_final["params"],
        torch.load(os.path.join(one, "state_2"), weights_only=True)["mu"],
        torch.load(os.path.join(world, "state_2"), weights_only=True)["mu"],
        reach=2 * 2 * UniVSConfig().train.lr * 1.01)
    final = torch.load(os.path.join(world, "ckpt_final"), weights_only=True)
    moved = max(float((v - got_final["params"][k]).abs().max())
                for k, v in final["params"].items())
    per_rank = expected_launches(2, layers)
    launches = {
        "tools run_net one process": one_launches,
        f"tools run_net --train {backend} x2": {k: sum(r["launches"][k] for r in ranks)
                                                for k in one_launches},
        f"tools run_net --resume {backend} x2": {k: sum(r["launches"][k] for r in resumed)
                                                 for k in one_launches},
    }
    counts_ok = (check_launches("tools run_net one process", one_launches, per_rank)
                 and all(check_launches(f"tools run_net --train {backend} rank {r['rank']}",
                                        r["launches"], per_rank) for r in ranks)
                 and all(check_launches(f"tools run_net --resume {backend} rank {r['rank']}",
                                        r["launches"], expected_launches(1, layers))
                         for r in resumed))
    files = sorted(os.listdir(world))
    rec = {"tools": f"run_net --train torchrun {backend}", "world": CLI_WORLD,
           "dtype": "float32", "height": TRAIN_HW, "width": TRAIN_HW, "batch": 2, "frames": 2,
           "one_process_step_s": steps.s, "one_process_cli_s": one_s,
           "rank_step_s": [r["step_s"] for r in ranks],
           "resume_rank_step_s": [r["step_s"] for r in resumed],
           "torchrun_s": world_s, "torchrun_resume_s": resume_s,
           "logged_iterations": [r["iteration"] for r in got_log],
           "max_rel_loss_err": loss_err, "loss_tol": CLI_LOSS_TOL,
           "total_loss": [got_log[0]["total_loss"], want_log[0]["total_loss"]],
           **agree, "resumed_step_moved_max": moved,
           "steps": [int(want_final["step"]), int(got_final["step"]), int(final["step"])],
           "files": files,
           "rank0_printed": bool(ranks[0]["stdout"]), "rank1_silent": not ranks[1]["stdout"]
           and not resumed[1]["stdout"],
           "resumed_at_iter_2": "(iter 2)" in resumed[0]["stdout"],
           "launches_ok": counts_ok, "card": card}
    rec["pass"] = bool(
        counts_ok and loss_err <= CLI_LOSS_TOL and agree["masters_pass"]
        and set(got_log[0]) == set(want_log[0]) and rec["logged_iterations"] == [0]
        and files == ["ckpt_final", "metrics.jsonl", "state_2"] and rec["steps"] == [2, 2, 3]
        and rec["rank0_printed"] and rec["rank1_silent"] and rec["resumed_at_iter_2"]
        and moved > 0)
    emit(rec)
    return rec["pass"], launches


def master_agreement(want: dict, got: dict, want_mu: dict, got_mu: dict, reach: float) -> dict:
    """Two runs' float32 masters held to ``CLI_PARAM_TOL`` where their
    gradient is shared (first moments within ``CLI_SHARED_REL`` of the
    one-process run's), within ``reach`` elsewhere; the first moments
    within ``CLI_MU_TOL`` in norm."""
    law, noise_err, noise, n, dmu2, mu2 = [], 0.0, 0, 0, 0.0, 0.0
    for k, p in want.items():
        dp = (got[k] - p).abs()
        dm = (got_mu[k] - want_mu[k]).abs()
        is_noise = dm > CLI_SHARED_REL * want_mu[k].abs()
        n += p.numel()
        noise += int(is_noise.sum())
        if bool(is_noise.any()):
            noise_err = max(noise_err, float(dp[is_noise].max()))
        law.append((float(dp[~is_noise].max()) if bool((~is_noise).any()) else 0.0, k))
        dmu2 += float((dm.double() ** 2).sum())
        mu2 += float((want_mu[k].double() ** 2).sum())
    law.sort(reverse=True)
    out = {"param_max_abs_err": law[0][0], "worst_params": [[k, e] for e, k in law[:3]],
           "param_tol": CLI_PARAM_TOL, "unshared_elements": noise, "elements": n,
           "unshared_share": noise / n, "unshared_param_max_abs_err": noise_err,
           "unshared_reach": reach,
           "mu_rel_err": (dmu2 / max(mu2, 1e-300)) ** 0.5, "mu_tol": CLI_MU_TOL}
    out["masters_pass"] = bool(law[0][0] <= CLI_PARAM_TOL and noise_err <= reach
                               and out["mu_rel_err"] <= CLI_MU_TOL)
    return out


def tool_call(label: str, main, argv, expected: dict, by_path: dict, card: str):
    """``main(argv)`` of a tool in-process with the launch counts set to 0
    just before: (its return value, stdout, s, launches ok)."""
    (out, s), launches = counted(lambda: timed_cli(main, argv))
    by_path[f"tools {label}"] = launches
    ok = check_launches(f"tools {label}", launches, expected)
    return out, s, ok


def run_tools_path():
    """The ten tools and ``run_net --train`` under ``torchrun`` on the card
    (UniVS-R50, seeded weights, bf16 unless stated): the CLI's two-rank
    data-parallel run against the one-process run (``run_cli_ddp``);
    ``extract_class_embeddings`` (the seeded RN50x4 tower, 64 names, ms a
    name and the 3,938-row bank extrapolated); ``bench_serving`` at B 1, 2
    and 4 (640x960, V=30, a warm-up and one timed run a B);
    ``bench_occupancy`` (floored and standard gates, a warm-up and one
    pipelined video each); ``profile_stages``;
    ``profile_gather``; ``analyze_model`` (parameters equal to the model's
    state_dict numel, the counter's FLOPs beside A/B/C's analytic part);
    ``probe_tent_sweep`` on the 1/16 level (A, E whole and windowed);
    ``semantic_feature_to_mask`` on a ``SemanticExtractionDriver`` run and
    ``show_results`` on a gates-open ``run_vis``, their PNGs and overlays
    read back by cv2.  Every call's launches against its expectation.
    Returns (ok, {path: launches})."""
    import math

    import cv2
    import torch

    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.inference.driver import EntityDriver, vis_results_to_ytvis_json
    from univs_tpu_torch.inference.fast_vis import SemanticExtractionDriver
    from univs_tpu_torch.inference.serving import BatchedVISServer
    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.tools import (analyze_model, bench_occupancy, bench_serving,
                                       extract_class_embeddings, probe_tent_sweep,
                                       profile_gather, profile_stages, semantic_feature_to_mask,
                                       show_results)

    phase_t0 = time.perf_counter()
    card = card_line()
    ok, by_path = run_cli_ddp("gloo")
    torch.cuda.empty_cache()
    cfg = UniVSConfig(dtype="bfloat16")
    layers = cfg.pixel_decoder.num_layers
    (H, W), V = FULL_HW, TOOLS_FRAMES
    with DataTree() as tree:
        root, frames = tree.root, tree.frames
        masters = seeded_masters(cfg)
        weights_path = os.path.join(root, "univs_r50.pt")
        torch.save(masters, weights_path)
        model = build_model(cfg, masters, device="cuda")
        del masters
        # the schedules of the benches' drivers (the server encodes a window
        # when i + T passes it, EntityDriver clamps the tail)
        srv_enc = BatchedVISServer(cfg, model, num_classes=40, capacity=40,
                                   batch_size=1).num_window_encodes(MAIN_PATH_FRAMES)
        drv_enc = EntityDriver(cfg, model, num_classes=40,
                               capacity=40).num_window_encodes(MAIN_PATH_FRAMES)

        # -- extract_class_embeddings ------------------------------------
        from univs_tpu_torch.data.category_info import COMBINED_DATASETS_CATEGORY_INFO

        # category_info holds row counts, not names: the bank's first rows
        # named by namespace and row (every name is 81 x 77 tokens alike)
        names = [f"{ns} {i}" for ns, (n, _) in COMBINED_DATASETS_CATEGORY_INFO.items()
                 for i in range(n)][:BANK_NAMES]
        names_path = os.path.join(root, "names.txt")
        with open(names_path, "w") as f:
            f.write("\n".join(names) + "\n")
        argv = ["--names", names_path, "--out", os.path.join(root, "bank.npy")]
        (bank, text), s, lok = tool_call("extract_class_embeddings", extract_class_embeddings.main,
                                         argv, expected_launches(0), by_path, card)
        # a second call, timed alone: the first builds the tower
        torch.cuda.synchronize()
        tower = extract_class_embeddings.text_encoder(None, "cuda")
        t0 = time.perf_counter()
        extract_class_embeddings.extract(tower, names)
        ms = (time.perf_counter() - t0) * 1e3
        del tower
        rec = {"tools": "extract_class_embeddings", "names": len(names),
               "shape": list(bank.shape), "finite": bool(np.isfinite(bank).all()),
               "printed": text.splitlines(), "cli_s": s, "ms_per_name": ms / len(names),
               "bank_3938_s_extrapolated": ms / len(names) * 3938 / 1e3,
               "launches_ok": lok, "card": card}
        rec["pass"] = bool(lok and rec["finite"] and bank.shape == (BANK_NAMES, 640))
        emit(rec)
        ok &= rec["pass"]

        # -- bench_serving at B 1, 2, 4 ----------------------------------
        iters = 1
        Bs = (1, 2, 4)
        (rows, text), s, lok = tool_call(
            "bench_serving", bench_serving.main, [*map(str, Bs), "--iters", str(iters)],
            expected_launches(len(Bs) * (1 + iters) * srv_enc, layers), by_path, card)
        rec = {"tools": "bench_serving", "rows": rows, "frames": MAIN_PATH_FRAMES,
               "height": H, "width": W, "timed_runs": iters, "cli_s": s, "launches_ok": lok,
               "card": card}
        rec["pass"] = bool(lok and [r["B"] for r in rows] == list(Bs)
                           and all(r["fps"] for r in rows))
        emit(rec)
        ok &= rec["pass"]
        torch.cuda.empty_cache()

        # -- bench_occupancy ---------------------------------------------
        (out, text), s, lok = tool_call(
            "bench_occupancy", bench_occupancy.main, ["--iters", str(iters)],
            expected_launches(2 * (1 + iters) * drv_enc, layers), by_path, card)
        rec = dict(out, tools="bench_occupancy", printed=text.splitlines(), cli_s=s,
                   launches_ok=lok, card=card)
        rec["pass"] = bool(lok and out["entities"] > out["entities_standard"])
        emit(rec)
        ok &= rec["pass"]

        # -- profile_stages / profile_gather -----------------------------
        (out, text), s, lok = tool_call("profile_stages", profile_stages.main, [],
                                        expected_launches(2 * 6, layers), by_path, card)
        rec = dict(out, tools="profile_stages", printed=text.splitlines(), cli_s=s,
                   launches_ok=lok, card=card)
        rec["pass"] = bool(lok)
        emit(rec)
        ok &= rec["pass"]
        (out, text), s, lok = tool_call(
            "profile_gather", profile_gather.main, [],
            expected_launches(0, 0, msda_sample=2 * 7, msda_rows=7), by_path, card)
        rec = dict(out, tools="profile_gather", printed=text.splitlines(), cli_s=s,
                   launches_ok=lok, card=card)
        rec["pass"] = bool(lok)
        emit(rec)
        ok &= rec["pass"]

        # -- analyze_model -----------------------------------------------
        (out, text), s, lok = tool_call("analyze_model", analyze_model.main, [],
                                        expected_launches(1, layers), by_path, card)
        numel = sum(t.numel() for t in build_model(UniVSConfig(), None,
                                                   device="cpu").state_dict().values())
        rec = dict(out, tools="analyze_model", printed=text.splitlines(), cli_s=s,
                   state_dict_numel=numel, launches_ok=lok, card=card)
        rec["pass"] = bool(lok and out["total_params"] == numel and out["kernels_added"])
        emit(rec)
        ok &= rec["pass"]

        # -- probe_tent_sweep, one level ---------------------------------
        calls = 1 + 2 + 10  # measure: one checked call, WARMUP + ITERS timed
        n_plane = 1 + len(probe_tent_sweep.WINDOWS[SWEEP_LEVEL])
        (records, text), s, lok = tool_call(
            "probe_tent_sweep", probe_tent_sweep.main, ["--levels", str(SWEEP_LEVEL)],
            expected_launches(0, 0, msda_sample=calls, msda_tent_plane=n_plane * calls),
            by_path, card)
        rec = {"tools": "probe_tent_sweep", "records": records, "cli_s": s,
               "launches_ok": lok, "card": card}
        rec["pass"] = bool(lok and all(r["pass"] for r in records))
        emit(rec)
        ok &= rec["pass"]
        torch.cuda.empty_cache()

        # -- semantic_feature_to_mask on an extraction run ---------------
        bank40 = np.random.RandomState(3).randn(40, cfg.decoder.clip_cls_emb_dim).astype(np.float32)
        ext = SemanticExtractionDriver(cfg, model)
        (toks, mfs), launches = counted(lambda: ext.run(frames, torch.as_tensor(bank40).cuda()))
        by_path["tools semantic extraction run"] = launches
        lok = check_launches("tools semantic extraction run", launches,
                             expected_launches(math.ceil(V / cfg.inference.num_frames), layers))
        npz = os.path.join(root, "features.npz")
        np.savez(npz, obj_tokens=toks, mask_feats=mfs, cls_emb=bank40)
        sem_out = os.path.join(root, "semantic")
        (summary, text), s, lok2 = tool_call(
            "semantic_feature_to_mask", semantic_feature_to_mask.main,
            [npz, "--weights", weights_path, "--all", "--out", sem_out],
            expected_launches(0), by_path, card)
        pngs = sorted(f for f in os.listdir(sem_out) if f.endswith(".png"))
        grids = [cv2.imread(os.path.join(sem_out, f), cv2.IMREAD_GRAYSCALE) for f in pngs]
        Q = cfg.decoder.num_queries
        rec = {"tools": "semantic_feature_to_mask", "frames": V, "kept": len(
            summary["kept_queries"]), "shape": summary["shape"], "pngs": len(pngs),
            "png_shapes": sorted({tuple(g.shape) for g in grids if g is not None}),
            "cli_s": s, "launches_ok": lok and lok2, "card": card}
        rec["pass"] = bool(lok and lok2 and len(pngs) == math.ceil(Q / 10)
                           and all(g is not None for g in grids)
                           and summary["shape"] == [Q, V, H // 32, W // 32])
        emit(rec)
        ok &= rec["pass"]

        # -- show_results on a run_vis -----------------------------------
        open_cfg = with_gates_open(cfg)
        driver = EntityDriver(open_cfg, model, num_classes=40,
                              capacity=open_cfg.inference.max_num_instances)
        ents, launches = counted(lambda: driver.run_vis(frames, torch.as_tensor(bank40).cuda()))
        by_path["tools show_results run_vis"] = launches
        lok = check_launches("tools show_results run_vis", launches,
                             expected_launches(driver.num_window_encodes(V), layers))
        preds = vis_results_to_ytvis_json(1, V, H, W, ents, apply_cls_thresh=0.0,
                                          topk_per_video=5)
        results_path = os.path.join(root, "results.json")
        with open(results_path, "w") as f:
            json.dump(preds, f)
        viz = os.path.join(root, "viz")
        (written, text), s, lok2 = tool_call(
            "show_results", show_results.main,
            ["--results", results_path, "--dataset", ENTRY_DATASET, "--output", viz,
             "--conf", "0.0"], expected_launches(0), by_path, card)
        n = video_frame_count(written[0][0]) if written else 0
        rec = {"tools": "show_results", "entities": len(ents), "predictions": len(preds),
               "written": [[os.path.basename(p), f, k] for p, f, k in written],
               "frames_read_back": n, "printed": text.splitlines(), "cli_s": s,
               "launches_ok": lok and lok2, "card": card}
        rec["pass"] = bool(lok and lok2 and len(ents) > 0 and n == V)
        emit(rec)
        ok &= rec["pass"]
        del driver, ext, model
    torch.cuda.empty_cache()
    emit({"tools": "phase", "phase_s": time.perf_counter() - phase_t0, "pass": bool(ok),
          "card": card})
    return bool(ok), by_path


def main(argv) -> int:
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

    if argv[:1] == ["run_net_rank"]:
        # one torchrun rank of the tools phase's data-parallel CLI run
        return run_net_rank(argv[1], argv[2:])

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({card}), torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = kernels.build()
    for n, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"ptxas {n}: {line.strip()}")
    log(f"build: {len(logs)} kernel(s) in {time.perf_counter() - t0:.1f} s")

    if argv == ["ddp"]:
        # data parallelism over NCCL, one process a card, on a machine with
        # two or more cards (the default run checks the same step on gloo,
        # two processes on cuda:0)
        if torch.cuda.device_count() < 2:
            log(f"ddp needs two cards, {torch.cuda.device_count()} visible")
            return 1
        ok, _ = run_ddp_path("nccl")
        cli_ok, _ = run_cli_ddp("nccl")
        ok &= cli_ok
        print(card, flush=True)
        if not ok:
            log("FAILED")
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if argv == ["eval"]:
        # the evaluation phase alone: the engine's seven routes at full
        # width, then the tiny card-vs-CPU engine check
        from univs_tpu_torch.config import UniVSConfig
        from univs_tpu_torch.models.univs import build_model

        ok, _ = run_eval_path(build_model(UniVSConfig(dtype="bfloat16"), None, seed=0,
                                          device="cuda"))
        ok &= reference_check_engine()
        print(card, flush=True)
        if not ok:
            log("FAILED")
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if argv == ["tools"]:
        # run_net --train under torchrun and the ten tools alone
        ok, _ = run_tools_path()
        print(card, flush=True)
        if not ok:
            log("FAILED")
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if argv == ["entry"]:
        # weight intake and the entry points alone
        ok, _ = run_entry_path()
        print(card, flush=True)
        if not ok:
            log("FAILED")
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if argv == ["pipeline"]:
        # the two-device pipelining phase alone, for a machine with two or
        # more cards (the default run has one: the pipeline there is
        # cuda:0 -> cuda:0)
        from univs_tpu_torch.config import UniVSConfig
        from univs_tpu_torch.models.univs import build_model

        ok, _ = run_pipeline_path(build_model(UniVSConfig(dtype="bfloat16"), None, seed=0,
                                              device="cuda"))
        print(card, flush=True)
        if not ok:
            log("FAILED")
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    results: dict = {}
    ok = kernel_checks(results)
    ok &= probe_kernel_checks(results)
    ok &= plane_edge_checks()
    by_path = {}
    path_ok, by_path["tools probes"] = run_probe_path()
    ok &= path_ok
    path_ok, by_path["ms_deform_attn"] = run_op_path(results)
    ok &= path_ok
    path_ok, by_path["run_vis"], vis_driver = run_main_path()
    ok &= path_ok
    for name, run in (("run_vss", run_vss_path), ("run_vps", run_vps_path),
                      ("run_vos", run_vos_path), ("run_grounding", run_grounding_path),
                      ("vl_pixel_decoder", run_vl_decoder_path)):
        path_ok, by_path[name] = run(vis_driver.model)
        ok &= path_ok
    path_ok, fast_paths = run_fast_paths(vis_driver.model)
    ok &= path_ok
    by_path.update(fast_paths)
    for name, run in (("BatchedVISServer", run_serving_path),
                      ("pipeline_devices", run_pipeline_path)):
        path_ok, by_path[name] = run(vis_driver.model)
        ok &= path_ok
    path_ok, by_path["bf16 vs float32 reading"] = run_dtype_reading(vis_driver.model)
    ok &= path_ok
    del vis_driver
    torch.cuda.empty_cache()
    ok &= grad_checks()
    path_ok, train_paths = run_train_path()
    ok &= path_ok
    by_path.update(train_paths)
    for name, run in (("train boxvis", run_boxvis_path),
                      ("train long_video", run_long_video_path),
                      ("train ddp gloo", lambda: run_ddp_path("gloo"))):
        path_ok, by_path[name] = run()
        ok &= path_ok
    path_ok, remat_paths = run_remat_paths()
    ok &= path_ok
    by_path.update(remat_paths)
    for name, run in (("run_vis swin_large", run_swin_path), ("run_vis pvt_v2_b2", run_pvt_path)):
        path_ok, by_path[name] = run()
        ok &= path_ok
    from univs_tpu_torch.config import UniVSConfig
    from univs_tpu_torch.models.univs import build_model

    path_ok, eval_paths = run_eval_path(build_model(UniVSConfig(dtype="bfloat16"), None, seed=0,
                                                    device="cuda"))
    ok &= path_ok
    by_path.update(eval_paths)
    torch.cuda.empty_cache()
    path_ok, entry_paths = run_entry_path()
    ok &= path_ok
    by_path.update(entry_paths)
    torch.cuda.empty_cache()
    path_ok, tools_paths = run_tools_path()
    ok &= path_ok
    by_path.update(tools_paths)
    ok &= reference_check()
    ok &= reference_check_vss()
    ok &= reference_check_vps()
    ok &= reference_check_vos()
    ok &= reference_check_grounding()
    for name in ("swin_tiny", "pvt_v2_b0"):
        ok &= reference_check_backbone(name)
    ok &= reference_check_vl_decoder()
    ok &= reference_check_fast_vis()
    ok &= reference_check_image()
    ok &= reference_check_train()
    ok &= reference_check_engine()

    rows = []
    for name in kernels.KERNELS:
        r = results[name]
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
        }
        for key in ("product_linear_ms", "body", "unfused_ms", "products_ms"):
            if key in r:
                row[key] = r[key]
        # the row is one mode (D: the int8 slab; E: psum over the whole
        # level; F: the base law); the kernel's other modes beside it
        modes = {k.split("/", 1)[1]: {"ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
                                      "bound_ms": d["bound_ms"], "max_abs_err": d["max_abs_err"]}
                 for k, d in results.items() if k.startswith(name + "/")}
        if modes:
            row["modes"] = modes
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    if not ok:
        log("FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
