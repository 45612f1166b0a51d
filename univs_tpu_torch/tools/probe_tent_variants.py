"""Port of ``tools/probe_tent_variants.py``: micro-variants of the base
tent kernel's law at the dominant 1/8-level geometry.

Per sample row, ``mx = bf16(tent(i - x) * wa)``, ``t1 = mx @ V`` in f32,
``p2 = bf16(tent(j - y) * t1)``, each row's sum rounded to bf16 before
the point sum (the probe hard-codes bf16 whatever the slab's dtype):

  base   — as above;
  b16t1  — t1 rounded to bf16;
  b16all — t1 and the y tent rounded to bf16;
  gridm  — base's law under another TPU grid order (heads outermost).

This is kernel F (``ops/msda_probes.py:msda_tent_probe``) over the
d-major slab [N, M, W, D*H], beside kernel A on the same inputs, at the
probe's geometry: H, W = 80, 120, 5 frames, 8 heads, 4 points, D=32,
12,600 queries, a bf16 slab.

    python -m univs_tpu_torch.tools.probe_tent_variants
"""

from __future__ import annotations

import numpy as np
import torch

from univs_tpu_torch import tools
from univs_tpu_torch.ops import msda_probes
from univs_tpu_torch.utils.device import resolve_device

VARIANTS = ("base", "b16t1", "b16all", "gridm")


def run_level(slab, xs, ys, was, D, P, variant):
    """slab [N, M, W, D*H] d-major, xs / ys / was [N, R, M] float32
    point-minor (R a multiple of P) -> [N, R / P, M, D] float32: the rows
    of each query's P points, each rounded to bf16, summed in f32."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    law = "base" if variant == "gridm" else variant
    return msda_probes.msda_tent_probe(slab, xs, ys, was, D, P, law, "dmajor")


def run(device=None, *, H=80, W=120, D=32, M=8, P=4, N=5, Lq=12600, dtype=torch.bfloat16):
    """The probe at its geometry: kernel A and each variant on one level
    of uniformly spread samples; a list of records."""
    dev = resolve_device(device)
    R = Lq * P
    rng = np.random.RandomState(0)
    slab = torch.as_tensor(rng.randn(N, M, W, D * H)).to(dtype).to(dev)
    xs, ys, was = (torch.as_tensor(np.asarray(a, np.float32)).to(dev)
                   for a in (rng.rand(N, R, M) * W, rng.rand(N, R, M) * H, rng.rand(N, R, M)))
    value = msda_probes.slab_raster(slab, D, "dmajor").permute(0, 2, 1, 3).contiguous()
    loc = tools.loc_from_pointminor(xs, ys, was, P)
    want = tools.f32_law(value, (H, W), loc)
    level = dict(probe="variants", level=[H, W], dtype=str(dtype).replace("torch.", ""))
    records = [tools.kernel_a(value, (H, W), loc, want, dev, **level)]
    for variant in VARIANTS:
        records.append(tools.measure(
            lambda v=variant: run_level(slab, xs, ys, was, D, P, v), want,
            tools.TOL[torch.bfloat16], dev, formulation=variant, kernel="msda_tent_probe",
            **level))
    return records


def main():
    tools.print_records(run())


if __name__ == "__main__":
    main()
