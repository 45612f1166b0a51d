"""Port of ``tools/probe_tent_kernel.py``: the separable tent per sample.

Bilinear interpolation weights are the tent ``max(1 - |i - x|, 0)`` on
the integer grid, zero padding included.  Per (frame, head, level) and
sample row (a query's point), without the attention weight:

    mx_i = T(tent(i - x)),  t1_j = sum_i mx_i V[j, i, :],
    out  = sum_j T(tent(j - y) * t1_j)

This is kernel F (``ops/msda_probes.py:msda_tent_probe``, law
``'kernel'``) over the d-major slab [N, M, W, D*H]; the attention weight
and the point sum stay in torch, as the probe does them in XLA.  Beside
it, kernel A on the same inputs, at the probe's geometry: levels
(20, 30), (40, 60), (80, 120), 5 frames, 8 heads, D=32, 4 points, a bf16
value.

    python -m univs_tpu_torch.tools.probe_tent_kernel
"""

from __future__ import annotations

import numpy as np
import torch

from univs_tpu_torch import tools
from univs_tpu_torch.ops import msda_probes
from univs_tpu_torch.utils.device import resolve_device

LEVELS = [(20, 30), (40, 60), (80, 120)]
N, M, D, P = 5, 8, 32, 4


def msda_tent(v_xmajor, xs, ys, *, bq=None, head_dim=D):
    """v_xmajor [N, M, W, D*H] (d-major: element (i; d*H + j) = V[j, i, d]),
    xs / ys [N, R4, M] float32 pixel coordinates -> [N, R4, M, D] float32
    samples, zero padding by the tent.  ``bq`` is the TPU kernel's tile,
    kept for parity with the JAX probe: R4 must be a multiple of it, and
    it does not change the result (nothing here to tune)."""
    if bq is not None and xs.shape[1] % bq:
        raise ValueError(f"msda_tent: {xs.shape[1]} rows are not a multiple of {bq}")
    return msda_probes.msda_tent_probe(v_xmajor, xs, ys, None, head_dim, 1, "kernel", "dmajor")


def make_inputs(seed, levels=LEVELS, n=N, m=M, d=D, p=P, dtype=torch.bfloat16):
    """The probe's inputs from ``seed``: value [n, S, m, d], locations
    [n, Lq, m, L, p, 2] in [0, 1] and softmaxed weights [n, Lq, m, L, p]."""
    r = np.random.RandomState(seed)
    S = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.as_tensor(r.randn(n, S, m, d)).to(dtype)
    loc = torch.as_tensor(r.rand(n, S, m, L, p, 2).astype(np.float32))
    logits = torch.as_tensor(np.asarray(r.randn(n, S, m, L * p), np.float32))
    attn = torch.softmax(logits, -1).reshape(n, S, m, L, p)
    return value, loc, attn


def level_slab(value, start, h, w):
    """The value of one level [n, h*w, m, d] -> the d-major slab
    [n, m, w, d*h]."""
    n, _, m, d = value.shape
    vl = value[:, start:start + h * w]
    return vl.permute(0, 2, 1, 3).reshape(n, m, h, w, d).permute(0, 1, 3, 4, 2).reshape(
        n, m, w, d * h).contiguous()


def run(device=None, *, levels=LEVELS, n=N, m=M, d=D, p=P, dtype=torch.bfloat16):
    """The probe at its geometry: per level, kernel A and the tent probe
    with the weights and the point sum in torch; a list of records."""
    dev = resolve_device(device)
    value, loc, attn = (t.to(dev) for t in make_inputs(0, levels, n, m, d, p, dtype))
    lq = value.shape[1]
    records = []
    start = 0
    for lid, (h, w) in enumerate(levels):
        slab = level_slab(value, start, h, w)
        loc_l, wa_l = loc[:, :, :, lid], attn[:, :, :, lid]  # [n, Lq, m, p, 2], [n, Lq, m, p]
        x = (loc_l[..., 0] * w - 0.5).permute(0, 1, 3, 2).reshape(n, lq * p, m).contiguous()
        y = (loc_l[..., 1] * h - 0.5).permute(0, 1, 3, 2).reshape(n, lq * p, m).contiguous()
        wa = wa_l.permute(0, 1, 3, 2).contiguous()  # [n, Lq, p, m]

        def f(slab=slab, x=x, y=y, wa=wa):
            out = msda_tent(slab, x, y, head_dim=d).reshape(n, lq, p, m, d)
            return (out * wa[..., None]).sum(dim=2)

        vl = value[:, start:start + h * w]
        loc6 = tools.loc_from_pointminor(x, y, wa.reshape(n, lq * p, m), p)
        want = tools.f32_law(vl, (h, w), loc6)
        level = dict(probe="kernel", level=[h, w], dtype=str(dtype).replace("torch.", ""))
        records.append(tools.kernel_a(vl.contiguous(), (h, w), loc6, want, dev, **level))
        records.append(tools.measure(f, want, tools.TOL[dtype], dev, formulation="tent",
                                     kernel="msda_tent_probe", **level))
        start += h * w
    return records


def main():
    tools.print_records(run())


if __name__ == "__main__":
    main()
