"""Model analysis: parameter counts + forward FLOPs (counterpart of the JAX
package's ``tools/analyze_model.py``, with its arguments, its printed lines
and ``--device``).

Equivalent of the reference's tools/analyze_model.py (fvcore FLOPs).  The
JAX tool reads XLA's cost analysis of the jitted forward; here:

- parameters: every tensor of the model's state_dict, in total and per
  top-level module (backbone, decoder, pixel_decoder: the flax tree's top
  level; the frozen BN statistics are buffers here and parameters there,
  so both count them);
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one detection
  forward, plus the pixel decoder's kernels A (``msda_sample``), B
  (``msda_rows``) and C (``fused_ffn_ln``) counted analytically per call:
  they are launched through ctypes, which the counter does not see.  The
  two parts are printed apart.  On the CPU the kernels run as their plain
  laws, whose products the counter does see; the total is then the
  counter's alone;
- bytes accessed: PyTorch has no counter for them, so none is printed.

    python -m univs_tpu_torch.tools.analyze_model --backbone resnet50
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

K = 40


def parameter_counts(cfg) -> Dict[str, int]:
    """{top-level module: tensors' numel} of the model's state_dict, built
    on the meta device (no memory, no init)."""
    from univs_tpu_torch.models.univs import UniVSModel

    with torch.device("meta"):
        model = UniVSModel(cfg)
    return {name: sum(t.numel() for t in child.state_dict().values())
            for name, child in sorted(model.named_children())}


def encoder_layer_ops(N: int, Lq: int, C: int, M: int, L: int, P: int, F: int) -> Dict[str, float]:
    """Operations of one deformable encoder layer's kernels on N frames of
    Lq tokens: B's two projections (3 M L P outputs a token), A's 4 corner
    products and sums a sample and channel, C's two FFN products."""
    D = C // M
    return {"msda_rows": 2.0 * N * Lq * C * (3 * M * L * P),
            "msda_sample": 2.0 * N * Lq * M * L * P * 4 * D,
            "fused_ffn_ln": 4.0 * N * Lq * C * F}


def kernel_ops(model) -> tuple:
    """Hooks on the pixel decoder's encoder layers that add each call's
    analytic kernel operations to the returned dict; (ops, handles)."""
    from univs_tpu_torch.models.pixel_decoder import DeformableEncoderLayer

    ops = {"msda_rows": 0.0, "msda_sample": 0.0, "fused_ffn_ln": 0.0, "calls": 0}

    def hook(layer, args):
        src, _, shapes = args
        a = layer.self_attn
        for k, v in encoder_layer_ops(src.shape[0], src.shape[1], src.shape[2], a.n_heads,
                                      len(shapes), a.n_points, layer.linear1.out_features).items():
            ops[k] += v
        ops["calls"] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, DeformableEncoderLayer)]
    return ops, handles


@torch.no_grad()
def forward_flops(cfg, device, h: int, w: int, t: int, seed: int = 0) -> Dict:
    """One detection forward of ``cfg``'s seeded model on a [1, t, h, w]
    clip with K=40 classes: the counter's FLOPs, the kernels' analytic
    operations and their launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from univs_tpu_torch.models.univs import build_model
    from univs_tpu_torch.ops import kernels
    from univs_tpu_torch.structures import TextPrompts

    model = build_model(cfg, None, seed=seed, device=device)
    rng = np.random.RandomState(seed)
    images = torch.zeros((1, t, h, w, 3), device=device)
    fi = torch.arange(t, device=device)[None]
    cls_emb = torch.as_tensor(rng.randn(K, cfg.decoder.clip_cls_emb_dim).astype(np.float32),
                              device=device)
    tp = TextPrompts(embs=cls_emb[None, :, None, :],
                     valid=torch.ones((1, K), dtype=torch.bool, device=device))
    ops, handles = kernel_ops(model)
    before = kernels.launch_counts()
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            model(images, fi, task="detection", text_prompts=tp, cls_emb=cls_emb)
    finally:
        for hd in handles:
            hd.remove()
    launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    return {"counter_flops": float(counter.get_total_flops()),
            "kernel_ops": {k: ops[k] for k in ("msda_rows", "msda_sample", "fused_ffn_ln")},
            "encoder_layer_calls": ops["calls"], "launches": launches}


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--tiny", action="store_true", help="the tiny test config")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card when absent (raises without one), "
                        "'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from univs_tpu_torch.config import BackboneConfig, UniVSConfig, tiny_test_config
    from univs_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (tiny_test_config() if args.tiny
           else UniVSConfig(backbone=BackboneConfig(name=args.backbone)))
    counts = parameter_counts(cfg)
    total = sum(counts.values())
    print(f"total params: {total / 1e6:.2f}M")
    for name, n in counts.items():
        print(f"  {name}: {n / 1e6:.2f}M")

    h, w, t = args.height, args.width, args.frames
    f = forward_flops(cfg, device, h, w, t)
    kernel = sum(f["kernel_ops"].values())
    launched = all(f["launches"][k] == f["encoder_layer_calls"] for k in f["kernel_ops"])
    flops = f["counter_flops"] + (kernel if launched else 0.0)
    print(f"forward FLOPs ({h}x{w}, T={t}): {flops / 1e9:.1f} GFLOPs")
    print(f"  flop counter: {f['counter_flops'] / 1e9:.1f} GFLOPs")
    where = ("added: launched through ctypes, unseen by the counter" if launched else
             "not added: the plain laws ran, and the counter counts their products")
    print(f"  kernels A/B/C (analytic, {f['encoder_layer_calls']} encoder layers): "
          f"{kernel / 1e9:.1f} GFLOPs ({where}): "
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in f["kernel_ops"].items()))
    print("bytes accessed: not measured (PyTorch has no counter for them)")
    return dict(f, params=counts, total_params=total, flops=flops, kernels_added=launched)


if __name__ == "__main__":
    main()
