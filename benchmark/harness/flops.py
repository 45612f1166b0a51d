"""Operations and bytes from the configuration's shapes, and the card's
published peaks.

The counts follow the published architecture, not whatever implements
it: a later change that removes work from the program does not shrink
them.  A product of an [m, k] and a [k, n] matrix is 2 m k n
operations; elementwise work (norms, activations, softmax, resizes) is
not counted.  A backbone is counted by its family's module
(``reference/models/backbones/<family>.py``, ``flops``), with ``conv``
and ``ceil_div`` from here; Swin's window attention on the map padded
to whole windows, as the published model computes it.  Deformable
sampling counts 4 corner products and sums a sample and channel, as
kernel A's bound does.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


def conv(k: int, cin: int, cout: int, h: int, w: int) -> float:
    return 2.0 * k * k * cin * cout * h * w


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def level_shapes(H: int, W: int) -> Tuple[Tuple[int, int], ...]:
    """The deformable encoder's levels, coarse to fine (1/32, 1/16, 1/8)."""
    return tuple((ceil_div(H, s), ceil_div(W, s)) for s in (32, 16, 8))


def encoder_layer_ops(N: int, S: int, C: int, M: int, L: int, P: int, F: int) -> Dict[str, float]:
    """Operations of one deformable encoder layer's three kernels on N
    frames of S tokens: B's two projections (3 M L P outputs a token),
    A's 4 corner products and sums a sample and channel, C's FFN."""
    D = C // M
    return {"msda_rows": 2.0 * N * S * C * (3 * M * L * P),
            "msda_sample": 2.0 * N * S * M * L * P * 4 * D,
            "fused_ffn_ln": 4.0 * N * S * C * F}


def kernel_work(name: str, N: int, shapes: Sequence[Tuple[int, int]], C: int, M: int, P: int,
                F: int, elem: int = 2) -> Dict[str, float]:
    """One call of an encoder kernel at its main-path shape: operations,
    bytes (each input read once, each output written once; activations
    and weights in the compute dtype of ``elem`` bytes, biases, norm
    vectors and the sample rows in float32) and the bound in ms,
    max(bytes / HBM rate, operations / the peak of their type)."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    act = N * S * C * elem
    rows = N * S * M * L * P * 3 * 4
    if name == "msda_sample":
        byts, rate = act + rows + act, F32_FLOPS
    elif name == "msda_rows":
        byts = act + 3 * M * L * P * C * elem + 3 * M * L * P * 4 + rows
        rate = BF16_TENSOR_FLOPS
    elif name == "fused_ffn_ln":
        byts = 3 * act + 2 * C * F * elem + (5 * C + F) * 4
        rate = BF16_TENSOR_FLOPS
    else:
        raise KeyError(name)
    ops = encoder_layer_ops(N, S, C, M, L, P, F)[name]
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"ops": ops, "bytes": byts, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def backbone_flops(model: dict, H: int, W: int) -> Tuple[float, Dict[str, int]]:
    """One frame through the backbone, counted by its family's ``flops``
    (``reference/models/backbones/<family>.py``)."""
    from benchmark.reference.models.backbones import family

    b = model["backbone"]
    return family(b["name"]).flops(b, H, W)


def pixel_decoder_flops(model: dict, H: int, W: int, chans: Dict[str, int]) -> float:
    """One frame: input projections, the deformable encoder layers, the
    FPN step to 1/4 and the mask-features conv."""
    p = model["pixel_decoder"]
    C, M, P, F, nl = p["hidden_dim"], p["num_heads"], p["num_points"], p["ffn_dim"], p["num_layers"]
    shapes = level_shapes(H, W)
    names = list(p["transformer_in_features"])[::-1]
    ops = sum(2.0 * chans[n] * C * h * w for n, (h, w) in zip(names, shapes))
    S = sum(h * w for h, w in shapes)
    per_layer = 4.0 * S * C * C + sum(encoder_layer_ops(1, S, C, M, len(shapes), P, F).values())
    ops += nl * per_layer
    h4, w4 = ceil_div(H, 4), ceil_div(W, 4)
    ops += 2.0 * chans["res2"] * C * h4 * w4 + conv(3, C, C, h4, w4) + 2.0 * C * p["mask_dim"] * h4 * w4
    return ops


def decoder_flops(model: dict, H: int, W: int, T: int, K: int, num_prompts: int = 0,
                  prompt_tokens: int = 0, train: bool = False) -> float:
    """One decode of a T-frame clip: the learnable queries plus
    ``num_prompts`` prompt queries (ProCA over ``prompt_tokens`` keys at
    layer 0 and every later layer); masked cross-attention, the
    spatio-temporal self-attention, the FFN, and the prediction heads
    (the mask embedding and the attention mask at every call, classes and
    full-resolution masks at the last, or at every call in training)."""
    d = model["decoder"]
    C, Fd, nl, Cm, Dt = d["hidden_dim"], d["ffn_dim"], d["num_layers"], d["mask_dim"], d["clip_cls_emb_dim"]
    Q = d["num_queries"] + num_prompts
    shapes = level_shapes(H, W)
    h4, w4 = ceil_div(H, 4), ceil_div(W, 4)
    ops = 0.0

    def proca():
        if not num_prompts:
            return 0.0
        keys = T + prompt_tokens
        return (4.0 * num_prompts * T * C * C + 4.0 * num_prompts * keys * C * C
                + 4.0 * num_prompts * T * keys * C)

    def heads(full: bool, hw_small: int):
        out = 3 * 2.0 * T * Q * C * C + 2.0 * T * Q * Cm * hw_small
        if full:
            out += 2.0 * T * Q * C * Dt + 2.0 * T * Q * Dt * K + 2.0 * T * Q * Cm * h4 * w4
        return out

    ops += proca()
    ops += heads(train, shapes[0][0] * shapes[0][1])
    for i in range(nl):
        if i > 0:
            ops += proca()
        h, w = shapes[i % len(shapes)]
        S = h * w
        ops += 4.0 * T * Q * C * C + 4.0 * T * S * C * C + 4.0 * T * Q * S * C   # cross
        ops += 8.0 * T * Q * C * C + 4.0 * (T * Q) ** 2 * C                     # self
        ops += 4.0 * T * Q * C * Fd                                              # FFN
        nh, nw = shapes[(i + 1) % len(shapes)]
        ops += heads(train or i == nl - 1, nh * nw)
    return ops


def encode_flops(model: dict, H: int, W: int) -> float:
    """Backbone and pixel decoder of one frame."""
    bb, chans = backbone_flops(model, H, W)
    return bb + pixel_decoder_flops(model, H, W, chans)


def frame_flops(kind: str, model: dict, traffic: dict) -> float:
    """The model operations of one frame of a traffic kind's video, all
    stages: VIS encodes each frame once and decodes every clip (stride 1)
    with the pool's prompt queries; VSS encodes each frame once and
    decodes each clip of T frames with the learnable queries alone."""
    H, W, V = traffic["height"], traffic["width"], traffic["frames"]
    inf, K = model["inference"], traffic["classes"]
    T, stride = inf["num_frames"], inf["clip_stride"]
    enc = encode_flops(model, H, W)
    if kind == "vis_stream":
        clips = len(range(0, max(V - T, 0) + 1, stride))
        prompt_tokens = (1 + model["prompt"]["num_prev_frames_memory"]) * model["prompt"][
            "num_dense_points_test"]
        dec = decoder_flops(model, H, W, T, K, traffic["capacity"], prompt_tokens)
        return enc + clips * dec / V
    if kind == "vss_stream":
        return enc + decoder_flops(model, H, W, T, K) / T
    raise KeyError(kind)


def train_clip_flops(model: dict, traffic: dict) -> float:
    """Forward and backward (twice the forward) of one training clip of
    the detection task: T frames encoded, the decoder with every head's
    outputs (deep supervision) and the category prompts' slots as prompt
    queries, whose one token each first attends to every level's tokens
    of each frame (``lang2vision``)."""
    H, W, T, Qp = traffic["height"], traffic["width"], traffic["frames"], traffic["slots"]
    d = model["decoder"]
    C = d["hidden_dim"]
    S = sum(h * w for h, w in level_shapes(H, W))
    l2v = 4.0 * T * Qp * C * C + 4.0 * T * S * C * C + 4.0 * T * Qp * S * C
    fwd = (T * encode_flops(model, H, W)
           + decoder_flops(model, H, W, T, d["num_classes"], Qp, 1, train=True) + l2v)
    return 3.0 * fwd
