"""ResNet backbone with frozen BN (counterpart of
``univs_tpu/models/backbones/resnet.py``).

torchvision geometry (stride in the 3x3), frozen BN as one per-channel
multiply-add computed in float32 and applied in the compute dtype.
Input and outputs are NHWC at the module boundary, as in the JAX
package; inside, convolutions run NCHW in channels-last memory format
(the permutes at the boundary are then free).  Module names follow the
flax tree (``stem_conv``, ``res2_block0.conv1`` ...) so the weight
bridge maps them one to one.

Feature strides: res2=4, res3=8, res4=16, res5=32.  The ``resnet``
family of ``models/backbones/__init__.py``: ``build`` and ``flops``;
``pad_same`` is the flax "SAME" padding other families need for their
strided convs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.Module):
    """Per-channel affine from frozen statistics (weight, bias,
    running_mean, running_var)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        f32 = torch.float32
        mul = self.weight.to(f32) * (self.running_var.to(f32) + self.eps) ** -0.5
        add = self.bias.to(f32) - self.running_mean.to(f32) * mul
        return x * mul.to(x.dtype)[None, :, None, None] + add.to(x.dtype)[None, :, None, None]


def pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW map as flax's default ``padding="SAME"`` does for a
    k x k conv of this stride: ceil(n / stride) outputs, the padding split
    low = total // 2, high = the rest."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv(cin, cout, k, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, mid, 1)
        self.bn1 = FrozenBatchNorm(mid)
        self.conv2 = _conv(mid, mid, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(mid)
        self.conv3 = _conv(mid, cout, 1)
        self.bn3 = FrozenBatchNorm(cout)
        self.has_shortcut = cin != cout or stride != 1
        if self.has_shortcut:
            self.shortcut = _conv(cin, cout, 1, stride)
            self.shortcut_bn = FrozenBatchNorm(cout)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = self.shortcut_bn(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(y + r)


_STAGE_SPECS = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class ResNet(nn.Module):
    """ResNet trunk: [N, H, W, 3] normalized images -> {res2..res5} NHWC."""

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.out_channels = {f"res{s + 2}": 256 * 2 ** s for s in range(4)}
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = FrozenBatchNorm(64)
        self.block_names = []
        cin = 64
        for s, (nb, cout) in enumerate(zip(_STAGE_SPECS[depth], (256, 512, 1024, 2048))):
            names = []
            for b in range(nb):
                stride = 2 if (b == 0 and s > 0) else 1
                name = f"res{s + 2}_block{b}"
                setattr(self, name, Bottleneck(cin, cout // 4, cout, stride))
                names.append(name)
                cin = cout
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        dtype = self.stem_conv.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = {}
        for s, names in enumerate(self.block_names):
            for n in names:
                x = getattr(self, n)(x)
            key = f"res{s + 2}"
            if key in self.out_features:
                outs[key] = x.permute(0, 2, 3, 1)  # NHWC view
        return outs


def build(cfg) -> nn.Module:
    """The ``resnet*`` family's backbone from a BackboneConfig
    (``resnet_depth``, ``out_features``)."""
    return ResNet(depth=cfg.resnet_depth, out_features=cfg.out_features)


def resnet_flops(depth: int, H: int, W: int) -> Tuple[float, Dict[str, int]]:
    """One frame through a torchvision-style ResNet (stride in the 3x3)
    -> (operations, {res2..res5: channels})."""
    from benchmark.harness.flops import ceil_div, conv

    h, w = ceil_div(H, 2), ceil_div(W, 2)
    ops = conv(7, 3, 64, h, w)
    h, w = ceil_div(h, 2), ceil_div(w, 2)  # max pool
    cin, chans = 64, {}
    for s, (nb, cout) in enumerate(zip(_STAGE_SPECS[depth], (256, 512, 1024, 2048))):
        mid = cout // 4
        for b in range(nb):
            stride = 2 if (b == 0 and s > 0) else 1
            ho, wo = ceil_div(h, stride), ceil_div(w, stride)
            ops += conv(1, cin, mid, h, w) + conv(3, mid, mid, ho, wo) + conv(1, mid, cout, ho, wo)
            if cin != cout or stride != 1:
                ops += conv(1, cin, cout, ho, wo)
            cin, h, w = cout, ho, wo
        chans[f"res{s + 2}"] = cout
    return ops, chans


def flops(tree: dict, H: int, W: int) -> Tuple[float, Dict[str, int]]:
    """One frame of the configuration's ``backbone`` tree."""
    return resnet_flops(tree["resnet_depth"], H, W)
