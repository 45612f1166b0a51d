"""3D sine positional encodings (counterpart of
``univs_tpu/ops/position_encoding.py``).

x/y use ``num_pos_feats = C/2`` channels each (interleaved sin/cos), z
uses the full ``C`` channels and is ADDED to concat(pos_y, pos_x).
FixedT: z = (frame + 1) normalized over the clip; ArbitraryT: z =
absolute frame index / num_max_frames.  Computed in float32 on the
requested device; callers cast to the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _dim_t(num_feats: int, temperature: float, device) -> torch.Tensor:
    """temperature ** (2 * (i // 2) / num_feats) for i in [0, num_feats)."""
    i = torch.arange(num_feats, dtype=torch.float32, device=device)
    return torch.tensor(temperature, dtype=torch.float32, device=device) ** (
        2.0 * torch.floor(i / 2.0) / num_feats
    )


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """stack(sin(x[..., 0::2]), cos(x[..., 1::2])) interleaved on the last dim."""
    s = torch.sin(x[..., 0::2])
    c = torch.cos(x[..., 1::2])
    return torch.stack([s, c], dim=-1).reshape(*x.shape[:-1], -1)


class SinePositionEncoding3D:
    """Stateless 3D sine PE generator (no parameters)."""

    def __init__(
        self,
        num_pos_feats: int = 128,
        temperature: float = 10000.0,
        normalize: bool = True,
        scale: Optional[float] = None,
        mode: str = "arbitrary",
        num_max_frames: int = 128,
    ):
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = 2 * math.pi if scale is None else scale
        assert mode in ("fixed", "arbitrary")
        self.mode = mode
        self.num_max_frames = num_max_frames

    def _z_embed(self, t_indices: torch.Tensor) -> torch.Tensor:
        t = t_indices.shape[0]
        if self.mode == "fixed":
            z = torch.arange(t, dtype=torch.float32, device=t_indices.device) + 1.0
            if self.normalize:
                z = z / (z[-1] + 1e-6) * self.scale
        else:
            z = t_indices.to(torch.float32) / self.num_max_frames * self.scale
        return z

    def _yx_embed(self, h: int, w: int, device):
        y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
        x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
        if self.normalize:
            y = y / (float(h) + 1e-6) * self.scale
            x = x / (float(w) + 1e-6) * self.scale
        return y, x

    def _pos_yx(self, h: int, w: int, device) -> torch.Tensor:
        y, x = self._yx_embed(h, w, device)
        dim_t = _dim_t(self.num_pos_feats, self.temperature, device)
        pos_x = _interleave_sin_cos(x[:, None] / dim_t)  # [W, F]
        pos_y = _interleave_sin_cos(y[:, None] / dim_t)  # [H, F]
        F = self.num_pos_feats
        return torch.cat([pos_y[:, None, :].expand(h, w, F), pos_x[None, :, :].expand(h, w, F)], dim=-1)

    def grid(self, t: int, h: int, w: int, t_indices: Optional[torch.Tensor] = None,
             device=None) -> torch.Tensor:
        """PE for a (T, H, W) grid -> [T, H, W, 2*num_pos_feats]."""
        if t_indices is None:
            t_indices = torch.arange(t, device=device)
        device = t_indices.device
        z = self._z_embed(t_indices)
        dim_t_z = _dim_t(self.num_pos_feats * 2, self.temperature, device)
        pos_z = _interleave_sin_cos(z[:, None] / dim_t_z)  # [T, 2F]
        return self._pos_yx(h, w, device)[None] + pos_z[:, None, None, :]

    def grid2d(self, h: int, w: int, device=None) -> torch.Tensor:
        """Plain 2D DETR sine PE (no z term) -> [H, W, 2*num_pos_feats]."""
        return self._pos_yx(h, w, device)

    def points(self, xy_normalized: torch.Tensor, t_indices: torch.Tensor) -> torch.Tensor:
        """PE for N normalized (x, y) points per frame -> [T, N, 2*num_pos_feats]."""
        device = xy_normalized.device
        z = self._z_embed(t_indices)
        xn = xy_normalized[:, 0].to(torch.float32) * self.scale
        yn = xy_normalized[:, 1].to(torch.float32) * self.scale
        dim_t = _dim_t(self.num_pos_feats, self.temperature, device)
        dim_t_z = _dim_t(self.num_pos_feats * 2, self.temperature, device)
        pos_x = _interleave_sin_cos(xn[:, None] / dim_t)
        pos_y = _interleave_sin_cos(yn[:, None] / dim_t)
        pos_z = _interleave_sin_cos(z[:, None] / dim_t_z)
        return torch.cat([pos_y, pos_x], dim=-1)[None] + pos_z[:, None, :]
