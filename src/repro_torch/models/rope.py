"""Rotary position embeddings, with partial-rotary support (stablelm)."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_frequencies(head_dim: int, theta: float, rotary_pct: float = 1.0,
                     device=None) -> Tuple[int, torch.Tensor]:
    """``(rotated dims, inverse frequencies f32 [rot/2])``, computed in
    f64 on ``device`` (made there, so a decode step never waits on a
    host-to-device copy)."""
    rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float64, device=device) / rot
    return rot, (1.0 / theta ** exps).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: [b, s, h, hd]; positions: [b, s] (absolute). Angles, sines and
    the rotation run in f32; the result is in x's dtype."""
    hd = x.shape[-1]
    rot, inv = rope_frequencies(hd, theta, rotary_pct, x.device)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].to(torch.float32) * inv     # [b, s, rot/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rotated, xp], dim=-1) if rot < hd else rotated
