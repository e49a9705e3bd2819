"""Plain PyTorch versions of every kernel: the CPU path and the yardstick
every CUDA kernel is held against on the card. Line for line the JAX
package's ``kernels/ref.py``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

NEG_INF = -2.0 ** 30    # large-negative in f32, safe under bf16 casts


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention. q [b,h,sq,hd]; k,v [b,kv,sk,hd]; positions are
    the row and column indices."""
    b, h, sq, hd = q.shape
    _, kv, sk, _ = k.shape
    G = h // kv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor, *,
               scale: Optional[float] = None,
               window: Optional[int] = None,
               softcap: Optional[float] = None) -> torch.Tensor:
    """Decode with explicit slot positions (ring caches). q [b,h,1,hd];
    k,v [b,kv,C,hd]; q_pos [b,1]; k_pos [b,C]. A slot is valid iff
    ``0 <= k_pos <= q_pos`` (and ``q_pos - k_pos < window``); a row with
    no valid slot gives zeros."""
    b, h, _, hd = q.shape
    _, kv, C, _ = k.shape
    G = h // kv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :]
                                       <= q_pos[:, :, None])
    if window is not None:
        mask &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    any_valid = mask.any(dim=-1)[:, None, :, None]
    return torch.where(any_valid, out, 0.0).to(q.dtype)


def delta_join_ref(a_vals, a_vers, b_vals, b_vers
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    take_b = b_vers > a_vers
    return (torch.where(take_b[:, None], b_vals, a_vals),
            torch.maximum(a_vers, b_vers))


def batched_delta_join_ref(segments) -> List[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Per-segment oracle for the stacked batched join."""
    return [delta_join_ref(*s) for s in segments]


def chunk_digest_ref(x) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    return xf.abs().amax(dim=-1), (xf * xf).sum(dim=-1)


def fused_join_digest_ref(a_vals, a_vers, b_vals, b_vers):
    """Join + digest-of-the-merge (the kernel fuses these into one pass
    over device memory)."""
    ov, over = delta_join_ref(a_vals, a_vers, b_vals, b_vers)
    ma, ss = chunk_digest_ref(ov)
    return ov, over, ma, ss


def scatter_join_ref(vals, vers, maxabs, sumsq, idx, d_vals, d_vers):
    """Sparse scatter-ingest: merge ``r`` delta rows into copies of the
    resident columns at rows ``idx`` and refresh those rows' digest;
    every other row is unchanged and the inputs are left intact.
    Duplicate positions are only legal when their merged content is
    identical (the pad-row convention), so write order cannot matter."""
    if int(idx.shape[0]) == 0:
        return vals, vers, maxabs, sumsq
    idx = idx.long()
    cur_v = vals[idx]
    cur_r = vers[idx]
    take = d_vers > cur_r
    merged = torch.where(take[:, None], d_vals, cur_v)
    ma, ss = chunk_digest_ref(merged)
    ov, over = vals.clone(), vers.clone()
    oma, oss = maxabs.clone(), sumsq.clone()
    ov[idx] = merged
    over[idx] = torch.maximum(cur_r, d_vers)
    oma[idx] = ma
    oss[idx] = ss
    return ov, over, oma, oss
