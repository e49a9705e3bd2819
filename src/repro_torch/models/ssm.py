"""Mamba-2 SSD (state-space duality) block — chunked parallel form.

The port of the JAX package's ``models/ssm.py``. Within a chunk the SSD
algorithm is batched products over [chunk × chunk] and
[chunk × d_state] tiles; across chunks a tiny recurrence carries one
[heads, head_dim, d_state] state per sequence, a Python loop over the
chunks where the JAX package has a ``lax.scan``.

Neither package has a kernel for the SSD scan: the JAX package runs it
in XLA, and the port runs the same operations as plain torch products
on every device, step for step in the JAX package's dtypes (the C·B
scores, the decays and the recurrent state in f32; the within-chunk
products in the compute dtype).

Decode is the O(1) recurrent step: conv-buffer shift + state update
``h ← exp(dt·a)·h + dt·B⊗x``, constant memory in sequence length. As in
``attention.py``, :func:`ssm_decode` writes the cache's tensors in place
(the decoder stack hands each layer views of its group's stacked
caches) and returns the same dictionary.

Jamba note: Jamba's Mamba-1 (S6) layers are mapped onto this SSD block
(scalar-per-head A instead of per-channel), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _normal, apply_norm


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def init_ssm(cfg, gen: torch.Generator, dtype) -> Dict:
    """Separate z / xBC / dt projections, as the JAX package lays them
    out; ``A_log``, ``D``, ``dt_bias`` and the norm scale are f32 in
    every compute dtype."""
    s, d_in, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    sc = float(1.0 / np.sqrt(d))
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_z": _normal(gen, (d, d_in), dtype, sc),
        "w_xbc": _normal(gen, (d, conv_dim), dtype, sc),
        "w_dt": _normal(gen, (d, nh), dtype, sc),
        "conv_w": _normal(gen, (s.d_conv, conv_dim), dtype, 0.1),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": {"scale": torch.ones((d_in,), **f32)},
        "w_out": _normal(gen, (d_in, d), dtype,
                         float(1.0 / np.sqrt(d_in))),
    }


def ssm_specs(cfg) -> Dict:
    return {
        "w_z": ("embed", "mlp"), "w_xbc": ("embed", "mlp"),
        "w_dt": ("embed", None), "conv_w": (None, "mlp"),
        "conv_b": ("mlp",), "A_log": (None,), "D": (None,),
        "dt_bias": (None,), "norm": {"scale": ("mlp",)},
        "w_out": ("mlp", "embed"),
    }


def _split_proj(p, cfg, x):
    return (torch.matmul(x, p["w_z"]), torch.matmul(x, p["w_xbc"]),
            torch.matmul(x, p["w_dt"]))


def _causal_conv_full(p, xBC):
    """[b, s, conv_dim] depthwise causal conv, kernel k."""
    k = p["conv_w"].shape[0]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1], :] * p["conv_w"][i]
              for i in range(k))
    return F.silu(out + p["conv_b"])


def _segsum(log_a):
    """[..., Q] per-step log-decays → [..., Q, Q] lower-tri cumulative sums:
    out[i,j] = Σ_{j<k≤i} log_a[k] for i ≥ j, -inf otherwise."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # Σ(j..i]
    i = torch.arange(Q, device=log_a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssm_full(p: Dict, cfg, x: torch.Tensor, make_cache: bool = False
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Chunked SSD over the full sequence. x [b, s_len, d]; the length
    must be a multiple of ``min(chunk, s_len)``."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b, slen, _ = x.shape
    g, n, hd = s.n_groups, s.d_state, s.head_dim
    hpg = nh // g
    f32 = torch.float32

    Q = min(s.chunk, slen)
    if slen % Q:
        raise ValueError(f"SSD prefill of {slen} positions is not a "
                         f"multiple of the chunk {Q}")
    nc = slen // Q

    z, xBC_raw, dt = _split_proj(p, cfg, x)
    xBC = _causal_conv_full(p, xBC_raw)
    xs = xBC[..., :d_in].reshape(b, slen, nh, hd)
    B = xBC[..., d_in:d_in + g * n].reshape(b, slen, g, n)
    C = xBC[..., d_in + g * n:].reshape(b, slen, g, n)

    a = -torch.exp(p["A_log"])                                  # [nh]
    # past its threshold of 20, torch's softplus returns x itself where
    # ``jax.nn.softplus`` adds log1p(exp(-x)) < 2.1e-9: below half an f32
    # ulp of 20 (9.5e-7), so the two round to the same f32
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                  # [b,s,nh]
    log_decay = dt * a                                          # [b,s,nh]

    xs_c = xs.reshape(b, nc, Q, nh, hd)
    B_c = B.reshape(b, nc, Q, g, n)
    C_c = C.reshape(b, nc, Q, g, n)
    dt_c = dt.reshape(b, nc, Q, nh).permute(0, 1, 3, 2)         # [b,nc,nh,Q]
    ld_c = log_decay.reshape(b, nc, Q, nh).permute(0, 1, 3, 2)  # [b,nc,nh,Q]

    # within-chunk ("diagonal") term: masked quadratic attention-like
    # product, scores[b,c,h,i,j] = (C_i · B_j) L[h,i,j] dt_j; operands
    # widened to f32 (the JAX package's preferred_element_type)
    L = torch.exp(_segsum(ld_c))                                # [b,nc,nh,Q,Q]
    CB = torch.einsum("bcign,bcjgn->bcgij", C_c.to(f32), B_c.to(f32))
    W = CB.repeat_interleave(hpg, dim=2) * L * dt_c[..., None, :]
    del L, CB
    y_diag = torch.einsum("bchij,bcjhp->bcihp", W.to(xs.dtype), xs_c)
    del W

    # per-chunk summary state: S_c = Σ_j exp(Σ_{k>j} ld) dt_j B_j ⊗ x_j
    cum = torch.cumsum(ld_c, dim=-1)
    tail = torch.exp(cum[..., -1:] - cum)                       # [b,nc,nh,Q]
    wj = (tail * dt_c).to(xs.dtype)                             # [b,nc,nh,Q]
    Bh = B_c.repeat_interleave(hpg, dim=3)                      # [b,nc,Q,nh,n]
    S = torch.einsum("bcjhp,bcjhn->bchpn", xs_c,
                     wj.permute(0, 1, 3, 2)[..., None] * Bh).to(f32)

    # cross-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[..., -1])                       # [b,nc,nh]
    h = torch.zeros((b, nh, hd, n), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # [b,nc,nh,hd,n]

    # off-chunk contribution: y_off[i] = exp(cum[i]) C_i · h_prev
    Ch = C_c.repeat_interleave(hpg, dim=3)                      # [b,nc,Q,nh,n]
    y_off = torch.einsum("bcihn,bchpn->bcihp", Ch.to(f32), h_prev) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]

    y = (y_diag.to(f32) + y_off).reshape(b, slen, nh, hd)
    y = y + xs.to(f32) * p["D"][None, None, :, None]
    y = y.reshape(b, slen, d_in).to(x.dtype)

    y = apply_norm(p["norm"], y * F.silu(z), "rms")
    out = torch.matmul(y, p["w_out"])

    cache = None
    if make_cache:
        # the final recurrent state and the raw (pre-conv) projection of
        # the last k-1 positions, copied out of the full-length tensor
        k = p["conv_w"].shape[0]
        cache = {"ssm": h, "conv": xBC_raw[:, -(k - 1):, :].clone(),
                 "idx": torch.tensor(slen, dtype=torch.int32,
                                     device=x.device)}
    return out, cache


def init_ssm_cache(cfg, b: int, dtype, device) -> Dict[str, torch.Tensor]:
    s, d_in, nh, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((b, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((b, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def ssm_decode(p: Dict, cfg, x: torch.Tensor, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """O(1) recurrent step. x [b, 1, d]; ``cache``'s tensors are updated
    in place."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b = x.shape[0]
    g, n, hd = s.n_groups, s.d_state, s.head_dim
    hpg = nh // g
    f32 = torch.float32

    z, xBC, dt = _split_proj(p, cfg, x)                         # [b,1,·]
    # conv over (cached k-1 inputs ++ current)
    window = torch.cat([cache["conv"], xBC], dim=1)     # [b,k,conv_dim]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC_t = F.silu(conv_out)                                    # [b,conv_dim]

    xs = xBC_t[:, :d_in].reshape(b, nh, hd)
    B = xBC_t[:, d_in:d_in + g * n].reshape(b, g, n)
    C = xBC_t[:, d_in + g * n:].reshape(b, g, n)
    Bh = B.repeat_interleave(hpg, dim=1)                        # [b,nh,n]
    Ch = C.repeat_interleave(hpg, dim=1)

    a = -torch.exp(p["A_log"])
    dt_t = F.softplus(dt[:, 0].to(f32) + p["dt_bias"])  # as in ssm_full
    decay = torch.exp(dt_t * a)                                 # [b,nh]

    h = cache["ssm"] * decay[..., None, None] + \
        (dt_t[..., None, None] * Bh[:, :, None, :].to(f32)
         * xs[..., None].to(f32))
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.to(f32))
    y = y + xs.to(f32) * p["D"][None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)

    y = apply_norm(p["norm"], y * F.silu(z), "rms")
    out = torch.matmul(y, p["w_out"])
    cache["ssm"].copy_(h)
    # shift from the fresh window: conv[:, 1:] → conv[:, :-1] would be
    # an overlapping copy
    cache["conv"].copy_(window[:, 1:, :])
    cache["idx"].add_(1)
    return out, cache
