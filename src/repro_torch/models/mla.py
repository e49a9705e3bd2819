"""Multi-head Latent Attention (DeepSeek-V2).

The port of the JAX package's ``models/mla.py``. Queries and keys/values
are factored through low-rank latents; the decode cache stores only the
compressed kv-latent (``kv_lora_rank``) plus the one shared rope key
(``qk_rope_head_dim``) per token, and decode runs with weight
absorption: scores are computed in latent space (``q_nope`` absorbed
through ``W_uk``, outputs through ``W_uv``).

The JAX package computes MLA attention in XLA, never in a Pallas kernel,
and so does the port, in plain torch products on every device: the
flash kernels take one head_dim for keys and values, and MLA's are 192
and 128. ``cfg.attn_impl == "chunked"`` runs :func:`_mla_attend_chunked`,
the JAX package's tiled online-softmax build.

As in ``attention.py``, :func:`mla_cache_append` writes into the cache's
tensors in place and returns the same dictionary.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.ref import NEG_INF
from .layers import _normal, apply_norm
from .rope import apply_rope


def init_mla(cfg, gen: torch.Generator, dtype) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim

    def sc(n):
        return float(1.0 / np.sqrt(n))

    dev = gen.device
    return {
        "w_dq": _normal(gen, (d, m.q_lora_rank), dtype, sc(d)),
        "w_uq": _normal(gen, (m.q_lora_rank, H * qh), dtype,
                        sc(m.q_lora_rank)),
        "w_dkv": _normal(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                         dtype, sc(d)),
        "w_uk": _normal(gen, (m.kv_lora_rank, H * m.qk_nope_head_dim), dtype,
                        sc(m.kv_lora_rank)),
        "w_uv": _normal(gen, (m.kv_lora_rank, H * m.v_head_dim), dtype,
                        sc(m.kv_lora_rank)),
        "wo": _normal(gen, (H * m.v_head_dim, d), dtype,
                      sc(H * m.v_head_dim)),
        "q_norm": {"scale": torch.ones((m.q_lora_rank,),
                                       dtype=torch.float32, device=dev)},
        "kv_norm": {"scale": torch.ones((m.kv_lora_rank,),
                                        dtype=torch.float32, device=dev)},
    }


def mla_specs(cfg) -> Dict:
    return {
        "w_dq": ("embed", "lora"), "w_uq": ("lora", "heads"),
        "w_dkv": ("embed", "lora"), "w_uk": ("lora", "heads"),
        "w_uv": ("lora", "heads"), "wo": ("heads", "embed"),
        "q_norm": {"scale": (None,)}, "kv_norm": {"scale": (None,)},
    }


def _queries(p, cfg, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = apply_norm(p["q_norm"], torch.matmul(x, p["w_dq"]), "rms")
    q = torch.matmul(cq, p["w_uq"]).reshape(b, s, cfg.n_heads, qh)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _latents(p, cfg, x, positions):
    m = cfg.mla
    ckv_full = torch.matmul(x, p["w_dkv"])
    ckv = apply_norm(p["kv_norm"], ckv_full[..., :m.kv_lora_rank], "rms")
    k_rope = apply_rope(ckv_full[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[:, :, 0]   # single shared rope head
    return ckv, k_rope


def _scale(m) -> float:
    return float(1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))


def _scores(qn, qr, kn, kr, scale):
    """f32 scores [b, H, s, t] of the nope and rope parts (operands
    widened to f32: the JAX package's ``preferred_element_type``)."""
    f32 = torch.float32
    return (torch.einsum("bshn,bthn->bhst", qn.to(f32), kn.to(f32))
            + torch.einsum("bshr,btr->bhst", qr.to(f32), kr.to(f32))) * scale


def _mla_attend_naive(cfg, q_nope, q_rope, k_nope, k_rope, v, positions):
    scores = _scores(q_nope, q_rope, k_nope, k_rope, _scale(cfg.mla))
    causal = positions[:, None, :] <= positions[:, :, None]
    scores = torch.where(causal[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthv->bshv", probs, v)


def _mla_attend_chunked(cfg, q_nope, q_rope, k_nope, k_rope, v, positions,
                        block: int):
    """Tiled MLA: [bq × bk] tiles with online softmax, tiles above the
    diagonal skipped. Falls back to the naive form when the length does
    not divide the block, as the JAX package does."""
    b, s, H, _ = q_nope.shape
    t = k_nope.shape[1]
    vd = v.shape[-1]
    bq = min(block, s)
    bk = min(block, t)
    if s % bq or t % bk:
        return _mla_attend_naive(cfg, q_nope, q_rope, k_nope, k_rope, v,
                                 positions)
    scale = _scale(cfg.mla)
    f32 = torch.float32
    dev = q_nope.device
    out_blocks = []
    for iq in range(s // bq):
        sl = slice(iq * bq, (iq + 1) * bq)
        qn, qr, qp = q_nope[:, sl], q_rope[:, sl], positions[:, sl]
        mstat = torch.full((b, H, bq), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, H, bq), dtype=f32, device=dev)
        acc = torch.zeros((b, H, bq, vd), dtype=f32, device=dev)
        for ik in range(t // bk):
            if ik * bk > (iq + 1) * bq - 1:
                continue                      # above the diagonal
            ksl = slice(ik * bk, (ik + 1) * bk)
            sc = _scores(qn, qr, k_nope[:, ksl], k_rope[:, ksl], scale)
            mask = (positions[:, ksl][:, None, :] <= qp[:, :, None])
            mask = mask[:, None, :, :]                        # [b,1,bq,bk]
            sc_masked = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(mstat, sc_masked.amax(dim=-1))
            alpha = torch.exp(mstat - m_new)
            pprob = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + pprob.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthv->bhsv", pprob.to(v.dtype), v[:, ksl]).to(f32)
            mstat = m_new
        safe_l = torch.where(l > 0, l, 1.0)
        ob = (acc / safe_l[..., None]).to(q_nope.dtype)
        out_blocks.append(ob.transpose(1, 2))                 # [b,bq,H,vd]
    return torch.cat(out_blocks, dim=1)


def mla_full(p: Dict, cfg, spec, x: torch.Tensor, positions: torch.Tensor,
             make_cache: Optional[int] = None
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Train/prefill with materialized keys and values; ``make_cache``
    is the capacity of the latent cache to emit."""
    m = cfg.mla
    b, s, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _queries(p, cfg, x, positions)
    ckv, k_rope = _latents(p, cfg, x, positions)
    k_nope = torch.matmul(ckv, p["w_uk"]).reshape(b, s, H,
                                                  m.qk_nope_head_dim)
    v = torch.matmul(ckv, p["w_uv"]).reshape(b, s, H, m.v_head_dim)
    if cfg.attn_impl == "chunked":
        out = _mla_attend_chunked(cfg, q_nope, q_rope, k_nope, k_rope, v,
                                  positions, cfg.attn_block)
    else:
        out = _mla_attend_naive(cfg, q_nope, q_rope, k_nope, k_rope, v,
                                positions)
    y = torch.matmul(out.reshape(b, s, -1), p["wo"])
    cache = None
    if make_cache is not None:
        cache = init_mla_cache(b, make_cache, m, ckv.dtype, ckv.device)
        cache = mla_cache_append(cache, ckv, k_rope, positions)
    return y, cache


def init_mla_cache(b: int, capacity: int, m, dtype, device
                   ) -> Dict[str, torch.Tensor]:
    return {
        "ckv": torch.zeros((b, capacity, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((b, capacity, m.qk_rope_head_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((b, capacity), -1, dtype=torch.int32,
                          device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_cache_append(cache: Dict, ckv: torch.Tensor, k_rope: torch.Tensor,
                     positions: torch.Tensor) -> Dict:
    """Append s tokens to the ring, in place; when s exceeds the capacity
    only the last C land (the JAX scatter, whose later writes win)."""
    C = cache["ckv"].shape[1]
    s = ckv.shape[1]
    skip = max(s - C, 0)
    slots = (cache["idx"] + skip
             + torch.arange(s - skip, device=ckv.device)) % C
    cache["ckv"][:, slots] = ckv[:, skip:]
    cache["krope"][:, slots] = k_rope[:, skip:]
    cache["pos"][:, slots] = positions[:, skip:].to(torch.int32)
    cache["idx"] += s
    return cache


def mla_decode(p: Dict, cfg, spec, x: torch.Tensor, positions: torch.Tensor,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Weight-absorbed decode over the latent cache."""
    m = cfg.mla
    b = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope = _queries(p, cfg, x, positions)          # [b,1,H,·]
    ckv, k_rope = _latents(p, cfg, x, positions)
    cache = mla_cache_append(cache, ckv, k_rope, positions)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)     # absorb W_uk
    f32 = torch.float32
    scores = (torch.einsum("bshr,btr->bhst", q_lat.to(f32),
                           cache["ckv"].to(f32))
              + torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                             cache["krope"].to(f32))) * _scale(m)
    pos = cache["pos"][:, None, :]
    valid = (pos >= 0) & (pos <= positions[:, :, None])
    scores = torch.where(valid[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", probs, cache["ckv"])
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", out_lat, w_uv).reshape(b, 1, -1)
    return torch.matmul(out, p["wo"]), cache
