"""GQA attention with sliding windows, softcaps, bias, and KV caches.

Three entry points share one masked-softmax core:

* ``attend_full``   — prefill over the whole sequence (causal, optionally
                      sliding-window); optionally emits the KV cache for
                      the decode steps that follow.
* ``attend_decode`` — one new token against a cache. Caches are fixed-size
                      ring buffers carrying each slot's absolute position,
                      which handles full caches (capacity = max_len) and
                      sliding-window caches (capacity = window) alike.

``cfg.attn_impl`` picks the path, as in the JAX package: ``"naive"`` runs
the plain einsum core everywhere; ``"chunked"`` is flash attention — on
the card the hand-written kernels (``kernels.ops.flash_attention`` for
prefill, ``flash_decode`` for each decode step, launched on the model's
own ``[b, s, H, hd]`` / ``[b, C, KV, hd]`` layouts through strides), on the
CPU their plain tiled build ``_mha_chunked`` (prefill) and ``_mha_core``
(decode). Tensors on any other device go to the kernel wrappers, which
refuse them: no path falls back to a plain version while a card runs it.
Under a mesh the model calls these functions on each rank's local
shards (``transformer._mix``), so the kernels see plain tensors; a
``DTensor`` that reaches a wrapper is refused.

Training runs the plain ``_mha_chunked`` / ``_mha_core`` under autograd
on every device, as the JAX package's train path does (its Pallas
kernels have no backward): ``attend_full`` takes the kernel route only
for a prefill (one that emits a cache) whose operands need no
gradient (:func:`flash_route`).

Unlike the JAX package, whose arrays are immutable, ``cache_append``
writes into the cache's tensors in place (a decode step would otherwise
copy every layer's whole cache) and returns the same dictionary.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import NEG_INF
from .layers import _normal
from .rope import apply_rope


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(cfg, gen: torch.Generator, dtype
                   ) -> Dict[str, torch.Tensor]:
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    sc = float(1.0 / np.sqrt(d))
    p = {
        "wq": _normal(gen, (d, H * hd), dtype, sc),
        "wk": _normal(gen, (d, KV * hd), dtype, sc),
        "wv": _normal(gen, (d, KV * hd), dtype, sc),
        "wo": _normal(gen, (H * hd, d), dtype, float(1.0 / np.sqrt(H * hd))),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def attention_specs(cfg) -> Dict[str, tuple]:
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
         "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        s["bq"], s["bk"], s["bv"] = ("heads",), ("kv",), ("kv",)
    return s


def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, H, hd)
    k = k.reshape(b, s, KV, hd)
    v = v.reshape(b, s, KV, hd)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def _scale(cfg, hd: int) -> float:
    return cfg.query_scale if cfg.query_scale else 1.0 / np.sqrt(hd)


def _mha_core(cfg, q, k, v, q_pos, k_pos, window: Optional[int],
              k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [b,s,H,hd] · k,v [b,t,KV,hd] with causal(+window) position
    masking. f32 scores and softmax (operands widened to f32); GQA by head
    grouping (no KV repeat); the probabilities are cast to v's dtype for
    the PV product, as in the JAX package."""
    b, s, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(b, s, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * _scale(cfg, hd)
    if cfg.attn_softcap:
        c = cfg.attn_softcap
        scores = c * torch.tanh(scores / c)
    causal = k_pos[:, None, :] <= q_pos[:, :, None]              # [b,s,t]
    if window is not None:
        causal &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if k_valid is not None:
        causal &= k_valid[:, None, :]
    scores = torch.where(causal[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, H, hd)


def _mha_chunked(cfg, q, k, v, q_pos, k_pos, window: Optional[int],
                 block: int) -> torch.Tensor:
    """Tiled flash attention, the plain build of the kernels: loops over
    (q-block × k-block) tiles with online softmax; tiles entirely above
    the causal diagonal or outside the sliding-window band are skipped.
    Assumes row-major positions (q_pos/k_pos are arange), which
    attend_full guarantees. Falls back to ``_mha_core`` when the length
    does not divide the block, as the JAX package does."""
    b, s, H, hd = q.shape
    t = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    bq = min(block, s)
    bk = min(block, t)
    if s % bq or t % bk:
        return _mha_core(cfg, q, k, v, q_pos, k_pos, window)
    nq, nk = s // bq, t // bk
    scale = _scale(cfg, hd)
    f32 = torch.float32

    out_blocks = []
    for iq in range(nq):
        sl = slice(iq * bq, (iq + 1) * bq)
        qg = q[:, sl].reshape(b, bq, KV, G, hd)
        qp = q_pos[:, sl]
        m = torch.full((b, KV, G, bq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, KV, G, bq), dtype=f32, device=q.device)
        acc = torch.zeros((b, KV, G, bq, hd), dtype=f32, device=q.device)
        for ik in range(nk):
            k_start, k_end = ik * bk, (ik + 1) * bk
            q_start, q_end = iq * bq, (iq + 1) * bq
            if k_start > q_end - 1:
                continue                      # fully above the diagonal
            if window is not None and (q_start - (k_end - 1)) >= window:
                continue                      # fully outside the SWA band
            kb = k[:, k_start:k_end]
            vb = v[:, k_start:k_end]
            kp = k_pos[:, k_start:k_end]
            sc = torch.einsum("bqkgh,btkh->bkgqt", qg.to(f32),
                              kb.to(f32)) * scale
            if cfg.attn_softcap:
                c = cfg.attn_softcap
                sc = c * torch.tanh(sc / c)
            mask = kp[:, None, :] <= qp[:, :, None]
            if window is not None:
                mask &= (qp[:, :, None] - kp[:, None, :]) < window
            mask = mask[:, None, None, :, :]   # [b,1,1,bq,bk]
            sc_masked = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc_masked.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pprob = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + pprob.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", pprob.to(v.dtype), vb).to(f32)
            m = m_new
        safe_l = torch.where(l > 0, l, 1.0)
        ob = (acc / safe_l[..., None]).to(q.dtype)     # [b,KV,G,bq,hd]
        out_blocks.append(ob.permute(0, 3, 1, 2, 4).reshape(b, bq, H, hd))
    return torch.cat(out_blocks, dim=1)


def _flash_full(cfg, spec, q, k, v) -> torch.Tensor:
    """The prefill kernel on the model's [b, s, heads, hd] tensors: the
    kernel takes them as [b, heads, s, hd] views and returns its output
    in q's memory order, so both transposes are free."""
    return ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=_scale(cfg, q.shape[-1]), window=spec.window,
        softcap=cfg.attn_softcap).transpose(1, 2)


# ---------------------------------------------------------------------------
# Full-sequence (train / prefill)
# ---------------------------------------------------------------------------

def flash_route(q: torch.Tensor, make_cache: Optional[int]) -> bool:
    """Whether ``attend_full`` launches the prefill kernel: off the CPU,
    for a prefill (``make_cache`` set), never under autograd."""
    return (q.device.type != "cpu" and make_cache is not None
            and not q.requires_grad)


def attend_full(p: Dict, cfg, spec, x: torch.Tensor, positions: torch.Tensor,
                make_cache: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [b,s,d] → (y [b,s,d], cache or None).

    ``make_cache``: capacity of the decode cache to emit (≥ s for full
    attention; == window for SWA layers)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if cfg.attn_impl == "chunked":
        if flash_route(q, make_cache):
            y = _flash_full(cfg, spec, q, k, v)
        else:
            y = _mha_chunked(cfg, q, k, v, positions, positions,
                             spec.window, cfg.attn_block)
    else:
        y = _mha_core(cfg, q, k, v, positions, positions, spec.window)
    y = torch.matmul(y.reshape(b, s, -1), p["wo"])
    cache = None
    if make_cache is not None:
        cache = init_kv_cache(b, make_cache, cfg.n_kv_heads,
                              cfg.resolved_head_dim(), k.dtype, k.device)
        cache = cache_append(cache, k, v, positions)
    return y, cache


# ---------------------------------------------------------------------------
# KV cache (ring buffer with per-slot absolute positions)
# ---------------------------------------------------------------------------

def init_kv_cache(b: int, capacity: int, kv_heads: int, head_dim: int,
                  dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((b, capacity, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((b, capacity, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((b, capacity), -1, dtype=torch.int32,
                          device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),  # written
    }


def cache_append(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> Dict:
    """Append s tokens (prefill bulk write or single decode step), in
    place. When s exceeds the capacity only the last C tokens land,
    each in its own slot (the JAX package's scatter, whose later writes
    win)."""
    C = cache["k"].shape[1]
    s = k.shape[1]
    skip = max(s - C, 0)
    slots = (cache["idx"] + skip
             + torch.arange(s - skip, device=k.device)) % C
    cache["k"][:, slots] = k[:, skip:]
    cache["v"][:, slots] = v[:, skip:]
    cache["pos"][:, slots] = positions[:, skip:].to(torch.int32)
    cache["idx"] += s
    return cache


def attend_decode(p: Dict, cfg, spec, x: torch.Tensor,
                  positions: torch.Tensor, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token step: x [b,1,d], cache holds the history."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, positions)
    cache = cache_append(cache, k, v, positions)
    if cfg.attn_impl == "chunked" and q.device.type != "cpu":
        y = ops.flash_decode(
            q.transpose(1, 2), cache["k"].transpose(1, 2),
            cache["v"].transpose(1, 2), positions.to(torch.int32),
            cache["pos"], scale=_scale(cfg, q.shape[-1]),
            window=spec.window, softcap=cfg.attn_softcap).transpose(1, 2)
    else:
        y = _mha_core(cfg, q, cache["k"], cache["v"], positions,
                      cache["pos"], spec.window, k_valid=cache["pos"] >= 0)
    y = torch.matmul(y.reshape(b, 1, -1), p["wo"])
    return y, cache
