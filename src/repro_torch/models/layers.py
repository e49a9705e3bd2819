"""Shared neural layers: norms, MLPs, embeddings, softcaps, positions,
and the training loss.

Plain functions over dictionaries of tensors, as in the JAX package
(whose ``init_*`` also return logical sharding specs; the port has no
mesh yet, so its ``init_*`` return the parameters alone). Compute dtype
is the config dtype (bf16 at full width); the reductions that matter
(norm statistics, logits) run in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..tree import tree_map


def _normal(gen: torch.Generator, shape, dtype, scale: float
            ) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * scale


def shape_of(params: Any) -> Any:
    """The tree of ``params`` with each tensor replaced by its shape (a
    tuple, as the JAX package's ``shape_of`` gives)."""
    return tree_map(lambda x: tuple(x.shape), params)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, d: int, device) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm != "rms":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Dict, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    """Statistics in f32; the wide elementwise path stays in the compute
    dtype (as the JAX package does)."""
    xf = x.to(torch.float32)
    if kind == "rms":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype)
            + p["bias"].to(x.dtype))


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator, d: int, d_ff: int, dtype
             ) -> Dict[str, torch.Tensor]:
    scale_in = float(1.0 / np.sqrt(d))
    scale_out = float(1.0 / np.sqrt(d_ff))
    p = {"wi": _normal(gen, (d, d_ff), dtype, scale_in),
         "wo": _normal(gen, (d_ff, d), dtype, scale_out)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _normal(gen, (d, d_ff), dtype, scale_in)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def apply_mlp(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = torch.matmul(x, p["wi"])
    if act in ("swiglu", "geglu"):
        g = torch.matmul(x, p["wg"])
        gate = F.silu(g) if act == "swiglu" else _gelu(g)
        h = gate * h
    else:
        h = _gelu(h)
    return torch.matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(cfg, gen: torch.Generator, dtype
                   ) -> Dict[str, torch.Tensor]:
    p = {"tok": _normal(gen, (cfg.vocab, cfg.d_model), dtype, 0.02)}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, cfg.vocab), dtype, 0.02)
    return p


def embed_tokens(p: Dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(p: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32: the operands are widened to f32, so every product
    of two bf16 values is exact and the sum runs in f32 (the JAX
    package's ``preferred_element_type=float32``)."""
    if cfg.tie_embeddings:
        logits = F.linear(x.to(torch.float32), p["tok"].to(torch.float32))
    else:
        logits = torch.matmul(x.to(torch.float32),
                              p["head"].to(torch.float32))
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Positions (non-rope)
# ---------------------------------------------------------------------------

def sinusoidal_positions(positions: torch.Tensor, d: int,
                         dtype=torch.float32) -> torch.Tensor:
    """[.., s] int positions → [.., s, d] sinusoidal embeddings."""
    half = d // 2
    steps = torch.arange(half, dtype=torch.float64, device=positions.device)
    freqs = torch.exp(-float(np.log(10_000.0)) * steps / half)
    ang = positions[..., None].to(torch.float32) * freqs.to(torch.float32)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32. logits [..., v], labels [...].

    The gold logit is a gather; the JAX package's iota-compare-select
    form serves GSPMD sharding of the vocab axis, which the port does not
    have yet."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
