"""Shared neural layers: norms, MLPs, embeddings, softcaps, positions,
and the training loss.

Plain functions over dictionaries of tensors, as in the JAX package,
whose ``init_*`` also return logical sharding specs; the port's
``init_*`` return the parameters alone and each has a ``*_specs``
beside it that gives the same tree of logical axis names from the
config (``transformer.logical_specs``). Compute dtype
is the config dtype (bf16 at full width); the reductions that matter
(norm statistics, logits) run in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..tree import tree_map
from . import hints
from .hints import hint


def _normal(gen: torch.Generator, shape, dtype, scale: float
            ) -> torch.Tensor:
    """``scale``·N(0, 1) from ``gen``; on ``meta`` (a generator stand-in
    whose device is meta, see ``transformer.init_model``) the shape
    alone, since ``torch.Generator`` has no meta device."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def norm_specs(cfg) -> Dict[str, tuple]:
    if cfg.norm == "rms":
        return {"scale": ("embed",)}
    return {"scale": ("embed",), "bias": ("embed",)}


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


def mlp_specs(cfg) -> Dict[str, tuple]:
    s = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.act in ("swiglu", "geglu"):
        s["wg"] = ("embed", "mlp")
    return s


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


def embedding_specs(cfg) -> Dict[str, tuple]:
    s = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        s["head"] = ("embed", "vocab")
    return s


def _embed_on_mesh(table: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The lookup on each rank's shards (vocab-parallel): its rows of the
    table, the vocab split over the axis "vocab" maps to where it divides
    (the embed dim gathered), for its batch rows; a token outside the
    rank's rows reads zeros, and the ranks' partial sums are the rows."""
    vocab = hints.even("vocab", table.shape[0], what="embedding vocab")
    batch = hints.even("batch", tokens.shape[0], what="embedding batch")
    n = hints.axis_size(vocab)
    rows = table.shape[0] // n
    first = hints.shard_index(vocab) * rows

    def local(tab, tok):
        idx = tok.long() - first
        hit = (idx >= 0) & (idx < rows)
        got = tab[idx.clamp(0, rows - 1)]
        return (torch.where(hit[..., None], got, got.new_zeros(())),)

    return hints.on_shards(local, [table, tokens], [(vocab, None),
                                                   (batch, None)],
                           [hints.Summed((batch, None, None),
                                         over=(vocab,))])[0]


def embed_tokens(p: Dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    if hints.current_rules() is None:
        x = p["tok"][tokens]
    else:
        x = _embed_on_mesh(p["tok"], tokens)
    if cfg.scale_embed:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(p: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32: the operands are widened to f32, so every product
    of two bf16 values is exact and the sum runs in f32 (the JAX
    package's ``preferred_element_type=float32``). Under a mesh the
    product runs on each rank's shards, laid out as the reference's two
    hints pin it: the batch over the data axes, the vocab over "model"
    where it divides (so a tied table's gradient comes back from here
    and from the embedding in its own layout)."""
    x = hint(x, ("batch",) + (None,) * (x.ndim - 1))
    tied = cfg.tie_embeddings
    w = p["tok"] if tied else p["head"]

    def product(x, w):
        if tied:
            logits = F.linear(x.to(torch.float32), w.to(torch.float32))
        else:
            logits = torch.matmul(x.to(torch.float32), w.to(torch.float32))
        if cfg.final_softcap:
            c = cfg.final_softcap
            logits = c * torch.tanh(logits / c)
        return (logits,)

    if hints.current_rules() is None:
        return product(x, w)[0]
    batch = hints.even("batch", x.shape[0], what="logits batch")
    vocab = hints.even("vocab", w.shape[0 if tied else 1],
                       what="logits vocab")
    lead = (batch,) + (None,) * (x.ndim - 2)
    logits = hints.on_shards(product, [x, w],
                             [lead + (None,), (vocab, None) if tied
                              else (None, vocab)], [lead + (vocab,)])[0]
    return hint(logits, lead + ("vocab",))


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

def _vocab_sharded_terms(logits, labels):
    """(log-normaliser, gold logit) of ``DTensor`` logits [..., v]."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = logits.ndim - 1
    shift = logits.detach().amax(dim=-1, keepdim=True)
    logz = (logits - shift).exp().sum(dim=-1).log() + shift[..., 0]
    mesh = logits.device_mesh
    vocab = torch.arange(logits.shape[-1], device=logits.to_local().device)
    vocab = DTensor.from_local(vocab, mesh, [Replicate()] * mesh.ndim,
                               run_check=False).redistribute(
        mesh, [Shard(0) if p == Shard(last) else Replicate()
               for p in logits.placements])
    hit = labels[..., None].long() == vocab
    return logz, torch.where(hit, logits, 0.0).sum(dim=-1)


def _sharded_mean(nll, mask):
    """The loss of ``DTensor`` per-token terms, finished on each rank's
    shard: its share of the sum (a partial sum over the batch axes), so
    that the backward hands each rank the gradient of its own tokens (a
    mean's backward broadcasts a replicated gradient to the whole batch,
    and every product of the backward then runs over it)."""
    batch = hints.even("batch", nll.shape[0], what="loss batch")
    axes = (batch,) + (None,) * (nll.ndim - 1)
    total = hints.Summed((), over=(batch,) if batch else ())
    if mask is None:
        n = nll.numel()
        return hints.on_shards(lambda t: (t.sum() / n,), [nll], [axes],
                               [total])[0]
    num, den = hints.on_shards(lambda t, m: ((t * m).sum(), m.sum()),
                               [nll, mask.to(torch.float32)], [axes, axes],
                               [total, total])
    return num / torch.clamp(den, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32. logits [..., v], labels [...].

    The gold logit is a gather. On ``DTensor`` logits (a mesh, the vocab
    perhaps sharded) it is the JAX package's iota-compare-select and the
    normaliser a max-shifted sum of exponentials, both reductions over
    the vocab that leave it sharded (a gather or ``logsumexp`` there would
    all-gather the logits)."""
    logits = logits.to(torch.float32)
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return _cross_entropy(logits, labels, mask)
    logz, gold = _vocab_sharded_terms(logits, labels)
    return _sharded_mean(logz - gold, mask)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
