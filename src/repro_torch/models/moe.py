"""Mixture-of-Experts: sort-based dispatch over the whole token space.

The port of the JAX package's ``models/moe.py`` global path: route each
token to its top-k experts, lay the (token, k) pairs out in a sorted
``[experts, capacity]`` dispatch table (pairs beyond an expert's
capacity are dropped, exactly the ones the JAX package drops), run every
expert's FFN as one batched product, and combine the weighted outputs
back per token. Shared experts (deepseek) run densely beside them. The
Switch-style load-balance auxiliary loss is returned with the output.

The JAX package's ``shard_map`` local path (per-shard dispatch with
all-to-alls) is slice F: ``apply_moe`` refuses ``moe_impl="local"``.

Differences in form, not in result:

* top-k is a stable descending sort, so that tied router probabilities
  pick the lower expert index first, as ``jax.lax.top_k`` does;
* the combine gathers each (token, k) pair's row through the inverse of
  the dispatch table, where the JAX package scatter-adds into a sentinel
  row: every real pair sits in the table at most once, so the two agree
  exactly, and the gather needs no atomics on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _gelu, _normal

_LOCAL = ("moe_impl='local' (the shard_map per-shard dispatch) is not "
          "ported yet (slice F, the mesh)")


@dataclasses.dataclass
class RoutingTap:
    """What :func:`tap_routing` records, per ``apply_moe`` call in call
    order: the routed expert ids [N, K] and the number of (token, k)
    pairs the capacity dropped (0-d), as tensors on the call's device,
    read after the block (nothing syncs inside). ``forced``, when given,
    holds the expert ids each call is to take instead of its own top-k
    (its gates are then its own probabilities at those experts,
    renormalized): a plain path scored on a served path's routing, as
    teacher forcing scores it on the served tokens."""
    expert_ids: List[torch.Tensor] = dataclasses.field(default_factory=list)
    drops: List[torch.Tensor] = dataclasses.field(default_factory=list)
    forced: Optional[Sequence[torch.Tensor]] = None


_tap: Optional[RoutingTap] = None


@contextlib.contextmanager
def tap_routing(forced: Optional[Sequence[torch.Tensor]] = None
                ) -> Iterator[RoutingTap]:
    """Record (and with ``forced``, replay) the routing of every
    ``apply_moe`` call inside the block; see :class:`RoutingTap`."""
    global _tap
    outer, _tap = _tap, RoutingTap(forced=forced)
    try:
        yield _tap
    finally:
        _tap = outer


def init_moe(cfg, gen: torch.Generator, dtype) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    sc_in = float(1.0 / np.sqrt(d))
    sc_out = float(1.0 / np.sqrt(m.expert_d_ff))
    p = {
        "router": _normal(gen, (d, m.num_experts), torch.float32, sc_in),
        "wi": _normal(gen, (m.num_experts, d, m.expert_d_ff), dtype, sc_in),
        "wo": _normal(gen, (m.num_experts, m.expert_d_ff, d), dtype, sc_out),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _normal(gen, (m.num_experts, d, m.expert_d_ff), dtype,
                          sc_in)
    if m.num_shared_experts:
        ff_sh = m.num_shared_experts * m.shared_d_ff
        p["shared"] = {
            "wi": _normal(gen, (d, ff_sh), dtype, sc_in),
            "wg": _normal(gen, (d, ff_sh), dtype, sc_in),
            "wo": _normal(gen, (ff_sh, d), dtype,
                          float(1.0 / np.sqrt(ff_sh))),
        }
    return p


def _act(h, g, act: str):
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return _gelu(g) * h
    return _gelu(h)


# ---------------------------------------------------------------------------
# Routing, dispatch and combine
# ---------------------------------------------------------------------------

def _route(router, cfg, xf):
    """Returns (gate_vals [N,K] f32, expert_ids [N,K] int64, aux)."""
    m = cfg.moe
    N = xf.shape[0]
    logits = torch.matmul(xf.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    if _tap is not None and _tap.forced is not None:
        expert_ids = _tap.forced[len(_tap.expert_ids)].to(probs.device)
        gate_vals = torch.gather(probs, 1, expert_ids)
    else:
        # stable descending sort: ties go to the lower expert, as lax.top_k
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_ids = vals[:, :m.top_k], ids[:, :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    counts = torch.bincount(expert_ids.reshape(-1),
                            minlength=m.num_experts).to(torch.float32)
    frac = counts / (N * m.top_k)
    aux = m.num_experts * torch.sum(frac * probs.mean(dim=0))
    return gate_vals, expert_ids, aux


def _dispatch_table(expert_ids, E: int, capacity: int):
    """Sorted-scatter table [E, C] int32 of flat (token·K) indices, the
    sentinel M where a slot is empty. Pairs past an expert's capacity are
    dropped (the JAX package's ``mode="drop"`` writes)."""
    N, K = expert_ids.shape
    M = N * K
    flat_experts = expert_ids.reshape(M)
    sort_idx = torch.argsort(flat_experts, stable=True)
    sorted_experts = flat_experts[sort_idx]
    counts_i = torch.bincount(flat_experts, minlength=E)
    starts = torch.cumsum(counts_i, 0) - counts_i        # exclusive cumsum
    pos_in_expert = (torch.arange(M, device=expert_ids.device)
                     - starts[sorted_experts])
    keep = pos_in_expert < capacity
    table = torch.full((E, capacity), M, dtype=torch.int32,
                       device=expert_ids.device)
    table[sorted_experts[keep], pos_in_expert[keep]] = \
        sort_idx[keep].to(torch.int32)
    return table, M


def _gather_tokens(xf, table, K: int):
    N, d = xf.shape
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    return x_pad[(table // K).long()]                     # [E, C, d]


def _combine_tokens(y_e, gate_vals, table, N: int, K: int):
    """Each (token, k) pair's gated expert output (0 where it was
    dropped), summed over k (in f32, then the compute dtype, as
    ``jnp.sum`` reduces bf16)."""
    M = N * K
    E, C, d = y_e.shape
    gates_flat = torch.cat([gate_vals.reshape(M),
                            gate_vals.new_zeros((1,))])
    w_e = gates_flat[table.long()].to(y_e.dtype)
    rows = torch.cat([(y_e * w_e[..., None]).reshape(E * C, d),
                      y_e.new_zeros((1, d))])
    flat = table.reshape(-1).long()
    real = flat < M
    inv = torch.full((M + 1,), E * C, dtype=torch.long, device=y_e.device)
    inv[flat[real]] = torch.arange(E * C, device=y_e.device)[real]
    out = rows[inv[:M]].reshape(N, K, d)
    return out.to(torch.float32).sum(dim=1).to(y_e.dtype)


def _expert_ffn(p, cfg, x_e):
    h = torch.bmm(x_e, p["wi"])
    g = torch.bmm(x_e, p["wg"]) if "wg" in p else None
    return torch.bmm(_act(h, g, cfg.act), p["wo"])


def _shared_experts(p, cfg, xf):
    sp = p["shared"]
    hs = torch.matmul(xf, sp["wi"])
    gs = torch.matmul(xf, sp["wg"])
    return torch.matmul(_act(hs, gs, cfg.act), sp["wo"])


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: ceil(N·K/E·factor) in
    Python floats, in the JAX package's order."""
    m = cfg.moe
    return max(1, int(math.ceil(n_tokens * m.top_k / m.num_experts
                                * m.capacity_factor)))


# ---------------------------------------------------------------------------
# Global path
# ---------------------------------------------------------------------------

def _apply_moe_global(p: Dict, cfg, x: torch.Tensor,
                      capacity: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    b, s, d = x.shape
    N = b * s
    xf = x.reshape(N, d)
    gate_vals, expert_ids, aux = _route(p["router"], cfg, xf)
    if capacity is None:
        capacity = moe_capacity(cfg, N)
    table, M = _dispatch_table(expert_ids, m.num_experts, capacity)
    if _tap is not None:
        _tap.expert_ids.append(expert_ids)
        _tap.drops.append(M - (table < M).sum())
    x_e = _gather_tokens(xf, table, m.top_k)
    y_e = _expert_ffn(p, cfg, x_e)
    y = _combine_tokens(y_e, gate_vals, table, N, m.top_k)
    if m.num_shared_experts:
        y = y + _shared_experts(p, cfg, xf)
    return y.reshape(b, s, d), aux


def apply_moe(p: Dict, cfg, x: torch.Tensor,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] → (y [b, s, d], aux_loss scalar f32)."""
    if getattr(cfg, "moe_impl", "global") == "local":
        raise NotImplementedError(_LOCAL)
    return _apply_moe_global(p, cfg, x, capacity)
