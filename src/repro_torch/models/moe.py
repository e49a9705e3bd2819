"""Mixture-of-Experts: sort-based dispatch, two execution paths.

The port of the JAX package's ``models/moe.py``. Each path routes each
token to its top-k experts, lays the (token, k) pairs out in a sorted
``[experts, capacity]`` dispatch table (pairs beyond an expert's
capacity are dropped, exactly the ones the JAX package drops), runs every
expert's FFN as one batched product, and combines the weighted outputs
back per token. Shared experts (deepseek) run densely beside them. The
Switch-style load-balance auxiliary loss is returned with the output.

``global`` (default, mesh-free): one dispatch over the whole token space.
Under a mesh its data-dependent gathers have no sharded form: it runs on
every rank over the replicated tokens (recorded as a fallback), as GSPMD
replicates the flat token tensors for the JAX package.

``local`` (mesh present; without one it is the global path, as in the
JAX package): per-shard dispatch through ``hints.on_shards``
(``local_map``, the analogue of ``shard_map``). Tokens never leave their
shard except through explicit, minimal collectives on the mesh's groups:

* EP regime (num_experts % model-axis == 0): each (data, model) shard
  dispatches a DISJOINT token slice, routes it to the expert-owning model
  shards with one tiled all-to-all, computes its own experts at full
  width, reverses the all-to-all, combines locally, and all-gathers the
  token outputs over the model axis.
* TP regime (experts that do not divide the model axis): every expert's
  FFN is width-sharded over the model axis; dispatch is model-replicated
  and the combined token output is a partial sum over "model" (one
  all-reduce when it is read).

FSDP (embed-dim) weight shards are all-gathered when the expert weights
enter the per-shard region (ZeRO-3), and capacity is per-shard. The
router is replicated. Where the JAX package falls back to the global path
(a shard without whole token chunks, an expert width the model axis does
not divide), so does the port, counted in :data:`local_fallbacks`.

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

from . import hints
from ..obs import trace
from ..tree import flatten
from .layers import _gelu, _normal

# local-path calls that fell back to the global path, by the reference's
# two reasons; monotone, read by snapshot-and-diff
local_fallbacks: Dict[str, int] = {"tokens": 0, "expert_width": 0}


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


def moe_specs(cfg) -> Dict:
    s = {
        "router": (None, None),            # replicated: d·E is tiny
        "wi": ("expert", "embed", "mlp"),
        "wo": ("expert", "mlp", "embed"),
    }
    if cfg.act in ("swiglu", "geglu"):
        s["wg"] = ("expert", "embed", "mlp")
    if cfg.moe.num_shared_experts:
        s["shared"] = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
                       "wo": ("mlp", "embed")}
    return s


def _act(h, g, act: str):
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return _gelu(g) * h
    return _gelu(h)


# ---------------------------------------------------------------------------
# Routing, dispatch and combine (each a span of a serve step while the
# profiler records: ``obs.trace``)
# ---------------------------------------------------------------------------

# the outermost spans of a serve step, the only ones the MoE's spans and
# counters record under: a training forward under ``checkpoint`` runs again
# in the backward, and its spans would fire twice
_SERVE_ROOTS = ("prefill", "decode_step")


@trace.spanned("moe.route", within=_SERVE_ROOTS)
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
    counts = _expert_counts(expert_ids, m.num_experts).to(torch.float32)
    frac = counts / (N * m.top_k)
    aux = m.num_experts * torch.sum(frac * probs.mean(dim=0))
    return gate_vals, expert_ids, aux


def _expert_counts(expert_ids, E: int) -> torch.Tensor:
    """Pairs routed to each expert (int64 [E]): a scatter-add, which has
    a deterministic CUDA form and a shape that does not depend on the
    data (``meta`` tensors take it; ``bincount`` they do not)."""
    flat = expert_ids.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))


@trace.spanned("moe.dispatch", within=_SERVE_ROOTS)
def _dispatch_table(expert_ids, E: int, capacity: int):
    """Sorted-scatter table [E, C] int32 of flat (token·K) indices, the
    sentinel M where a slot is empty. Pairs past an expert's capacity are
    dropped (the JAX package's ``mode="drop"`` writes): they land in a
    spare column C that is cut off, so no shape depends on the data."""
    N, K = expert_ids.shape
    M = N * K
    flat_experts = expert_ids.reshape(M)
    sort_idx = torch.argsort(flat_experts, stable=True)
    sorted_experts = flat_experts[sort_idx]
    counts_i = _expert_counts(flat_experts, E)
    starts = torch.cumsum(counts_i, 0) - counts_i        # exclusive cumsum
    pos_in_expert = (torch.arange(M, device=expert_ids.device)
                     - starts[sorted_experts])
    slot = torch.clamp(pos_in_expert, max=capacity)
    table = torch.full((E, capacity + 1), M, dtype=torch.int32,
                       device=expert_ids.device)
    table.index_put_((sorted_experts, slot), sort_idx.to(torch.int32))
    return table[:, :capacity].contiguous(), M


def _note_drops(expert_ids, table, M: int) -> None:
    """The dispatch's dropped (token, k) pairs, ``M`` less the table's
    real entries (a 0-d device tensor, no sync), into :func:`tap_routing`'s
    record and the ``moe.routed_pairs`` / ``moe.dropped_pairs`` counters:
    one count feeds both."""
    counting = trace.recording(_SERVE_ROOTS)
    if _tap is None and not counting:
        return
    dropped = M - (table < M).sum()
    if _tap is not None:
        _tap.expert_ids.append(expert_ids)
        _tap.drops.append(dropped)
    if counting:
        trace.count("moe.routed_pairs", M)
        trace.count("moe.dropped_pairs", dropped)


@trace.spanned("moe.dispatch", within=_SERVE_ROOTS)
def _gather_tokens(xf, table, K: int):
    N, d = xf.shape
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    return x_pad[(table // K).long()]                     # [E, C, d]


@trace.spanned("moe.combine", within=_SERVE_ROOTS)
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
    # the inverse of the table: each real pair's row (E·C, the zero row,
    # for a dropped pair); empty slots all write the spare entry M
    inv = torch.full((M + 1,), E * C, dtype=torch.long, device=y_e.device)
    inv.index_put_((table.reshape(-1).long(),),
                   torch.arange(E * C, device=y_e.device))
    out = rows[inv[:M]].reshape(N, K, d)
    return out.to(torch.float32).sum(dim=1).to(y_e.dtype)


@trace.spanned("moe.experts", within=_SERVE_ROOTS)
def _expert_ffn(p, cfg, x_e):
    h = torch.bmm(x_e, p["wi"])
    g = torch.bmm(x_e, p["wg"]) if "wg" in p else None
    return torch.bmm(_act(h, g, cfg.act), p["wo"])


@trace.spanned("moe.experts", within=_SERVE_ROOTS)
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
    _note_drops(expert_ids, table, M)
    x_e = _gather_tokens(xf, table, m.top_k)
    y_e = _expert_ffn(p, cfg, x_e)
    y = _combine_tokens(y_e, gate_vals, table, N, m.top_k)
    if m.num_shared_experts:
        y = y + _shared_experts(p, cfg, xf)
    return y.reshape(b, s, d), aux


def _global_on_mesh(p: Dict, cfg, x, capacity: Optional[int]):
    """The global path under a mesh: on every rank over the replicated
    tokens and experts (the output replicated too)."""
    hints.record_fallback("moe global dispatch: tokens and experts "
                          "replicated over the mesh")
    leaves, treedef = flatten(p)
    n = len(leaves)

    def local(x, *leaves):
        return _apply_moe_global(treedef.unflatten(leaves[:n]), cfg, x,
                                 capacity)

    return hints.on_shards(local, [x] + leaves,
                           [(None, None, None)]
                           + [(None,) * t.dim() for t in leaves],
                           [(None, None, None), ()])


# ---------------------------------------------------------------------------
# Local path (per-shard dispatch, mesh present)
# ---------------------------------------------------------------------------

def _fsdp_axes(rules_map, dim: int, sizes: Dict[str, int]
               ) -> Optional[Tuple[str, ...]]:
    """Mirror dist/shardings: first FSDP candidate whose size divides dim."""
    default = [("pod", "data"), ("data",)] if "pod" in sizes \
        else [("data",)]
    cands = rules_map.get("fsdp_candidates", default)
    for c in cands:
        size = 1
        for a in c:
            size *= sizes[a]
        if dim % size == 0:
            return c
    return None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all over ``group``'s G ranks: split dim 0 into G
    pieces, send piece j to rank j, stack what arrives in rank order on
    dim 0 (autograd through it)."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    out = all_to_all_single_autograd(x.contiguous(), None, None, group)
    return out.wait() if hasattr(out, "wait") else out


def _apply_moe_local(p: Dict, cfg, x: torch.Tensor, ctx
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    from ..dist.shardings import axis_sizes
    mesh, rules = ctx
    m = cfg.moe
    b, s, d = x.shape
    sizes = axis_sizes(mesh)
    dp = rules["tokens"]
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    G = sizes["model"]
    E, K = m.num_experts, m.top_k
    ep = (E % G == 0)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    b_loc = b // n_dp
    if b_loc == 0 or b % n_dp or (ep and (b_loc * s) % G != 0):
        local_fallbacks["tokens"] += 1
        return _global_on_mesh(p, cfg, x, None)
    if not ep and m.expert_d_ff % G:
        local_fallbacks["expert_width"] += 1
        return _global_on_mesh(p, cfg, x, None)
    # the layouts mirror dist/shardings' greedy assignment: experts (EP)
    # or their width (TP) over "model", the embed dim over the FSDP axes
    fsdp = _fsdp_axes(rules, d, sizes)
    model = ("model",)
    w_in = (model, fsdp, None) if ep else (None, fsdp, model)
    w_out = (model, None, fsdp) if ep else (None, model, fsdp)
    model_group = mesh.get_group("model")
    gated = "wg" in p

    def gather_fsdp(w, dim):
        """ZeRO-3: this layer's expert weights, all-gathered over the
        FSDP axes (innermost first, as the shards nest)."""
        import torch.distributed._functional_collectives as funcol
        gather = getattr(funcol, "all_gather_single_autograd", None) or \
            funcol.all_gather_tensor_autograd   # the older name
        for a in reversed(fsdp or ()):
            w = gather(w, dim, mesh.get_group(a))
            w = w.wait() if hasattr(w, "wait") else w
        return w

    def local_fn(xl, router, wi, wo, wg=None):
        bl, sl, _ = xl.shape
        xf = xl.reshape(-1, d)                            # [N_loc, d]
        N_loc = xf.shape[0]
        pp = {"wi": gather_fsdp(wi, 1), "wo": gather_fsdp(wo, 2)}
        if wg is not None:
            pp["wg"] = gather_fsdp(wg, 1)
        if ep:
            # each model shard dispatches a disjoint token slice
            chunk = N_loc // G
            i = mesh.get_local_rank("model")
            xme = xf[i * chunk:(i + 1) * chunk]
            gate_vals, expert_ids, aux = _route(router, cfg, xme)
            table, M = _dispatch_table(expert_ids, E,
                                       moe_capacity(cfg, chunk))
            _note_drops(expert_ids, table, M)
            x_e = _gather_tokens(xme, table, K)           # [E, cap, d]
            cap = x_e.shape[1]
            # to the expert owners: [E, cap] → [E/G, G·cap]
            xa = _all_to_all(x_e, model_group).reshape(G, E // G, cap, d) \
                .transpose(0, 1).reshape(E // G, G * cap, d)
            y_own = _expert_ffn(pp, cfg, xa)              # [E/G, G·cap, d]
            y_e = _all_to_all(y_own.reshape(E // G, G, cap, d)
                              .transpose(0, 1).reshape(E, cap, d),
                              model_group)                # [E, cap, d]
            # this rank's token slice: the flat tokens sharded over the
            # data axes, then over "model" (all-gathered below)
            return (_combine_tokens(y_e, gate_vals, table, chunk, K),
                    aux / (n_dp * G))
        # TP experts: model-replicated dispatch, width-sharded FFN, a
        # partial sum over "model"
        gate_vals, expert_ids, aux = _route(router, cfg, xf)
        table, M = _dispatch_table(expert_ids, E, moe_capacity(cfg, N_loc))
        _note_drops(expert_ids, table, M)
        x_e = _gather_tokens(xf, table, K)
        y_e = _expert_ffn(pp, cfg, x_e)                   # partial over f
        y = _combine_tokens(y_e, gate_vals, table, N_loc, K)
        # every model rank routes the same tokens: each returns a G-th
        # of the aux (its input gradients are partial sums over "model")
        return y.reshape(bl, sl, d), aux / (n_dp * G)

    args = [x, p["router"], p["wi"], p["wo"]] + ([p["wg"]] if gated else [])
    axes = [(dp, None, None), (None, None), w_in, w_out] + \
        ([w_in] if gated else [])
    if ep:
        y, aux = hints.on_shards(
            local_fn, args, axes,
            [(dp + model, None), hints.Summed((), over=(dp, model))])
        # the all-gather of the token outputs over "model"
        y = y.redistribute(mesh, hints.layout((dp, None), mesh, rules)) \
            .reshape(b, s, d)
    else:
        y, aux = hints.on_shards(
            local_fn, args, axes,
            [hints.Summed((dp, None, None), over=(model,)),
             hints.Summed((), over=(dp, model))])
    if m.num_shared_experts:
        xf = x.reshape(b * s, d)
        y = y + _shared_experts(p, cfg, xf).reshape(b, s, d)
    return y, aux


def apply_moe(p: Dict, cfg, x: torch.Tensor,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] → (y [b, s, d], aux_loss scalar f32). ``moe_impl``
    "local" takes the per-shard path when a mesh is installed and the
    global one without."""
    ctx = hints.current_rules()
    if ctx is None:
        return _apply_moe_global(p, cfg, x, capacity)
    if getattr(cfg, "moe_impl", "global") == "local":
        return _apply_moe_local(p, cfg, x, ctx)
    return _global_on_mesh(p, cfg, x, capacity)
