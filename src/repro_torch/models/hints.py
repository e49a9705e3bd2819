"""Activation-sharding hints (mesh-optional).

Models are mesh-agnostic; the launcher installs a logical→mesh mapping and
models drop ``hint(x, ("batch", None, None))`` markers at the few places
where the default propagation is known to go wrong — without a mesh the
hints are no-ops.

Why this exists: with ZeRO-3 parameters (weight embed-dim sharded on the
FSDP axis) and batch sharded on the same axis, a product of the two may
be resolved by gathering the *activations* over batch instead of
un-sharding the small weight. Pinning activations to ("batch", …) keeps
the weight-gather (ZeRO) strategy.

The JAX package pins with ``with_sharding_constraint``; the port
``redistribute``s a ``DTensor`` to the mapped placements, by the same
rule: a dim takes its mapped mesh axes when its size divides their
product and none of them carries another dim of the tensor; every other
mesh axis replicates. A plain tensor (code running on local shards, as
inside ``local_map``) is returned unchanged.

Per-shard code — what the JAX package runs under ``shard_map`` (MoE's
local dispatch) and what must see plain tensors (the flash kernels, the
in-place cache writes, ops ``DTensor`` has no even split for) — runs
through :func:`on_shards`, which wraps ``local_map``: each rank calls the
function on its own shards, laid out by logical axis names as ``hint``
lays them out. Where a layout cannot be even (6 heads on a 4-wide
``"model"`` axis), the caller replicates that dim instead and records the
miss with :func:`record_fallback`; ``activation_rules`` yields the list
the dry-run writes beside ``rules.fallbacks``. Never a silent fallback.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..dist.shardings import P, axis_sizes, placements

_STATE = threading.local()


@contextmanager
def activation_rules(mesh: Optional[Any], rules: Dict[str, Any]):
    """rules: logical activation axis → mesh axis (str/tuple) or None.
    Yields the list that :func:`record_fallback` appends to inside."""
    prev = getattr(_STATE, "ctx", None)
    prev_fb = getattr(_STATE, "fallbacks", None)
    _STATE.ctx = (mesh, dict(rules)) if mesh is not None else None
    _STATE.fallbacks = []
    try:
        yield _STATE.fallbacks
    finally:
        _STATE.ctx = prev
        _STATE.fallbacks = prev_fb


@contextmanager
def reinstalled(ctx):
    """Install ``ctx`` (a ``current_rules()`` result, or ``None``) on this
    thread where it is not installed already: code that runs again on
    another thread (a recompute in the backward) sees the rules it first
    ran under. Its fallbacks were recorded on the first run."""
    if ctx is None or getattr(_STATE, "ctx", None) is ctx:
        yield
        return
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def record_fallback(what: str) -> None:
    """Record a layout the mesh could not give evenly (and what was done
    instead) in the installed context's fallback list."""
    fb = getattr(_STATE, "fallbacks", None)
    if fb is not None and what not in fb:
        fb.append(what)


def current_rules():
    """(mesh, rules) if a launcher installed them, else None — lets model
    code choose its per-shard (``local_map``) paths when a mesh is
    present."""
    return getattr(_STATE, "ctx", None)


def on_mesh(x: Any) -> Any:
    """A plain tensor as a ``DTensor`` replicated over the installed mesh
    (a launcher's full copy on every rank: a prompt, positions); a
    ``DTensor``, anything else, and everything without a mesh as it
    is."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    mesh = ctx[0]
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def hint_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
              mesh, rules: Dict[str, Any]) -> P:
    """The spec ``hint`` pins a tensor of ``shape`` to."""
    sizes = axis_sizes(mesh)
    mapped = []
    used: set = set()
    for dim, name in zip(shape, axes):
        m = rules.get(name) if name is not None else None
        if m is None:
            mapped.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        size = 1
        for a in ms:
            size *= sizes[a]
        if dim % size != 0 or any(a in used for a in ms):
            mapped.append(None)
            continue
        used.update(ms)
        mapped.append(m)
    return P(*mapped)


def hint(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or len(axes) != x.ndim:
        return x
    mesh, rules = ctx
    want = placements(hint_spec(x.shape, axes, mesh, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _installed_axes(name: Optional[str]):
    """(mesh, the mesh axes the installed rules map ``name`` to)."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return None, ()
    return ctx[0], _mesh_axes(name, ctx[1])


def axis_size(name: Optional[str]) -> int:
    """Product of the mesh axes the installed rules map ``name`` to (1
    without a mesh, or for a name no rule maps)."""
    mesh, axes = _installed_axes(name)
    size = 1
    for a in axes:
        size *= axis_sizes(mesh)[a]
    return size


def shard_index(name: Optional[str]) -> int:
    """This rank's coordinate along the mesh axes the installed rules map
    ``name`` to (flattened in mesh order; 0 without a mesh)."""
    mesh, axes = _installed_axes(name)
    index = 0
    for a in axes:
        index = index * axis_sizes(mesh)[a] + mesh.get_local_rank(a)
    return index


def even(name: str, *dims: int, what: str = "") -> Optional[str]:
    """``name`` if every one of ``dims`` splits evenly over its mesh
    axes, else ``None`` (replicate) with the miss recorded."""
    size = axis_size(name)
    if all(d % size == 0 for d in dims):
        return name
    record_fallback(f"{what or name}{tuple(dims)}: not divisible by "
                    f"{name}={size} — replicated")
    return None


class Summed(tuple):
    """An output layout whose values are partial sums over the mesh axes
    the names ``over`` map to (``Partial()`` there): one rank's share of
    a product over a sharded contraction dim."""

    def __new__(cls, axes: Sequence[Any], over: Sequence[str] = ("heads",)):
        t = super().__new__(cls, axes)
        t.over = tuple(over)
        return t


def _mesh_axes(name: Any, rules: Dict[str, Any]) -> Tuple[str, ...]:
    """The mesh axes a layout entry names: a logical name through the
    rules, or a tuple of mesh-axis names as it is."""
    if name is None:
        return ()
    if isinstance(name, tuple):
        return name
    m = rules.get(name)
    if m is None:
        return ()
    return (m,) if isinstance(m, str) else tuple(m)


def layout(axes, mesh, rules) -> Tuple[Any, ...]:
    """One placement per mesh dimension for a tensor whose dims carry
    ``axes`` (logical names, or tuples of mesh-axis names); a
    :class:`Summed` layout is ``Partial()`` over its ``over`` axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    index = {a: i for i, a in enumerate(mesh.mesh_dim_names)}
    summed = set()
    for name in getattr(axes, "over", ()):
        summed.update(_mesh_axes(name, rules))
    for a in summed:
        out[index[a]] = Partial()
    for d, name in enumerate(axes):
        for a in _mesh_axes(name, rules):
            if a in summed or not isinstance(out[index[a]], Replicate):
                raise ValueError(f"mesh axis {a} laid out twice in {axes}")
            out[index[a]] = Shard(d)
    return tuple(out)


def on_shards(fn: Callable, args: Sequence[Any],
              in_axes: Sequence[Optional[Sequence[Optional[str]]]],
              out_axes: Sequence[Optional[Sequence[Optional[str]]]],
              inplace: Sequence[int] = ()):
    """``fn(*args)``, on each rank's local shards when a mesh is installed
    and any argument is a ``DTensor``: each tensor argument is laid out by
    its ``in_axes`` entry (logical names per dim, mapped by the installed
    rules; a plain tensor counts as a full copy on every rank), ``fn``
    runs on the local tensors through ``local_map``, and its outputs (a
    tuple) come back as ``DTensor``s laid out by ``out_axes`` (a
    :class:`Summed` entry for partial sums; a tuple of mesh-axis names in
    place of a logical name is taken as it is). The caller picks axes that
    split evenly (:func:`even`). Non-tensor arguments take ``None``.
    The arguments at ``inplace`` (caches ``fn`` writes into) must already
    be laid out so: a copy would lose the writes.

    Gradients: an argument replicated over a mesh axis that splits the
    work (some argument is sharded over it) gets each rank's share of its
    gradient, a partial sum there; over an axis nothing is split on,
    every rank computes the whole gradient."""
    ctx = getattr(_STATE, "ctx", None)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if ctx is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh, rules = ctx
    placed, in_pl = [], []
    inplace = set(inplace)
    for i, (a, axes) in enumerate(zip(args, in_axes)):
        if not isinstance(a, torch.Tensor):
            placed.append(a)
            in_pl.append(None)
            continue
        want = layout(axes, mesh, rules)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(a.placements) != want:
            if i in inplace:
                raise ValueError(f"argument {i} is written in place but laid "
                                 f"out as {a.placements}, not {want}")
            a = a.redistribute(mesh, want)
        placed.append(a)
        in_pl.append(want)
    split = [any(pl is not None and pl[m].is_shard() for pl in in_pl)
             for m in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if split[m] and not p.is_shard() else p
        for m, p in enumerate(pl)) for pl in in_pl)
    out_pl = tuple(None if axes is None else layout(axes, mesh, rules)
                   for axes in out_axes)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh)(*placed)


def default_rules(multi_pod: bool, serve: bool = False) -> Dict[str, Any]:
    return {
        "batch": ("pod", "data") if multi_pod else "data",
        "tokens": ("pod", "data") if multi_pod else "data",
        "vocab": "model",
        "heads": "model",
        "mlp": "model",
        "expert": "model",
        # FSDP candidate axes for manual (local_map) weight gathers —
        # empty at inference (params replicated over batch axes when they
        # fit; see dist.shardings.make_rules(serve=True))
        "fsdp_candidates": [] if serve else (
            [("pod", "data"), ("data",)] if multi_pod else [("data",)]),
    }
