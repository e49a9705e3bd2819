"""Logical-axis → mesh-axis assignment with divisibility fallbacks.

Models annotate every parameter dimension with a *logical* name
("embed", "mlp", "heads", "kv", "vocab", "expert", "lora", …; see
``models.transformer.logical_specs``). ``MeshRules`` maps each name to
an ordered list of candidate mesh-axis tuples; ``spec_for`` greedily
assigns, per tensor:

* dims are visited left-to-right; each mesh axis is used at most once per
  tensor;
* a candidate is taken only when the dim size is divisible by the product
  of the candidate's mesh-axis sizes (DTensor refuses what GSPMD pads);
* when no candidate fits, the dim replicates and the miss is recorded in
  ``rules.fallbacks`` (surfaced in the dry-run artifacts).

``make_rules`` builds the production rule table for a mesh (FSDP embed
over the batch axes; tensor-parallel model axis for vocab/mlp/heads/kv/
expert; MLA latents replicated). ``serve=True`` empties the FSDP
candidates so parameters replicate over the batch axes at inference.

The rules are the JAX package's, over the port's own :class:`P` (a tuple,
one entry per tensor dim: ``None``, a mesh-axis name or a tuple of them).
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, or any mapping of axis name → size (the tests compare the
rules on production shapes without a process group). :func:`placements`
turns a spec into one ``Shard(d)``/``Replicate()`` per mesh dimension and
:func:`distribute` places a tree of tensors by a tree of specs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..tree import tree_map


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, a mesh-axis
    name or a tuple of names), trailing ``None``s dropped by ``spec_for``
    as ``jax.sharding.PartitionSpec`` drops them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (its dim names), a mapping,
    or anything with a ``.shape`` mapping."""
    if isinstance(mesh, Mapping):
        return {k: int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {k: int(v) for k, v in mesh.shape.items()}


@dataclass
class MeshRules:
    mesh: Any                                     # DeviceMesh or a mapping
    batch_axes: Tuple[str, ...]
    candidates: Dict[str, List[Tuple[str, ...]]]
    fallbacks: List[str] = field(default_factory=list)


def _axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             rules: MeshRules) -> P:
    """Greedy one-axis-per-tensor assignment for one parameter."""
    used: set = set()
    entries: List[Any] = []
    for dim, name in zip(shape, logical):
        cands = rules.candidates.get(name, []) if name else []
        assigned: Optional[Tuple[str, ...]] = None
        missed = False
        for cand in cands:
            axes = tuple(cand)
            if any(a in used for a in axes):
                continue             # axis already carries another dim
            if dim % _axes_size(rules.mesh, axes) != 0:
                missed = True        # would be uneven — try the next
                continue
            assigned = axes
            break
        if assigned is None:
            if missed:
                rules.fallbacks.append(
                    f"{name}{tuple(shape)}: dim {dim} not divisible — "
                    f"replicated")
            entries.append(None)
            continue
        if missed:
            rules.fallbacks.append(
                f"{name}{tuple(shape)}: dim {dim} fell back to "
                f"{assigned}")
        used.update(assigned)
        entries.append(assigned[0] if len(assigned) == 1 else assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def make_rules(mesh, serve: bool = False) -> MeshRules:
    """The production rule table for ``mesh`` (axes: [pod,] data, model)."""
    multi_pod = "pod" in axis_sizes(mesh)
    batch = ("pod", "data") if multi_pod else ("data",)
    fsdp: List[Tuple[str, ...]] = [] if serve else (
        [("pod", "data"), ("data",)] if multi_pod else [("data",)])
    return MeshRules(
        mesh=mesh,
        batch_axes=batch,
        candidates={
            "vocab": [("model",)],
            "embed": fsdp,
            "mlp": [("model",)],
            "heads": [("model",)],
            "kv": [("model",)],
            "expert": [("model",)],
            "lora": [],
            "layers": [],
        },
    )


def param_pspecs(params: Any, logical: Any, rules: MeshRules) -> Any:
    """Spec tree for a parameter tree + its logical-name tree. The
    parameters may be tensors or anything with a ``.shape``."""

    def one(p, names):
        shape = tuple(p.shape)
        names = tuple(names) if names is not None else ()
        if len(names) < len(shape):
            names = names + (None,) * (len(shape) - len(names))
        return spec_for(shape, names[:len(shape)], rules)

    return tree_map(one, params, logical)


def batch_pspecs(batch: Any, rules: MeshRules) -> Any:
    """Shard the leading (batch) dim of every input leaf over the batch
    axes; anything not divisible (or scalar) replicates."""
    total = _axes_size(rules.mesh, rules.batch_axes)
    ax = (rules.batch_axes[0] if len(rules.batch_axes) == 1
          else tuple(rules.batch_axes))

    def one(x):
        shape = tuple(getattr(x, "shape", ()))
        if not shape or shape[0] % total != 0:
            return P()
        return P(ax)

    return tree_map(one, batch)


def placements(spec: P, mesh) -> Tuple[Any, ...]:
    """One ``Shard(d)`` or ``Replicate()`` per dimension of ``mesh`` for
    ``spec`` (a tensor dim split over several mesh axes is split over
    them in mesh order, as GSPMD tiles it)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def distribute(tree: Any, pspecs: Any, mesh) -> Any:
    """Every tensor of ``tree`` as a ``DTensor`` on ``mesh``, placed by
    the matching spec of ``pspecs`` (local shards cut from each rank's
    copy, so every rank must hold the same tensors). A tensor that
    requires grad stays a leaf that requires grad."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        d = distribute_tensor(t.detach(), mesh, placements(spec, mesh))
        return d.requires_grad_(t.requires_grad)

    return tree_map(one, tree, pspecs)
