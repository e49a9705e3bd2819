"""Carry state across as plain numpy data: tensor stores, causal dot
stores, model parameters and KV caches.

Model parameters and caches are pytrees (nested dicts and lists) of numpy
arrays with the JAX package's layout — ``init_model``'s params (layer
groups stacked along a leading ``layers`` axis; MoE layers' ``router``,
``wi``/``wg``/``wo`` expert stacks and ``shared`` experts, MLA layers'
latent projections and norms, SSM layers' ``w_z``/``w_xbc``/``w_dt``,
conv and f32 decay parameters) and ``prefill``'s caches (per group, per
layer of the super-block, ``{"k", "v", "pos", "idx"}`` for attention,
``{"ckv", "krope", "pos", "idx"}`` for MLA and ``{"ssm", "conv", "idx"}``
for SSM, stacked the same way). The port's trees have the same nesting
and shapes, leaf for leaf.

The plain form of a store is ``(entries, life)``:

* ``entries`` — ``{key: ({name: (values, versions, sparse)}, lamport)}``
  with ``values`` ``[rows, chunk]`` and ``versions`` ``[rows]`` int32
  numpy arrays. ``sparse`` is None for a dense tensor (``rows`` is its
  chunk count) or ``(idx, n_chunks)`` for a sparse row set (``idx`` the
  sorted chunk positions of the rows).
* ``life`` — ``[(key, (epoch, expiry))]``, the lifecycle table.

The plain form of a causal dot store is the JAX package's columnar
fields (``repro.core.dotcols``): a sorted replica-id table ``rids``, the
packed int64 dot column ``dots`` (``rid_index << 48 | seq``), the
context's dense ``vv`` column and sorted ``cloud`` column, and for a map
the key table and per-key group ``offsets``; ``vals`` are plain Python
objects aligned with ``dots``.

bf16 values travel as 2-byte void arrays (view them as
``ml_dtypes.bfloat16``, or pass such an array in: any 2-byte non-float
dtype is read as bfloat16).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np

from .core.dotcols import (SHAPE_FUN, SHAPE_SET, CausalContextCols,
                           DotFunCols, DotMapCols, DotSetCols)
from .core.store import LatticeStore
from .core.tensor_lattice import (ChunkedTensor, TensorState, sparse_chunks)
from .dtypes import BF16_NP, to_numpy, to_torch
from .tree import tree_map


def _host(values) -> np.ndarray:
    a = np.asarray(values)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "fiu":
        a = a.view(BF16_NP)       # ml_dtypes.bfloat16 or a raw 2-byte void
    return a


def store_from_numpy(entries: Mapping[str, Tuple[Mapping[str, tuple], int]],
                     life: Iterable = (), *, device="cuda") -> LatticeStore:
    """The port's :class:`LatticeStore` holding ``entries`` (see the
    module docstring): dense tensors on ``device``, sparse row sets as
    host numpy (their place in the port, as in the JAX package)."""
    out: Dict[str, Any] = {}
    for key, (tensors, lamport) in entries.items():
        chunks = {}
        for name, (vals, vers, sparse) in tensors.items():
            vals = _host(vals)
            vers = np.asarray(vers, dtype=np.int32)
            if sparse is None:
                chunks[name] = ChunkedTensor(to_torch(vals, device),
                                             to_torch(vers, device))
            else:
                idx, n_chunks = sparse
                chunks[name] = sparse_chunks(n_chunks, idx, vals, vers)
        out[key] = TensorState.of(chunks, lamport=int(lamport))
    return LatticeStore.of(out, dict(life))


def store_to_numpy(store: LatticeStore) -> Tuple[dict, list]:
    """``(entries, life)`` of a tensor-only store, all on the host."""
    entries: Dict[str, Any] = {}
    for key, val in store.entries:
        if not isinstance(val, TensorState):
            raise TypeError(f"key {key!r} holds {type(val).__name__}, not "
                            "a TensorState")
        tensors = {}
        for name, ct in val.chunks:
            if ct.is_sparse:
                tensors[name] = (np.asarray(ct.vals), np.asarray(ct.vers),
                                 (np.asarray(ct.idx), ct.n_chunks))
            else:
                tensors[name] = (to_numpy(ct.values), to_numpy(ct.versions),
                                 None)
        entries[key] = (tensors, val.lamport)
    return entries, list(store.life)


def dotstore_from_numpy(rids, dots, vv, cloud=(), *, vals=None, keys=None,
                        offsets=None):
    """The port's columnar ``(store, ctx)`` from the plain fields (see the
    module docstring): a ``DotSetCols`` when there are neither ``vals``
    nor ``keys``, a ``DotFunCols`` with ``vals``, a ``DotMapCols`` with
    ``keys`` and ``offsets`` whose groups are all DotFuns with ``vals``
    and all DotSets without. Columns are copied into int64 arrays; wrap
    the pair in a causal CRDT type, e.g.
    ``ORMap(*dotstore_from_numpy(...))``."""
    rids = tuple(rids)
    dots = np.array(dots, dtype=np.int64)
    ctx = CausalContextCols(rids, np.array(vv, dtype=np.int64),
                            np.array(cloud, dtype=np.int64))
    col = None
    if vals is not None or keys is not None:
        col = np.empty(dots.size, object)
        if isinstance(vals, np.ndarray) and vals.dtype != object:
            col[:] = vals                  # numbers, as Python objects
        elif vals is not None:
            for j, v in enumerate(vals):   # tuples stay one element each
                col[j] = v
    if keys is None:
        store = (DotSetCols(rids, dots) if col is None
                 else DotFunCols(rids, dots, col))
    else:
        keys = tuple(keys)
        shape = SHAPE_SET if vals is None else SHAPE_FUN
        store = DotMapCols(rids, keys, bytes([shape]) * len(keys),
                           np.array(offsets, dtype=np.int64), dots, col)
    return store, ctx


def params_from_numpy(tree: Any, *, device="cuda") -> Any:
    """The port's model parameters from a numpy pytree of the JAX
    package's ``init_model`` params (bf16 leaves as ``ml_dtypes`` or
    2-byte voids), on ``device``. Leaves are copied, never aliased."""
    return tree_map(lambda a: to_torch(np.array(_host(a)), device), tree)


def caches_from_numpy(tree: Any, *, device="cuda") -> Any:
    """The port's KV caches from a numpy pytree of the JAX package's
    caches, on ``device``. Leaves are copied: decode steps write the
    port's caches in place."""
    return params_from_numpy(tree, device=device)


def tree_to_numpy(tree: Any) -> Any:
    """Parameters or caches of the port as a numpy pytree (bf16 as
    ``V2``), the inverse of :func:`params_from_numpy`."""
    return tree_map(to_numpy, tree)
