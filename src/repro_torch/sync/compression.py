"""Gradient/delta compression for cross-pod shipping.

Dense models touch every parameter every step, so chunk-version deltas
degenerate to full state per round (DESIGN.md §4). The practical payload
reducer is magnitude top-k sparsification with **error feedback**: the
un-shipped residual is accumulated locally and added to the next round's
delta, so the compression error is a delay, not a loss — exactly the
delta-friendly shape: each shipped sparse update is a uniquely-dotted
contribution to the ``DotSumStore`` lattice, still idempotent under
re-delivery.

The selection runs as torch ops on the leaf's device: a stable descending
sort of ``|x|``, so equal magnitudes keep the lower index first — the
tie rule of the JAX package's ``lax.top_k`` (``torch.topk`` makes no such
promise).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import tree as tu
from ..dtypes import to_torch
from ..obs.trace import spanned


def _topk_sparsify(x: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices (int32) and values of the k largest-|·| entries of
    flattened x, by descending magnitude, ties to the lower index."""
    flat = x.reshape(-1)
    k = max(1, min(int(k), flat.shape[0]))
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return order.to(torch.int32), flat[order]


def _is_sparse_leaf(t) -> bool:
    return isinstance(t, dict) and "idx" in t


class TopKCompressor:
    """Per-leaf top-k with error feedback.

    ``compress`` returns a sparse pytree-of-(idx, vals, shape) and keeps the
    residual; ``decompress`` densifies. Rate is the kept fraction.
    """

    def __init__(self, rate: float = 0.01):
        assert 0.0 < rate <= 1.0
        self.rate = rate
        self.residual: Optional[Any] = None

    @spanned("topk.compress")
    def compress(self, update: Any) -> Any:
        if self.residual is None:
            self.residual = tu.tree_map(torch.zeros_like, update)
        carried = tu.tree_map(lambda u, r: u + r, update, self.residual)

        def one(x):
            n = int(np.prod(x.shape))
            k = max(1, int(round(self.rate * n)))
            idx, vals = _topk_sparsify(x, k)
            return {"idx": idx, "vals": vals, "shape": tuple(x.shape)}

        sparse = tu.tree_map(one, carried)

        def leftover(x, s):
            x.reshape(-1)[s["idx"].long()] = 0   # x is this call's own sum
            return x

        self.residual = tu.tree_map(leftover, carried, sparse)
        return sparse

    @staticmethod
    def decompress(sparse: Any) -> Any:
        def one(s):
            vals = to_torch(s["vals"])
            idx = to_torch(s["idx"], vals.device).long()
            flat = torch.zeros(int(np.prod(s["shape"])), dtype=vals.dtype,
                               device=vals.device)
            flat[idx] = vals
            return flat.reshape(tuple(s["shape"]))

        return tu.tree_map(one, sparse, is_leaf=_is_sparse_leaf)


def topk_frame(sparse: Any) -> bytes:
    """Encode a :meth:`TopKCompressor.compress` result as one ``topk``
    wire frame (raw index/value columns + a tiny pickled treedef — see
    ``repro_torch.wire.codec.encode_topk``), byte for byte the JAX
    package's. ``len(frame)`` is the measured wire size."""
    from ..wire import encode_frame, encode_topk

    return encode_frame("topk", encode_topk(sparse))


def topk_unframe(frame) -> Any:
    """Decode a ``topk`` frame back to the sparse pytree
    (:meth:`TopKCompressor.decompress`-ready)."""
    from ..wire import FrameError, decode_frame, decode_topk

    kind, payload = decode_frame(frame)
    if kind != "topk":
        raise FrameError(f"expected a topk frame, got {kind!r}")
    return decode_topk(payload)


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def _itemsize(x) -> int:
    return (x.element_size() if isinstance(x, torch.Tensor)
            else np.asarray(x).dtype.itemsize)


def sparse_nbytes(sparse: Any) -> int:
    total = 0
    for leaf in tu.leaves(sparse, is_leaf=_is_sparse_leaf):
        total += _numel(leaf["idx"]) * 4 + _numel(leaf["vals"]) * \
            _itemsize(leaf["vals"])
    return total


def dense_nbytes(tree: Any) -> int:
    return sum(_numel(x) * _itemsize(x) for x in tu.leaves(tree))
