"""Array-backed (columnar) dot stores and causal contexts.

The :mod:`repro_torch.core.dots` objects are the paper-shaped small-state path
and the oracle: frozensets of ``(replica_id, counter)`` tuples walked
dot-by-dot. At a million dots every causal join re-derives a vv dict per
``contains`` call and re-sorts tuple entries — seconds of Python time
for an operation that is structurally a sorted merge. This module is the
large-state fast path, mirroring the ``SparseChunks``/``ChunkedTensor``
dual-representation precedent of the tensor side:

* A dot packs into one ``int64`` as ``(rid_index << 48) | seq`` against
  a per-object sorted replica-id string table, so sorted packed order is
  exactly lexicographic ``(replica_id, seq)`` order and every causal
  operation becomes a vectorized sorted-merge / ``searchsorted`` pass.
* :class:`CausalContextCols` carries the §7.2 compressed context as a
  dense vv column (aligned with the rid table) plus a sorted packed
  cloud column.
* :class:`DotSetCols` / :class:`DotFunCols` / :class:`DotMapCols` carry
  the store as (rid table, sorted packed dot column, value table, and —
  for maps — a key table with per-key group offsets).
* :func:`causal_join_cols` computes the Fig. 3b/4 causal join

      (s, c) ⊔ (s', c') = ((s∩s') ∪ {d∈s | d∉c'} ∪ {d∈s' | d∉c}, c∪c')

  entirely with array ops: dot membership of each side in the other via
  ``searchsorted`` over the flat sorted dot column (dots are globally
  unique 𝕀×ℕ tags, so dot identity implies key identity), containment
  in the other causal context via a vectorized vv-lookup + cloud
  ``searchsorted`` (:func:`missing_mask`, which sends columns of at
  least ``_DEVICE_MIN_ROWS`` rows to torch ops on the card), and the
  result assembled with one merge.

Everything but :func:`missing_mask` stays numpy on the host, as in the
JAX package. The mask's device is one scoped default: the card
(``"cuda"``) unless a caller scopes another with :func:`mask_device`
(``with mask_device("cpu"): ...``). On the CPU an auto-dispatched mask
runs its plain numpy version; on the card it stages the three columns,
runs, and brings the mask back, counted in :data:`launches` and in
``kernels.ops.counters``. A machine without a card raises rather than
fall back.

Every columnar class duck-types the ``dots.py`` API surface the causal
CRDTs in :mod:`repro_torch.core.crdts` consume (``.dots``, ``.entries``,
``.all_dots()``, ``.values()``, ``.as_dict()``, ``is_bottom``,
``next_dot`` …), materializing tuples only at those small-state call
sites, and equality is cross-representation (``AWORSet(obj) ==
AWORSet(cols)`` holds whenever the states are equal), so engine code
never branches on representation.

The module also hosts the **per-dot digest** machinery behind
digest-sync pull for dot stores: :class:`CausalDigest` (a key's vv +
cloud summary plus its flat store dot column) and
:func:`causal_diff_cols`, which computes the provably-minimal response

    s_ship = {d ∈ s_resp | d ∉ c_req}
    c_ship = {d ∈ s_req_digest | d ∈ c_resp, d ∉ s_resp}  ∪  (c_resp \\ c_req)

whose join at the requester is *exactly* the join of the responder's
full state (the Def. 6 merging-condition argument is spelled out in
DESIGN.md §9). Nested ``DotMap``-inside-``DotMap`` stores are the one
shape the columnar form does not model; conversion returns ``None`` and
callers fall back to the object path (wire: opaque pickle).
"""

from __future__ import annotations

import contextlib
import contextvars
from bisect import bisect_left
from dataclasses import dataclass
from itertools import compress
from typing import Any, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from ..dtypes import to_torch
from .dots import CausalContext, Dot, DotFun, DotMap, DotSet, _freeze_vv

SEQ_BITS = 48                      # seq < 2^48; rid index < 2^15 (sign clear)
SEQ_MASK = np.int64((1 << SEQ_BITS) - 1)

SHAPE_SET, SHAPE_FUN, SHAPE_MAP = 0, 1, 2

_EMPTY64 = np.empty(0, np.int64)
_EMPTY_OBJ = np.empty(0, object)

# columns at or above this row count dispatch membership filtering to the
# torch path on the scoped device (the JAX package's _JIT_MIN_ROWS)
_DEVICE_MIN_ROWS = 1 << 17

# the device the torch path of missing_mask runs on (see mask_device)
_MASK_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "mask_device", default="cuda")

# launches of the mask on the card; the CPU adds nothing
launches: Dict[str, int] = {"missing_mask": 0}


def is_columnar(x: Any) -> bool:
    return getattr(x, "columnar", False)


# ---------------------------------------------------------------------------
# Packing / rid tables
# ---------------------------------------------------------------------------

def pack_dot(rids: Tuple[str, ...], dot: Dot) -> int:
    return (rids.index(dot[0]) << SEQ_BITS) | dot[1]


def _pack_pairs(rids: Tuple[str, ...], pairs) -> np.ndarray:
    idx = {r: j for j, r in enumerate(rids)}
    pairs = list(pairs)
    return np.fromiter(((idx[i] << SEQ_BITS) | n for i, n in pairs),
                       np.int64, count=len(pairs))


def _unpack(rids: Tuple[str, ...], packed: np.ndarray) -> FrozenSet[Dot]:
    return frozenset((rids[int(d) >> SEQ_BITS], int(d & SEQ_MASK))
                     for d in packed)


def _union_rids(*tables: Tuple[str, ...]):
    """Union rid table plus one remap column per input (None = identity).

    Both inputs and the union are sorted, so every remap column is
    monotone — remapping a sorted packed column preserves its order.
    """
    base = tables[0]
    if all(t == base for t in tables[1:]):
        return base, [None] * len(tables)
    u = tuple(sorted(set().union(*tables)))
    idx = {r: j for j, r in enumerate(u)}
    maps = []
    for t in tables:
        if t == u:
            maps.append(None)
        else:
            maps.append(np.fromiter((idx[r] for r in t), np.int64,
                                    count=len(t)))
    return u, maps


def _remap(packed: np.ndarray, rmap: Optional[np.ndarray]) -> np.ndarray:
    if rmap is None or packed.size == 0:
        return packed
    return (rmap[packed >> SEQ_BITS] << SEQ_BITS) | (packed & SEQ_MASK)


def _dense_vv(n_rids: int, rmap: Optional[np.ndarray],
              vvcol: np.ndarray) -> np.ndarray:
    """Densify a vv column over a union rid table."""
    if rmap is None and vvcol.size == n_rids:
        return vvcol
    out = np.zeros(n_rids, np.int64)
    if vvcol.size:
        out[rmap if rmap is not None else np.arange(vvcol.size)] = vvcol
    return out


def _in_sorted(sorted_arr: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Boolean membership of ``queries`` in a sorted array."""
    if queries.size == 0:
        return np.zeros(0, bool)
    if sorted_arr.size == 0:
        return np.zeros(queries.size, bool)
    pos = np.searchsorted(sorted_arr, queries)
    posc = np.minimum(pos, sorted_arr.size - 1)
    return (pos < sorted_arr.size) & (sorted_arr[posc] == queries)


# ---------------------------------------------------------------------------
# Vectorized containment: the inner loop of every causal join
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def mask_device(device):
    """Scope the device that :func:`missing_mask`'s torch path runs on
    (default ``"cuda"``) for every causal join, digest diff and context
    comparison inside the ``with`` block."""
    token = _MASK_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _MASK_DEVICE.reset(token)


def _torch_missing(vv: torch.Tensor, cloud: torch.Tensor,
                   dots: torch.Tensor) -> torch.Tensor:
    """:func:`missing_mask` in torch ops on one device (int64 columns)."""
    miss = (dots & int(SEQ_MASK)) > vv[dots >> SEQ_BITS]
    if cloud.numel():
        pos = torch.searchsorted(cloud, dots)
        found = cloud[pos.clamp(max=cloud.numel() - 1)] == dots
        miss &= ~(found & (pos < cloud.numel()))
    return miss


def missing_mask(vvcol: np.ndarray, cloudcol: np.ndarray,
                 dots: np.ndarray, backend: Optional[str] = None
                 ) -> np.ndarray:
    """``mask[i]`` ⇔ ``dots[i]`` is NOT contained in the context
    ``(vvcol, cloudcol)``. All three operands share one rid space and
    ``vvcol`` is dense over it; ``cloudcol`` is sorted.

    ``backend=None`` auto-dispatches: numpy below ``_DEVICE_MIN_ROWS``
    rows or when the scoped device (:func:`mask_device`) is the CPU,
    else the torch path on that device. ``"numpy"`` / ``"torch"`` force
    a path (parity tests do); ``"torch"`` runs on the scoped device.
    """
    if dots.size == 0:
        return np.zeros(0, bool)
    dev = _MASK_DEVICE.get()
    if backend is None:
        backend = ("torch" if dots.size >= _DEVICE_MIN_ROWS
                   and torch.device(dev).type != "cpu" else "numpy")
    if backend == "torch":
        return _mask_on(torch.device(dev), vvcol, cloudcol, dots)
    if backend != "numpy":
        raise ValueError(f"unknown missing_mask backend {backend!r}")
    rid = dots >> SEQ_BITS
    seq = dots & SEQ_MASK
    miss = seq > vvcol[rid]
    if cloudcol.size:
        miss &= ~_in_sorted(cloudcol, dots)
    return miss


def _mask_on(dev: torch.device, vvcol, cloudcol, dots) -> np.ndarray:
    """The torch path: stage the three columns on ``dev``, run, and
    bring the mask back. On the card the launch and its staged bytes are
    counted; a card that is not there raises."""
    cols = [np.ascontiguousarray(c, dtype=np.int64)
            for c in (vvcol, cloudcol, dots)]
    if dev.type == "cpu":
        return _torch_missing(*map(to_torch, cols)).numpy()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "missing_mask: no CUDA device for the mask of "
            f"{dots.size} dots; scope mask_device('cpu') to run it on "
            "the host")
    from ..kernels import ops
    ops.record_launch("missing_mask", *cols, device=dev)
    launches["missing_mask"] += 1
    mask = _torch_missing(*(to_torch(c, dev) for c in cols))
    ops.counters.count_d2h(mask)
    return mask.cpu().numpy()


def _normalize_cols(vvcol: np.ndarray, cloud: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """§7.2 compression, columnar: absorb contiguous cloud dots into the
    vv prefix and drop covered ones. ``vvcol`` is dense; ``cloud`` need
    not be sorted or unique. Returns the new (vv, sorted cloud)."""
    vv = np.array(vvcol, np.int64, copy=True)
    if cloud.size == 0:
        return vv, _EMPTY64
    cloud = np.unique(cloud)
    rid = cloud >> SEQ_BITS
    seq = cloud & SEQ_MASK
    starts = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]])
    ends = np.r_[starts[1:], np.int64(rid.size)]
    keep = np.zeros(cloud.size, bool)
    for s, e in zip(starts, ends):          # one iteration per replica
        r = int(rid[s])
        base = int(vv[r])
        seqs = seq[s:e]
        rest = seqs[seqs > base]
        if rest.size == 0:
            continue                         # all covered by the prefix
        run = (rest - np.arange(rest.size)) == base + 1
        t = int(rest.size if run.all() else run.argmin())
        if t:
            vv[r] = base + t
        kk = np.zeros(seqs.size, bool)
        kk[seqs > base] = np.arange(rest.size) >= t
        keep[s:e] = kk
    return vv, cloud[keep]


# ---------------------------------------------------------------------------
# Columnar causal context
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CausalContextCols:
    """Compressed causal context as columns: a sorted rid table, a dense
    int64 vv column aligned with it, and a sorted packed cloud column.
    Same normalization invariant as :class:`~repro_torch.core.dots.
    CausalContext`; equality and hashing are cross-representation."""

    rids: Tuple[str, ...]
    vvcol: np.ndarray
    cloudcol: np.ndarray

    columnar = True

    @staticmethod
    def bottom() -> "CausalContextCols":
        return _CTX_BOTTOM

    @staticmethod
    def from_obj(cc: CausalContext) -> "CausalContextCols":
        if isinstance(cc, CausalContextCols):
            return cc
        rids = tuple(sorted({i for i, _ in cc.vv}
                            | {i for i, _ in cc.cloud}))
        vvd = dict(cc.vv)
        vv = np.fromiter((vvd.get(r, 0) for r in rids), np.int64,
                         count=len(rids))
        cloud = np.sort(_pack_pairs(rids, cc.cloud))
        return CausalContextCols(rids, vv, cloud)

    def to_obj(self) -> CausalContext:
        vv = {r: int(n) for r, n in zip(self.rids, self.vvcol) if n}
        return CausalContext(vv=_freeze_vv(vv),
                             cloud=_unpack(self.rids, self.cloudcol))

    # -- dots.py-compatible surface -----------------------------------------
    @property
    def vv(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((r, int(n)) for r, n in zip(self.rids, self.vvcol)
                     if n)

    @property
    def cloud(self) -> FrozenSet[Dot]:
        return _unpack(self.rids, self.cloudcol)

    def vv_dict(self) -> Dict[str, int]:
        return dict(self.vv)

    def contains(self, dot: Dot) -> bool:
        i, n = dot
        if n <= 0:
            return True
        try:
            j = self.rids.index(i)
        except ValueError:
            return False
        if n <= int(self.vvcol[j]):
            return True
        return bool(_in_sorted(self.cloudcol,
                               np.array([(j << SEQ_BITS) | n], np.int64))[0])

    def max_for(self, i: str) -> int:
        try:
            j = self.rids.index(i)
        except ValueError:
            return 0
        base = int(self.vvcol[j])
        lo = np.searchsorted(self.cloudcol, np.int64(j) << SEQ_BITS)
        hi = np.searchsorted(self.cloudcol, np.int64(j + 1) << SEQ_BITS)
        if hi > lo:
            base = max(base, int(self.cloudcol[hi - 1] & SEQ_MASK))
        return base

    def next_dot(self, i: str) -> Dot:
        return (i, self.max_for(i) + 1)

    def join(self, other) -> "CausalContextCols":
        o = CausalContextCols.from_obj(other)
        rids, (ma, mb) = _union_rids(self.rids, o.rids)
        vv = np.maximum(_dense_vv(len(rids), ma, self.vvcol),
                        _dense_vv(len(rids), mb, o.vvcol))
        cloud = np.concatenate([_remap(self.cloudcol, ma),
                                _remap(o.cloudcol, mb)])
        vv, cloud = _normalize_cols(vv, cloud)
        return CausalContextCols(rids, vv, cloud)

    def leq(self, other) -> bool:
        o = CausalContextCols.from_obj(other)
        rids, (ma, mb) = _union_rids(self.rids, o.rids)
        vv_s = _dense_vv(len(rids), ma, self.vvcol)
        vv_o = _dense_vv(len(rids), mb, o.vvcol)
        if (vv_s > vv_o).any():
            return False
        cloud_s = _remap(self.cloudcol, ma)
        return not missing_mask(vv_o, _remap(o.cloudcol, mb),
                                cloud_s).any()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, CausalContextCols):
            if self.rids == other.rids:
                return (np.array_equal(self.vvcol, other.vvcol)
                        and np.array_equal(self.cloudcol, other.cloudcol))
            return self.vv == other.vv and self.cloud == other.cloud
        if isinstance(other, CausalContext):
            return self.vv == other.vv and self.cloud == other.cloud
        return NotImplemented

    def __hash__(self) -> int:
        # matches CausalContext's frozen-dataclass hash of (vv, cloud)
        return hash((self.vv, self.cloud))


_CTX_BOTTOM = CausalContextCols((), _EMPTY64, _EMPTY64)


def ctx_to_cols(ctx) -> CausalContextCols:
    return CausalContextCols.from_obj(ctx)


# ---------------------------------------------------------------------------
# Columnar dot stores
# ---------------------------------------------------------------------------

class _ColsStore:
    """Shared duck-typed surface; subclasses are frozen dataclasses."""

    columnar = True

    def flat_sorted(self) -> np.ndarray:
        """The store's dot column, globally sorted (memoized — packed
        columns are only guaranteed sorted within a key group)."""
        return self.packed                     # single-group default

    def all_dots(self) -> FrozenSet[Dot]:
        return _unpack(self.rids, self.packed)

    def is_bottom(self) -> bool:
        return self.packed.size == 0


@dataclass(frozen=True, eq=False)
class DotSetCols(_ColsStore):
    """Columnar :class:`~repro_torch.core.dots.DotSet`: a sorted packed dot
    column against a sorted rid table."""

    rids: Tuple[str, ...]
    packed: np.ndarray

    @staticmethod
    def bottom() -> "DotSetCols":
        return _DOTSET_BOTTOM

    @staticmethod
    def from_obj(s: DotSet) -> "DotSetCols":
        rids = tuple(sorted({i for i, _ in s.dots}))
        return DotSetCols(rids, np.sort(_pack_pairs(rids, s.dots)))

    def to_obj(self) -> DotSet:
        return DotSet(self.all_dots())

    @property
    def dots(self) -> FrozenSet[Dot]:
        return self.all_dots()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DotSetCols):
            if self.rids == other.rids:
                return np.array_equal(self.packed, other.packed)
            return self.dots == other.dots
        if isinstance(other, DotSet):
            return self.dots == other.dots
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.dots,))


_DOTSET_BOTTOM = DotSetCols((), _EMPTY64)


@dataclass(frozen=True, eq=False)
class DotFunCols(_ColsStore):
    """Columnar :class:`~repro_torch.core.dots.DotFun`: sorted packed dot
    column plus a value table aligned with it (object ndarray, so joins
    gather values with fancy indexing instead of Python loops)."""

    rids: Tuple[str, ...]
    packed: np.ndarray
    vals: np.ndarray

    @staticmethod
    def bottom() -> "DotFunCols":
        return _DOTFUN_BOTTOM

    @staticmethod
    def from_obj(s: DotFun) -> "DotFunCols":
        rids = tuple(sorted({i for (i, _), _ in s.entries}))
        # DotFun entries are sorted by (rid, seq) tuples — identical to
        # packed order against the sorted rid table
        packed = _pack_pairs(rids, (d for d, _ in s.entries))
        vals = np.empty(len(s.entries), object)
        for j, (_, v) in enumerate(s.entries):
            vals[j] = v
        return DotFunCols(rids, packed, vals)

    def to_obj(self) -> DotFun:
        return DotFun(self.entries)

    @property
    def entries(self) -> Tuple[Tuple[Dot, Any], ...]:
        rids = self.rids
        return tuple(((rids[int(d) >> SEQ_BITS], int(d & SEQ_MASK)), v)
                     for d, v in zip(self.packed, self.vals))

    def as_dict(self) -> Dict[Dot, Any]:
        return dict(self.entries)

    def values(self) -> Tuple[Any, ...]:
        return tuple(self.vals)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DotFunCols):
            if self.packed.size != other.packed.size:
                return False
            if self.rids == other.rids:
                return (np.array_equal(self.packed, other.packed)
                        and bool(np.array_equal(self.vals, other.vals)))
            return self.entries == other.entries
        if isinstance(other, DotFun):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.entries,))


_DOTFUN_BOTTOM = DotFunCols((), _EMPTY64, _EMPTY_OBJ)


@dataclass(frozen=True, eq=False)
class DotMapCols(_ColsStore):
    """Columnar :class:`~repro_torch.core.dots.DotMap`: a key table sorted by
    ``repr`` (the ``DotMap.of`` order) with per-key group offsets into
    one packed dot column (sorted within each group) and one aligned
    value table. ``shapes[k]`` says whether group ``k`` is a DotSet or a
    DotFun; nested DotMap values are not modeled (conversion returns
    None and callers stay on the object path)."""

    rids: Tuple[str, ...]
    map_keys: Tuple[Any, ...]
    shapes: bytes                      # SHAPE_SET / SHAPE_FUN per key
    offsets: np.ndarray                # int64 [len(map_keys) + 1]
    packed: np.ndarray
    vals: np.ndarray                   # aligned; None under SET groups

    @staticmethod
    def bottom() -> "DotMapCols":
        return _DOTMAP_BOTTOM

    @staticmethod
    def from_obj(s: DotMap) -> Optional["DotMapCols"]:
        rid_set: set = set()
        for _, sub in s.entries:
            if isinstance(sub, DotMap):
                return None            # nested maps: object path only
            for i, _ in sub.all_dots():
                rid_set.add(i)
        rids = tuple(sorted(rid_set))
        keys, shapes, offs, cols, vals = [], bytearray(), [0], [], []
        for k, sub in s.entries:
            keys.append(k)
            if isinstance(sub, DotSet):
                shapes.append(SHAPE_SET)
                col = np.sort(_pack_pairs(rids, sub.dots))
                vals.extend([None] * col.size)
            else:
                shapes.append(SHAPE_FUN)
                col = _pack_pairs(rids, (d for d, _ in sub.entries))
                vals.extend(v for _, v in sub.entries)
            cols.append(col)
            offs.append(offs[-1] + col.size)
        packed = (np.concatenate(cols) if cols else _EMPTY64)
        va = np.empty(len(vals), object)
        for j, v in enumerate(vals):
            va[j] = v
        return DotMapCols(rids, tuple(keys), bytes(shapes),
                          np.asarray(offs, np.int64), packed, va)

    def to_obj(self) -> DotMap:
        return DotMap(tuple((k, sub.to_obj()) for k, sub in self.entries))

    def flat_sorted(self) -> np.ndarray:
        cached = self.__dict__.get("_flat")
        if cached is None:
            cached = np.sort(self.packed)
            object.__setattr__(self, "_flat", cached)
        return cached

    def _sub(self, i: int):
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        if self.shapes[i] == SHAPE_SET:
            return DotSetCols(self.rids, self.packed[s:e])
        return DotFunCols(self.rids, self.packed[s:e], self.vals[s:e])

    def _key_reprs(self):
        cached = self.__dict__.get("_reprs")
        if cached is None:
            cached = [repr(k) for k in self.map_keys]
            object.__setattr__(self, "_reprs", cached)
        return cached

    def get(self, key: Any, default: Any) -> Any:
        """O(log n) lookup by the repr-sorted key table (the object
        DotMap's ``get`` materializes the whole dict)."""
        reprs = self._key_reprs()
        r = repr(key)
        i = bisect_left(reprs, r)
        while i < len(reprs) and reprs[i] == r:
            if self.map_keys[i] == key:
                return self._sub(i)
            i += 1
        return default

    @property
    def entries(self) -> Tuple[Tuple[Any, Any], ...]:
        return tuple((k, self._sub(i))
                     for i, k in enumerate(self.map_keys))

    def as_dict(self) -> Dict[Any, Any]:
        return {k: self._sub(i) for i, k in enumerate(self.map_keys)}

    def is_bottom(self) -> bool:
        return len(self.map_keys) == 0

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DotMapCols):
            if self.map_keys != other.map_keys or self.shapes != other.shapes:
                return False
            if not np.array_equal(self.offsets, other.offsets):
                return False
            if self.rids == other.rids:
                return (np.array_equal(self.packed, other.packed)
                        and bool(np.array_equal(self.vals, other.vals)))
            return self.entries == other.entries
        if isinstance(other, DotMap):
            if len(self.map_keys) != len(other.entries):
                return False
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.entries,))


_DOTMAP_BOTTOM = DotMapCols((), (), b"", np.zeros(1, np.int64),
                            _EMPTY64, _EMPTY_OBJ)


def store_to_cols(store) -> Optional[Any]:
    """Columnar form of a dot store (identity if already columnar);
    None for shapes the columnar form does not model (nested maps)."""
    if is_columnar(store):
        return store
    if isinstance(store, DotSet):
        return DotSetCols.from_obj(store)
    if isinstance(store, DotFun):
        return DotFunCols.from_obj(store)
    if isinstance(store, DotMap):
        return DotMapCols.from_obj(store)
    return None


def value_to_cols(value):
    """Same causal CRDT with columnar store + context, or None if the
    store shape is not columnar-representable."""
    store = store_to_cols(value.store)
    if store is None:
        return None
    if is_columnar(value.store) and is_columnar(value.ctx):
        return value
    return type(value)(store, ctx_to_cols(value.ctx))


def value_to_obj(value):
    """Same causal CRDT on the dots.py object representation."""
    store = value.store.to_obj() if is_columnar(value.store) else value.store
    ctx = value.ctx.to_obj() if is_columnar(value.ctx) else value.ctx
    if store is value.store and ctx is value.ctx:
        return value
    return type(value)(store, ctx)


# ---------------------------------------------------------------------------
# The columnar causal join
# ---------------------------------------------------------------------------

def _merge_disjoint(a: np.ndarray, b: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge two sorted disjoint columns; returns (merged, pos_a, pos_b)
    with the output positions of each input element."""
    if a.size == 0:
        return b, _EMPTY64, np.arange(b.size, dtype=np.int64)
    if b.size == 0:
        return a, np.arange(a.size, dtype=np.int64), _EMPTY64
    pos_a = np.searchsorted(b, a) + np.arange(a.size)
    pos_b = np.searchsorted(a, b) + np.arange(b.size)
    out = np.empty(a.size + b.size, np.int64)
    out[pos_a] = a
    out[pos_b] = b
    return out, pos_a, pos_b


def _group_counts(mask: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Per-group surviving-row counts of a keep mask."""
    cs = np.concatenate([np.zeros(1, np.int64),
                         np.cumsum(mask, dtype=np.int64)])
    return cs[offsets[1:]] - cs[offsets[:-1]]


def _union_keys(a: DotMapCols, b: DotMapCols):
    """Union key table (repr-sorted) plus per-side position columns."""
    if a.map_keys == b.map_keys:
        ar = np.arange(len(a.map_keys), dtype=np.int64)
        return a.map_keys, ar, ar
    da = {k: i for i, k in enumerate(a.map_keys)}
    db = {k: i for i, k in enumerate(b.map_keys)}
    if all(k in da for k in b.map_keys):
        return (a.map_keys, np.arange(len(a.map_keys), dtype=np.int64),
                np.fromiter((da[k] for k in b.map_keys), np.int64,
                            count=len(b.map_keys)))
    if all(k in db for k in a.map_keys):
        return (b.map_keys,
                np.fromiter((db[k] for k in a.map_keys), np.int64,
                            count=len(a.map_keys)),
                np.arange(len(b.map_keys), dtype=np.int64))
    u = tuple(sorted(set(a.map_keys) | set(b.map_keys), key=repr))
    du = {k: i for i, k in enumerate(u)}
    return (u,
            np.fromiter((du[k] for k in a.map_keys), np.int64,
                        count=len(a.map_keys)),
            np.fromiter((du[k] for k in b.map_keys), np.int64,
                        count=len(b.map_keys)))


def causal_join_cols(store_a, ctx_a, store_b, ctx_b):
    """Vectorized Fig. 3b/4 causal join; returns (store, ctx), both
    columnar. Either side may be on the object representation (it is
    converted); if either store shape is not columnar-representable the
    whole join falls back to the object path."""
    A = store_to_cols(store_a)
    B = store_to_cols(store_b)
    if A is None or B is None:
        sa = store_a.to_obj() if is_columnar(store_a) else store_a
        sb = store_b.to_obj() if is_columnar(store_b) else store_b
        ca = ctx_a.to_obj() if is_columnar(ctx_a) else ctx_a
        cb = ctx_b.to_obj() if is_columnar(ctx_b) else ctx_b
        return sa.causal_join(ca, sb, cb), ca.join(cb)
    if type(A) is not type(B):
        raise TypeError(f"cannot causal-join {type(A).__name__} "
                        f"with {type(B).__name__}")
    ca = ctx_to_cols(ctx_a)
    cb = ctx_to_cols(ctx_b)

    rids, (ma, mb, mca, mcb) = _union_rids(A.rids, B.rids, ca.rids, cb.rids)
    pa = _remap(A.packed, ma)
    pb = _remap(B.packed, mb)
    vv_a = _dense_vv(len(rids), mca, ca.vvcol)
    vv_b = _dense_vv(len(rids), mcb, cb.vvcol)
    cloud_a = _remap(ca.cloudcol, mca)
    cloud_b = _remap(cb.cloudcol, mcb)

    # membership of each side's dots in the other store — dots are
    # globally unique 𝕀×ℕ tags, so dot identity implies key identity
    in_b = _in_sorted(_remap(B.flat_sorted(), mb), pa)
    in_a = _in_sorted(_remap(A.flat_sorted(), ma), pb)
    keep_a = in_b | missing_mask(vv_b, cloud_b, pa)
    keep_b = (~in_a) & missing_mask(vv_a, cloud_a, pb)

    vv_j = np.maximum(vv_a, vv_b)
    vv_j, cloud_j = _normalize_cols(vv_j,
                                    np.concatenate([cloud_a, cloud_b]))
    ctx = CausalContextCols(rids, vv_j, cloud_j)

    if isinstance(A, DotSetCols):
        merged, _, _ = _merge_disjoint(pa[keep_a], pb[keep_b])
        return DotSetCols(rids, merged), ctx

    if isinstance(A, DotFunCols):
        ka, kb = pa[keep_a], pb[keep_b]
        merged, pos_a, pos_b = _merge_disjoint(ka, kb)
        vals = np.empty(merged.size, object)
        vals[pos_a] = A.vals[keep_a]
        vals[pos_b] = B.vals[keep_b]
        return DotFunCols(rids, merged, vals), ctx

    # DotMap: align key tables, order survivors by (key, dot), rebuild
    # group offsets; keys whose group empties disappear (observed-remove)
    ku, pos_ak, pos_bk = _union_keys(A, B)
    key_a = np.repeat(pos_ak, np.diff(A.offsets))
    key_b = np.repeat(pos_bk, np.diff(B.offsets))
    kd = np.concatenate([pa[keep_a], pb[keep_b]])
    kk = np.concatenate([key_a[keep_a], key_b[keep_b]])
    kv = np.concatenate([A.vals[keep_a], B.vals[keep_b]])
    order = np.lexsort((kd, kk))
    kd, kv = kd[order], kv[order]
    counts = np.bincount(kk, minlength=len(ku))

    sh = np.full(len(ku), 255, np.uint8)
    sh[pos_ak] = np.frombuffer(A.shapes, np.uint8)
    shb = np.frombuffer(B.shapes, np.uint8)
    clash = (sh[pos_bk] != 255) & (sh[pos_bk] != shb)
    if clash.any():
        k = ku[int(pos_bk[int(np.flatnonzero(clash)[0])])]
        raise TypeError(f"mismatched dot-store shapes under map key {k!r}")
    sh[pos_bk] = shb

    present = counts > 0
    offsets = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(counts[present])])
    keys_out = (ku if present.all()
                else tuple(compress(ku, present.tolist())))
    return DotMapCols(rids, keys_out, sh[present].tobytes(),
                      offsets, kd, kv), ctx


# ---------------------------------------------------------------------------
# Per-dot digests (the causal section of StoreDigest)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CausalDigest:
    """One causal key's digest entry: the requester's compressed context
    (vv + cloud) **plus its flat store dot column** — the per-dot part.
    The context alone lets the responder compute the missing dots
    (``s_ship``); the store column is what makes the *removal* half of
    the response exact (``c_ship``'s first term) instead of shipping the
    responder's whole context. Columns are in the packed int64 encoding
    against ``rids``; the dot column is sorted."""

    rids: Tuple[str, ...]
    vvcol: np.ndarray
    cloudcol: np.ndarray
    dotcol: np.ndarray

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, CausalDigest):
            return NotImplemented
        if self.rids == other.rids:
            return (np.array_equal(self.vvcol, other.vvcol)
                    and np.array_equal(self.cloudcol, other.cloudcol)
                    and np.array_equal(self.dotcol, other.dotcol))
        return (dict(zip(self.rids, map(int, self.vvcol)))
                == dict(zip(other.rids, map(int, other.vvcol)))
                and _unpack(self.rids, self.cloudcol)
                == _unpack(other.rids, other.cloudcol)
                and _unpack(self.rids, self.dotcol)
                == _unpack(other.rids, other.dotcol))

    def __repr__(self) -> str:
        return (f"CausalDigest({len(self.rids)} rids, "
                f"{self.cloudcol.size} cloud, {self.dotcol.size} dots)")


def causal_digest_of(value) -> Optional[CausalDigest]:
    """The :class:`CausalDigest` of a causal CRDT value (any
    representation); None if the store shape is not columnar."""
    cv = value_to_cols(value)
    if cv is None:
        return None
    S, C = cv.store, cv.ctx
    rids, (ms, mc) = _union_rids(S.rids, C.rids)
    return CausalDigest(rids, _dense_vv(len(rids), mc, C.vvcol),
                        _remap(C.cloudcol, mc),
                        _remap(S.flat_sorted(), ms))


def _filter_store(S, ms, rids, mask):
    """The sub-store of ``S`` (remapped onto ``rids``) at a keep mask."""
    p = _remap(S.packed, ms)
    if isinstance(S, DotSetCols):
        return DotSetCols(rids, p[mask])
    if isinstance(S, DotFunCols):
        return DotFunCols(rids, p[mask], S.vals[mask])
    counts = _group_counts(mask, S.offsets)
    present = counts > 0
    offsets = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(counts[present])])
    keys = tuple(compress(S.map_keys, present.tolist()))
    shapes = np.frombuffer(S.shapes, np.uint8)[present].tobytes()
    return DotMapCols(rids, keys, shapes, offsets, p[mask], S.vals[mask])


def causal_diff_cols(value, g: CausalDigest):
    """The provably-minimal digest response for one causal key: the
    value ``(s_ship, c_ship)`` with

        s_ship = {d ∈ s_resp | d ∉ c_req}          (with its values)
        c_ship = {d ∈ digest.dots | d ∈ c_resp, d ∉ s_resp}
                 ∪ (c_resp \\ c_req)

    Joining it at the requester equals joining the responder's full
    state (DESIGN.md §9 gives the three-term argument), and by
    construction ``s_ship`` never contains a dot the requester's context
    already holds. Returns None when the requester lacks nothing — the
    caller elides the key so converged meshes trade only digests."""
    cv = value_to_cols(value)
    if cv is None:
        raise TypeError("causal_diff_cols: store shape is not columnar")
    S, C = cv.store, cv.ctx
    rids, (ms, mc, mg) = _union_rids(S.rids, C.rids, g.rids)
    vv_c = _dense_vv(len(rids), mc, C.vvcol)
    cloud_c = _remap(C.cloudcol, mc)
    vv_g = _dense_vv(len(rids), mg, g.vvcol)
    cloud_g = _remap(g.cloudcol, mg)
    gdots = _remap(g.dotcol, mg)
    flat_s = _remap(S.flat_sorted(), ms)

    # dots we hold that the requester's context lacks (ship with values)
    miss = missing_mask(vv_g, cloud_g, _remap(S.packed, ms))
    # digest dots we have observed but no longer hold (observed-removes)
    seen = ~missing_mask(vv_c, cloud_c, gdots)
    removed = gdots[seen & ~_in_sorted(flat_s, gdots)]
    # context the requester lacks: per-rid prefix ranges + cloud extras
    extras = [removed]
    for j in range(len(rids)):
        lo, hi = int(vv_g[j]), int(vv_c[j])
        if hi > lo:
            rng = ((np.int64(j) << SEQ_BITS)
                   | np.arange(lo + 1, hi + 1, dtype=np.int64))
            extras.append(rng[~_in_sorted(cloud_g, rng)])
    extras.append(cloud_c[missing_mask(vv_g, cloud_g, cloud_c)])
    cship = np.concatenate(extras)
    if not miss.any() and cship.size == 0:
        return None
    vvn, cloudn = _normalize_cols(np.zeros(len(rids), np.int64), cship)
    return type(value)(_filter_store(S, ms, rids, miss),
                       CausalContextCols(rids, vvn, cloudn))
