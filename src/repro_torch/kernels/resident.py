"""Device-resident store columns: the accelerator-side half of the store.

A steady-state anti-entropy round should never move the store: this
module keeps a store's stacked columns as **persistent device tensors**.

* :class:`ResidentColumns` owns one signature group's stacked
  ``[rows, chunk]`` values + ``[rows]`` versions on the device, **plus**
  the per-chunk digest columns (max|x|, Σx²) the selection policy ranks
  by, kept fresh by the kernels themselves, and a host mirror of the
  version column so digest *summaries* (``core.digest.store_digest``)
  are served with zero device traffic.
* :func:`adopt` builds the cache once from a stackable store (one upload
  + one ``chunk_digest`` launch) and attaches it to the (immutable) store
  object; :func:`ensure` is the idempotent entry the replica engine calls
  each round.
* :func:`try_join` is the join fast path ``core.store`` consults first:
  a sparse wire delta becomes ONE ``scatter_join`` launch over the
  shipped rows (digest rows refreshed in the same pass); two resident
  stores with identical layout become ONE ``fused_join_digest`` launch.
  The result store carries the new cache, so rounds chain without
  rebuilding columns.
* :func:`keep_plan` turns the maintained Σx² column into the
  ``DigestBudget`` energy selection with one sort epilogue.

Ownership and invalidation: a cache belongs to exactly one immutable
``LatticeStore`` value and is never mutated — joins produce fresh columns
for the result store (``scatter_join`` copies, then writes the shipped
rows), so old snapshots, and the tensor views old stores hold, stay
valid. Anything that changes the column *layout* — a new key, a new
tensor, a chunk-count change, a reap/revive epoch bump — fails the
fast-path checks: the join falls back to the host paths and the next
:func:`ensure` re-adopts. :func:`spill` materializes the columns back to
a host ``_StackedChunks`` (counted device→host).

Every entry that places tensors takes ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ops
from ..dtypes import to_numpy, torch_dtype

VVIEW = "_resident_cache"      # attribute slot on LatticeStore objects


class ResidentColumns:
    """One signature group's device-resident stacked columns + digest.

    ``vals [rows, chunk]`` / ``vers [rows]`` are the chunk data,
    ``maxabs`` / ``sumsq`` ``[rows] f32`` the per-chunk digest columns
    (always fresh: every join kernel writes them alongside the merge).
    ``layout`` / ``sig`` / ``spans`` mirror the host ``_StackedChunks``
    bookkeeping; ``vers_host`` is a host numpy copy of the version column
    kept in lockstep by O(shipped rows) numpy work."""

    __slots__ = ("vals", "vers", "maxabs", "sumsq", "layout", "sig",
                 "vers_host", "spans")

    def __init__(self, vals, vers, maxabs, sumsq, layout, sig, vers_host,
                 spans=None):
        self.vals = vals
        self.vers = vers
        self.maxabs = maxabs
        self.sumsq = sumsq
        self.layout = layout
        self.sig = sig
        self.vers_host = vers_host
        self.spans = spans if spans is not None else {
            (k, n): (s, e) for k, n, s, e in layout}

    @property
    def rows(self) -> int:
        return int(self.vals.shape[0])


def resident_of(store) -> Optional[ResidentColumns]:
    return store.__dict__.get(VVIEW)


def _upload(x: torch.Tensor, device) -> torch.Tensor:
    ops.counters.count_h2d(x, device=device)
    return x.to(device)


def adopt(store, device="cuda") -> Optional[ResidentColumns]:
    """Build (or fetch) the resident cache for ``store`` on ``device``:
    one stack of the columns, one upload, one digest launch. Sparse
    tensors (wire-decoded state) densify into the columns. Returns None
    when the store is not stackable (non-tensor values, mixed
    signatures, empty)."""
    cached = resident_of(store)
    if cached is not None:
        return cached
    from ..core.store import _stack_columns, _stack_store
    sa = _stack_store(store)
    if sa is None:
        sa = _stack_columns(store, densify=True)
    if sa is None:
        return None
    vals = _upload(sa.vals, device)
    vers = _upload(sa.vers, device)
    ma, ss = ops.chunk_digest(vals)
    cache = ResidentColumns(vals, vers, ma, ss, sa.layout, sa.sig,
                            to_numpy(sa.vers).copy())
    object.__setattr__(store, VVIEW, cache)
    return cache


def ensure(store, device="cuda") -> Optional[ResidentColumns]:
    """Idempotent :func:`adopt` — what the replica engine calls once per
    anti-entropy round so layout changes re-resident lazily."""
    return adopt(store, device)


def spill(store):
    """Materialize the resident columns back into a host
    ``_StackedChunks`` (attached as the store's host cache) — the exit
    path when a store must leave the device. Counted device→host."""
    cache = resident_of(store)
    if cache is None:
        return None
    from ..core.store import _StackedChunks
    ops.counters.count_d2h(cache.vals, cache.vers)
    sc = _StackedChunks(cache.vals.cpu(), cache.vers.cpu(), cache.layout,
                        cache.sig)
    object.__setattr__(store, "_stacked_cache", sc)
    return sc


# ---------------------------------------------------------------------------
# The join fast path
# ---------------------------------------------------------------------------

def try_join(a_store, b_store, life):
    """Resident fast path for ``a_store.join(b_store)`` (caller has
    already verified epoch agreement and pre-joined ``life``). Returns
    the joined store carrying a fresh resident cache, or None when the
    delta does not map onto the resident layout."""
    ra = resident_of(a_store)
    if ra is None:
        return None
    rb = resident_of(b_store)
    if rb is not None and rb.sig == ra.sig:
        return _aligned_join(ra, rb, a_store, b_store, life)
    plan = _scatter_plan(ra, b_store)
    if plan is None:
        return None
    return _scatter_ingest(ra, a_store, b_store, life, plan)


def _aligned_join(ra: ResidentColumns, rb: ResidentColumns,
                  a_store, b_store, life):
    """Two resident stores with the identical stacked layout: the whole
    join (and the next round's digest) is ONE fused launch."""
    from ..core.store import _joined_lamports, _views_store
    ov, over, ma, ss = ops.fused_join_digest(ra.vals, ra.vers,
                                             rb.vals, rb.vers)
    result = _views_store(a_store, _joined_lamports(a_store, b_store),
                          ra.layout, ov, over, life)
    cache = ResidentColumns(ov, over, ma, ss, ra.layout, ra.sig,
                            np.maximum(ra.vers_host, rb.vers_host),
                            ra.spans)
    object.__setattr__(result, VVIEW, cache)
    return result


def _scatter_plan(ra: ResidentColumns, b_store):
    """Validate that every tensor of ``b_store`` lands inside the
    resident layout (same key/tensor/chunk-count/dtype) and assemble the
    global scatter rows: ``(idx [r] int32 numpy, d_vals, d_vers)`` where
    the rows are host numpy (counted as staging at launch) or
    already-device columns from a ``decode_store(..., to_device=True)``
    payload (zero staging). Returns None on any layout mismatch."""
    from ..core.store import _covers_layout
    from ..core.tensor_lattice import live_rows

    chunkw, vdtype, rdtype = ra.sig[2], ra.sig[3], ra.sig[4]
    if not _covers_layout(ra.spans, chunkw, frozenset(ra.sig[0]), b_store):
        return None

    dev = b_store.__dict__.get("_device_cols")
    if dev is not None:
        got = _device_plan(ra, dev, chunkw, vdtype, rdtype)
        if got is not None:
            return got

    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    ver_parts: List[np.ndarray] = []
    for key, val in b_store.entries:
        for name, ct in val.chunks:
            start, _stop = ra.spans[(key, name)]
            li, lv, lr = live_rows(ct)
            if li.size == 0:
                continue
            if torch_dtype(lv.dtype) != vdtype \
                    or torch_dtype(lr.dtype) != rdtype:
                return None
            idx_parts.append(li.astype(np.int32) + np.int32(start))
            val_parts.append(lv)
            ver_parts.append(lr)
    if not idx_parts:
        return (np.zeros((0,), np.int32), None, None)
    return (np.concatenate(idx_parts),
            np.concatenate(val_parts, axis=0),
            np.concatenate(ver_parts))


def _device_plan(ra, dev_groups, chunkw, vdtype, rdtype):
    """Scatter plan over columns a decode-to-device payload already put
    on the device: only the small int32 row-index column is built on the
    host; values/versions never re-stage. Requires the payload to be one
    signature group matching the resident signature and device."""
    if len(dev_groups) != 1:
        return None
    g = dev_groups[0]
    if (g.chunk_w != chunkw or g.vals_dev.dtype != vdtype
            or g.vers_dev.dtype != rdtype
            or g.vals_dev.device != ra.vals.device):
        return None
    idx_parts: List[np.ndarray] = []
    row = 0
    for key, name, n_chunks, rows in g.members:
        span = ra.spans.get((key, name))
        if span is None or n_chunks != span[1] - span[0]:
            return None
        idx_parts.append(g.idx_col[row:row + rows].astype(np.int32)
                         + np.int32(span[0]))
        row += rows
    idx = (np.concatenate(idx_parts) if idx_parts
           else np.zeros((0,), np.int32))
    return (idx, g.vals_dev, g.vers_dev)


def _pad_bucket(r: int) -> int:
    """Round the scatter grid up to a power-of-two bucket (min 8), so
    rounds of varying delta sizes share a few launch shapes."""
    b = 8
    while b < r:
        b <<= 1
    return b


def _pad_rows(idx: np.ndarray, d_vals, d_vers, n: int):
    """Pad the scatter rows to :func:`_pad_bucket`: pad rows target one
    row no real row touches (``idx`` is unique: the first gap in the
    sorted positions, or r itself when they are 0..r-1), with ⊥
    versions, so they re-write that row's existing content."""
    r = int(idx.shape[0])
    pad = min(_pad_bucket(r), n) - r
    if pad <= 0:
        return idx, d_vals, d_vers
    s = np.sort(idx)
    gap = np.flatnonzero(s != np.arange(r, dtype=s.dtype))
    free = int(gap[0]) if gap.size else r
    idx = np.concatenate([idx, np.full(pad, free, np.int32)])
    if isinstance(d_vals, np.ndarray):
        d_vals = np.concatenate(
            [d_vals, np.zeros((pad,) + d_vals.shape[1:], d_vals.dtype)])
        d_vers = np.concatenate([d_vers, np.zeros((pad,), d_vers.dtype)])
    else:
        d_vals = torch.cat([d_vals, d_vals.new_zeros(
            (pad,) + tuple(d_vals.shape[1:]))])
        d_vers = torch.cat([d_vers, d_vers.new_zeros((pad,))])
    return idx, d_vals, d_vers


def _scatter_ingest(ra: ResidentColumns, a_store, b_store, life, plan):
    """One ``scatter_join`` launch applies the whole delta to the
    resident columns; every tensor of the result store is a view of the
    new columns (see ``core.store._views_store``)."""
    from ..core.store import _joined_lamports, _views_store

    idx, d_vals, d_vers = plan
    r = int(idx.shape[0])
    if r:
        d_vers_host = d_vers if isinstance(d_vers, np.ndarray) else None
        if r < ra.rows:
            idx, d_vals, d_vers = _pad_rows(idx, d_vals, d_vers, ra.rows)
        ov, over, ma, ss = ops.scatter_join(ra.vals, ra.vers, ra.maxabs,
                                            ra.sumsq, idx, d_vals, d_vers)
        # host mirror of the version column: O(r) numpy, no full read
        if d_vers_host is None:
            d_vers_host = to_numpy(d_vers[:r])
            ops.counters.count_d2h(d_vers_host)
        vh = ra.vers_host.copy()
        real_idx = idx[:r]
        take = d_vers_host[:r] > vh[real_idx]
        vh[real_idx[take]] = d_vers_host[:r][take]
    else:
        ov, over, ma, ss = ra.vals, ra.vers, ra.maxabs, ra.sumsq
        vh = ra.vers_host

    result = _views_store(a_store, _joined_lamports(a_store, b_store),
                          ra.layout, ov, over, life)
    cache = ResidentColumns(ov, over, ma, ss, ra.layout, ra.sig, vh,
                            ra.spans)
    object.__setattr__(result, VVIEW, cache)
    return result


# ---------------------------------------------------------------------------
# Energy selection from the maintained digest columns
# ---------------------------------------------------------------------------

def _topk_live(sumsq: torch.Tensor, live: torch.Tensor, k: int
               ) -> torch.Tensor:
    """Indices of the ``k`` largest Σx² among live rows, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    tie order)."""
    masked = torch.where(live, sumsq, torch.full_like(sumsq, -1.0))
    return torch.sort(masked, descending=True, stable=True).indices[:k]


def keep_plan(cache: ResidentColumns, budget_bytes: int
              ) -> Optional[Dict[Tuple[str, str], list]]:
    """``tensor_lattice.digest_keep_plan`` served from the resident
    digest columns: per-chunk payload bytes are constant within a
    signature group, so the greedy energy ranking is exactly a top-k
    prefix over the maintained Σx² column. Returns None when every live
    chunk fits the budget, else ``{(key, name): [kept chunk indices]}``
    (identical contract and tie order: the lower row wins a tie, and the
    column order is (key, name, chunk) ascending, the order the host
    greedy breaks ties by)."""
    from ..core.tensor_lattice import chunk_payload_bytes

    per_chunk = chunk_payload_bytes(cache.sig[3], cache.sig[2])
    live = cache.vers_host > 0
    n_live = int(live.sum())
    if n_live * per_chunk <= budget_bytes:
        return None
    k = min(int(budget_bytes // per_chunk), cache.rows)
    keep: Dict[Tuple[str, str], list] = {}
    if k <= 0:
        return keep
    ops.record_launch("keep_plan")      # the ranking epilogue
    live_dev = torch.as_tensor(live, device=cache.sumsq.device)
    rows = to_numpy(_topk_live(cache.sumsq, live_dev, k))
    ops.counters.count_d2h(rows)
    starts = np.fromiter((s for _, _, s, _ in cache.layout), np.int64,
                         len(cache.layout))
    seg = np.searchsorted(starts, rows, side="right") - 1
    for row, si in zip(rows.tolist(), seg.tolist()):
        key, name, start, _stop = cache.layout[si]
        keep.setdefault((key, name), []).append(int(row) - start)
    return keep
