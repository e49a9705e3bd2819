"""Join-semilattice over torch tensors — the δ-CRDT ⇄ training-state bridge.

``TensorState`` is a *versioned chunk store*: every tensor is split into
fixed-size chunks, each tagged with a totally-ordered version
``(lamport_counter, writer_rank)`` packed into one int32. The join keeps,
per chunk, the value with the larger version (pointwise LWW) — a
join-semilattice because versions are unique per write and the order is
total. A *delta* is a TensorState containing only touched tensors, and
the wire format additionally drops untouched chunks.

Dense chunk tensors (:class:`ChunkedTensor`) hold torch tensors on any
device; their join is the ``delta_join`` kernel on the card and its plain
version on the CPU. Wire-decoded deltas (:class:`SparseChunks`) hold host
numpy rows, joined into dense state in O(shipped rows).

The additive dot store (``DotSumStore``) and its §7.2-compressed form
(``IntervalSum``) hold pytrees of torch tensors: the pseudo-gradient
contributions of cross-pod training (``sync.localsgd``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import tree as tu
from ..dtypes import common_device, to_numpy, to_torch

# version = (lamport << RANK_BITS) | writer_rank, in an int32 column (the
# JAX package's canonical version dtype without x64), so version columns
# and wire bodies compare byte for byte with it. RANK_BITS leaves lamport
# ≥ 2^21 headroom.
RANK_BITS = 10
VERSION_DTYPE = torch.int32


def make_version(lamport: int, rank: int) -> int:
    if not 0 <= rank < (1 << RANK_BITS):
        raise ValueError(f"writer rank {rank} outside [0, {1 << RANK_BITS})")
    return (int(lamport) << RANK_BITS) | int(rank)


def version_lamport(v: int) -> int:
    return int(v) >> RANK_BITS


def _host_vers(ct) -> np.ndarray:
    """A dense chunk tensor's version column on the host."""
    return to_numpy(ct.versions)


# ---------------------------------------------------------------------------
# Versioned chunk store
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ChunkedTensor:
    """One tensor as [n_chunks, chunk_size] values + [n_chunks] int32
    versions (torch tensors on one device). Version 0 == ⊥ for that chunk
    (values must be zeros there)."""

    values: torch.Tensor    # [n_chunks, chunk_size]
    versions: torch.Tensor  # [n_chunks] int32

    is_sparse = False

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.values.shape)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, SparseChunks):
            return _pair_eq(self, other)
        if not isinstance(other, ChunkedTensor):
            return NotImplemented
        if self.values.shape != other.values.shape:
            return False
        dev = common_device(self.values, other.values)
        return (bool(torch.equal(self.versions.to(dev),
                                 other.versions.to(dev)))
                and bool(torch.equal(self.values.to(dev),
                                     other.values.to(dev))))

    def __hash__(self):  # pragma: no cover
        raise TypeError("unhashable")


@dataclass(frozen=True, eq=False)
class SparseChunks:
    """Sparse chunk-row set: the wire-decoded form of a tensor delta.

    Holds only the shipped rows of a logically [n_chunks, chunk] versioned
    tensor — ``idx`` are the chunk positions (sorted, unique), ``vals`` /
    ``vers`` the corresponding rows, all host numpy (bf16 rows as ``V2``);
    every unlisted chunk is ⊥. Joining a sparse delta into a dense tensor
    gathers, merges and scatters the listed rows only.
    """

    n_chunks: int
    idx: np.ndarray    # [rows] chunk positions, sorted strictly increasing
    vals: np.ndarray   # [rows, chunk]
    vers: np.ndarray   # [rows]

    is_sparse = True

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_chunks, int(self.vals.shape[1]))

    def to_dense(self) -> ChunkedTensor:
        """Materialize the full [n_chunks, chunk] tensor on the host (⊥
        elsewhere), cached — the fallback for dense-only consumers
        (digest ranking, resident adoption); the join/leq/eq hot paths
        never call this."""
        cached = self.__dict__.get("_dense_cache")
        if cached is None:
            vals = np.zeros((self.n_chunks, self.vals.shape[1]),
                            dtype=self.vals.dtype)
            vers = np.zeros((self.n_chunks,),
                            dtype=np.asarray(self.vers).dtype)
            if self.idx.size:
                vals[self.idx] = self.vals
                vers[self.idx] = self.vers
            cached = ChunkedTensor(to_torch(vals), to_torch(vers))
            object.__setattr__(self, "_dense_cache", cached)
        return cached

    @property
    def values(self):
        """Dense [n_chunks, chunk] view (lazily materialized)."""
        return self.to_dense().values

    @property
    def versions(self):
        return self.to_dense().versions

    def __eq__(self, other: object) -> bool:
        if isinstance(other, (ChunkedTensor, SparseChunks)):
            return _pair_eq(self, other)
        return NotImplemented

    def __hash__(self):  # pragma: no cover
        raise TypeError("unhashable")


def sparse_chunks(n_chunks: int, idx, vals, vers) -> SparseChunks:
    """Construct a :class:`SparseChunks`, normalizing to sorted-unique
    row order. Duplicate chunk positions keep the highest-versioned row —
    LWW, the same rule the join applies."""
    idx = np.asarray(idx)
    vals = to_numpy(vals)
    vers = to_numpy(vers)
    if idx.size and not bool(np.all(idx[1:] > idx[:-1])):
        order = np.lexsort((vers, idx))     # by position, version asc
        idx, vals, vers = idx[order], vals[order], vers[order]
        last = np.r_[idx[1:] != idx[:-1], True]
        if not bool(last.all()):
            idx, vals, vers = idx[last], vals[last], vers[last]
    return SparseChunks(int(n_chunks), idx, vals, vers)


def _max_version(ct) -> int:
    """Largest version held by a dense or sparse chunk tensor (0 == ⊥)."""
    if ct.is_sparse:
        return int(np.max(np.asarray(ct.vers))) if ct.idx.size else 0
    return int(ct.versions.max()) if ct.versions.shape[0] else 0


def _join_dense_sparse(dense: ChunkedTensor,
                       sp: SparseChunks) -> ChunkedTensor:
    """Join a sparse delta into a dense tensor on the dense side's
    device: gather the rows at the shipped positions, keep the
    higher-versioned side, scatter the winners into a copy."""
    if sp.idx.size == 0:
        return dense
    dev = dense.values.device
    idx = torch.as_tensor(sp.idx, dtype=torch.long, device=dev)
    spv = to_torch(sp.vers, dev)
    take = spv > dense.versions[idx]
    if not bool(take.any()):
        return dense
    rows = idx[take]
    out_v = dense.values.clone()
    out_r = dense.versions.clone()
    out_v[rows] = to_torch(sp.vals, dev)[take]
    out_r[rows] = spv[take]
    return ChunkedTensor(out_v, out_r)


def _join_sparse_sparse(a: SparseChunks, b: SparseChunks) -> SparseChunks:
    """Union of two sparse row sets; overlapping positions keep the higher
    version (ties carry identical values by unique-write construction)."""
    if a.idx.size == 0:
        return b
    if b.idx.size == 0:
        return a
    idx = np.concatenate([np.asarray(a.idx), np.asarray(b.idx)])
    vers = np.concatenate([np.asarray(a.vers), np.asarray(b.vers)])
    vals = np.concatenate([np.asarray(a.vals), np.asarray(b.vals)], axis=0)
    order = np.lexsort((vers, idx))          # by position, version ascending
    idx, vers, vals = idx[order], vers[order], vals[order]
    last = np.r_[idx[1:] != idx[:-1], True]  # max-version row per position
    return SparseChunks(a.n_chunks, idx[last], vals[last], vers[last])


def _join_chunked(av, avers, bv, bvers):
    """Pointwise LWW merge of two dense tensors: the ``delta_join``
    kernel (its plain version on the CPU)."""
    from ..kernels import ops
    return ops.delta_join(av, avers, bv, bvers)


def _pair_join(a, b):
    """Join two chunk tensors of any density mix."""
    if not a.is_sparse and not b.is_sparse:
        v, vers = _join_chunked(a.values, a.versions, b.values, b.versions)
        return ChunkedTensor(v, vers)
    if a.is_sparse and b.is_sparse:
        return _join_sparse_sparse(a, b)
    return (_join_dense_sparse(b, a) if a.is_sparse
            else _join_dense_sparse(a, b))


def _pair_leq(a, b) -> bool:
    """Pointwise version order over any density mix (O(sparse rows))."""
    if not a.is_sparse and not b.is_sparse:
        dev = common_device(a.versions, b.versions)
        return not bool((a.versions.to(dev) > b.versions.to(dev)).any())
    if a.is_sparse and not b.is_sparse:
        if a.idx.size == 0:
            return True
        return not bool(np.any(np.asarray(a.vers) > _host_vers(b)[a.idx]))
    if not a.is_sparse and b.is_sparse:
        av = _host_vers(a)
        live_outside = av > 0
        if b.idx.size:
            live_outside = np.array(live_outside, copy=True)
            live_outside[b.idx] = False
            if bool(np.any(av[b.idx] > np.asarray(b.vers))):
                return False
        return not bool(live_outside.any())
    # sparse ≤ sparse: every live row of a must be covered by b
    live = np.asarray(a.vers) > 0
    ai, avr = a.idx[live], np.asarray(a.vers)[live]
    if ai.size == 0:
        return True
    if b.idx.size == 0:
        return False
    pos = np.searchsorted(np.asarray(b.idx), ai)
    pos_c = np.minimum(pos, b.idx.size - 1)
    found = (pos < b.idx.size) & (np.asarray(b.idx)[pos_c] == ai)
    if not bool(found.all()):
        return False
    return not bool(np.any(avr > np.asarray(b.vers)[pos_c]))


def _sp_live(sp: SparseChunks):
    live = np.asarray(sp.vers) > 0
    return sp.idx[live], np.asarray(sp.vals)[live], np.asarray(sp.vers)[live]


def versions_at(known: np.ndarray, idx: np.ndarray,
                vers_dtype) -> np.ndarray:
    """The digest owner's version at each chunk position in ``idx`` —
    positions beyond the digest column (the requester's tensor is
    shorter) read as ⊥, so those rows always ship."""
    known = np.asarray(known)
    at = np.zeros(idx.shape, dtype=vers_dtype)
    in_range = idx < known.size
    at[in_range] = known[idx[in_range]].astype(vers_dtype)
    return at


def live_rows(ct, known: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(chunk positions, values rows, versions) of a chunk tensor's live
    chunks, sorted by position, as host numpy — directly from sparse row
    sets, by mask for dense. With ``known`` (a digest's version column)
    only rows newer than it are kept, and the versions are filtered
    before any values leave the device. The shared row extractor behind
    the wire codec, the digest diff and the resident host scatter plan."""
    if ct.is_sparse:
        idx, vals, vers = _sp_live(ct)
        idx = np.asarray(idx, dtype=np.int32)
        if known is not None and idx.size:
            keep = vers > versions_at(known, idx, vers.dtype)
            idx, vals, vers = idx[keep], vals[keep], vers[keep]
        return idx, vals, vers
    vers = _host_vers(ct)
    mask = vers > 0
    if known is not None:
        mask &= vers > versions_at(known, np.arange(vers.size), vers.dtype)
    idx = np.nonzero(mask)[0].astype(np.int32)
    if idx.size == vers.size:
        return idx, to_numpy(ct.values), vers
    rows = torch.as_tensor(idx, dtype=torch.long, device=ct.values.device)
    return idx, to_numpy(ct.values[rows]), vers[idx]


def dense_versions(ct) -> np.ndarray:
    """The full [n_chunks] version column of a dense or sparse chunk
    tensor on the host (version 0 == ⊥ at unlisted sparse positions) —
    what a digest summary carries per (key, tensor)."""
    if ct.is_sparse:
        vers = np.zeros(ct.n_chunks, dtype=np.asarray(ct.vers).dtype)
        if ct.idx.size:
            vers[ct.idx] = ct.vers
        return vers
    return _host_vers(ct)


def _pair_eq(a, b) -> bool:
    """Value equality over any density mix. Relies on the ⊥ invariant
    (version 0 ⇒ zero values), which every constructor maintains."""
    if a.shape != b.shape:
        return False
    if not a.is_sparse and not b.is_sparse:
        return a == b
    if a.is_sparse and b.is_sparse:
        ai, av, ar = _sp_live(a)
        bi, bv, br = _sp_live(b)
        return (np.array_equal(ai, bi) and np.array_equal(ar, br)
                and np.array_equal(av, bv))
    dense, sp = (b, a) if a.is_sparse else (a, b)
    dr = _host_vers(dense)
    si, sv, sr = _sp_live(sp)
    dense_vers = np.zeros_like(dr)
    dense_vers[si] = sr
    if not np.array_equal(dr, dense_vers):
        return False
    if si.size:
        rows = torch.as_tensor(si, dtype=torch.long,
                               device=dense.values.device)
        if not np.array_equal(to_numpy(dense.values[rows]), sv):
            return False
    # unlisted rows are ⊥ on both sides (invariant: version 0 ⇒ zeros)
    return True


def chunk_tensor(x, chunk_size: int, version: int = 0,
                 device=None) -> ChunkedTensor:
    """Split ``x`` (numpy or torch) into [n_chunks, chunk_size] rows,
    zero-padding the tail. float64 is stored as float32 and int64 as
    int32, the canonical dtypes of the JAX package without x64."""
    t = to_torch(x if isinstance(x, torch.Tensor) else np.asarray(x))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    flat = t.reshape(-1)
    pad = (-flat.numel()) % chunk_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    vals = flat.reshape(-1, chunk_size)
    if device is not None:
        vals = vals.to(device)
    vals = vals.contiguous()
    vers = torch.full((vals.shape[0],), version, dtype=VERSION_DTYPE,
                      device=vals.device)
    return ChunkedTensor(vals, vers)


def unchunk(ct: ChunkedTensor, shape: Tuple[int, ...],
            dtype=None) -> torch.Tensor:
    """The first ``prod(shape)`` elements of ``ct``'s rows as a tensor of
    ``shape`` (a view of the values when no cast is asked for)."""
    n = int(np.prod(shape))
    out = ct.values.reshape(-1)[:n].reshape(shape)
    return out.to(dtype) if dtype is not None else out


@dataclass(frozen=True, eq=False)
class TensorState:
    """The replicated-state lattice: name → ChunkedTensor (+ lamport clock).

    ``lamport`` is replica-local bookkeeping used to mint fresh versions;
    it rides along monotonically (max on join) and does not affect
    equality of the CRDT payload.
    """

    chunks: Tuple[Tuple[str, Any], ...] = ()
    lamport: int = 0

    @staticmethod
    def bottom() -> "TensorState":
        return TensorState()

    @staticmethod
    def of(mapping: Mapping[str, Any], lamport: int = 0) -> "TensorState":
        return TensorState(tuple(sorted(mapping.items())), lamport)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.chunks)

    # -- lattice ----------------------------------------------------------------
    def join(self, other: "TensorState") -> "TensorState":
        a, b = self.as_dict(), other.as_dict()
        out: Dict[str, Any] = {}
        for k in set(a) | set(b):
            if k not in a:
                out[k] = b[k]
            elif k not in b:
                out[k] = a[k]
            else:
                out[k] = _pair_join(a[k], b[k])
        return TensorState.of(out, max(self.lamport, other.lamport))

    def leq(self, other: "TensorState") -> bool:
        a, b = self.as_dict(), other.as_dict()
        for k, ct in a.items():
            if k not in b:
                if _max_version(ct) > 0:
                    return False
                continue
            if not _pair_leq(ct, b[k]):
                return False
            # equal versions ⇒ equal values by construction (unique writes)
        return True

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TensorState):
            return NotImplemented
        a, b = self.as_dict(), other.as_dict()
        for k in set(a) | set(b):
            if k not in a or k not in b:
                # missing key is equal to an all-⊥ tensor of the same shape
                if _max_version(a.get(k, b.get(k))) > 0:
                    return False
                continue
            if not _pair_eq(a[k], b[k]):
                return False
        return True

    def __hash__(self):  # pragma: no cover
        raise TypeError("unhashable")

    # -- delta-mutator -----------------------------------------------------------
    def write_delta(self, rank: int, name: str, new_values: Any,
                    chunk_idx: Optional[np.ndarray] = None,
                    chunk_size: Optional[int] = None) -> "TensorState":
        """δ-mutator: (re)write tensor ``name`` (or a subset of its chunks).

        Returns a delta containing ONLY the touched tensor, with touched
        chunks carrying a fresh version and untouched chunks at ⊥
        (version 0, zero values) — ``X ⊔ delta`` applies the write. The
        delta lives where ``new_values`` lives when that is a tensor, else
        on the device of the tensor it rewrites.
        """
        lam = self.lamport + 1
        ver = make_version(lam, rank)
        cur = self.as_dict().get(name)
        if cur is None:
            if chunk_idx is not None:
                raise ValueError("cannot partially write unknown tensor "
                                 f"{name!r}")
            if chunk_size is None:
                raise ValueError("a new tensor needs a chunk_size")
            ct = chunk_tensor(new_values, chunk_size)
            delta_ct = ChunkedTensor(ct.values, torch.full_like(ct.versions,
                                                                ver))
        else:
            if cur.is_sparse:   # writes need the dense addressing space
                cur = cur.to_dense()
            n_chunks, csz = cur.values.shape
            dev = (new_values.device if isinstance(new_values, torch.Tensor)
                   else cur.values.device)
            if chunk_idx is None:
                ct = chunk_tensor(new_values, csz, device=dev)
                if ct.values.shape != cur.values.shape:
                    raise ValueError(f"{name!r}: shape {ct.values.shape} != "
                                     f"{cur.values.shape}")
                delta_ct = ChunkedTensor(ct.values, torch.full(
                    (n_chunks,), ver, dtype=VERSION_DTYPE, device=dev))
            else:
                idx = torch.as_tensor(np.asarray(chunk_idx),
                                      dtype=torch.long, device=dev)
                new_vals = to_torch(new_values, dev).reshape(
                    len(chunk_idx), csz)
                vals = torch.zeros(cur.values.shape, dtype=cur.values.dtype,
                                   device=dev)
                vals[idx] = new_vals.to(vals.dtype)
                vers = torch.zeros((n_chunks,), dtype=VERSION_DTYPE,
                                   device=dev)
                vers[idx] = ver
                delta_ct = ChunkedTensor(vals, vers)
        return TensorState.of({name: delta_ct}, lamport=lam)

    def write_full(self, rank: int, name: str, new_values: Any,
                   chunk_idx: Optional[np.ndarray] = None,
                   chunk_size: Optional[int] = None) -> "TensorState":
        return self.join(self.write_delta(rank, name, new_values, chunk_idx,
                                          chunk_size))

    def decompose(self) -> list:
        """Per-tensor atoms (coarse join-decomposition) — lets the
        RemoveRedundant shipping policy drop tensors the receiver provably
        holds."""
        return [TensorState.of({name: ct}, lamport=self.lamport)
                for name, ct in self.chunks]


# -- digest-driven chunk selection --------------------------------------------

def chunk_digest_cached(ct) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk (max|x|, Σx²) of a chunk tensor as host numpy, memoized
    on the (immutable) tensor object: joins reuse untouched keys' ``ct``
    objects, so across rounds only changed tensors recompute. One
    ``chunk_digest`` launch per tensor."""
    from ..kernels import ops

    if ct.is_sparse:            # the digest ranks dense chunk positions
        ct = ct.to_dense()
    cached = ct.__dict__.get("_digest_cache")
    if cached is None:
        ma, ss = ops.chunk_digest(ct.values)
        cached = (to_numpy(ma), to_numpy(ss))
        object.__setattr__(ct, "_digest_cache", cached)
    return cached


def chunk_payload_bytes(dtype: torch.dtype, chunk: int) -> int:
    """Wire bytes one live chunk row costs: its values, an int64 index
    and an int32 version — what the digest budget counts."""
    return dtype.itemsize * chunk + 8 + 4


def digest_keep_plan(tensors, budget_bytes: int):
    """The energy-ranked greedy selection behind ``digest_select`` and
    ``store.digest_select_store``.

    ``tensors`` is an iterable of ``(scope, name, chunk tensor)`` (scope
    is the store key, or None for a single object). Live chunks are
    ranked globally by Σx² (energy, from :func:`chunk_digest_cached`) and
    taken greedily until ``budget_bytes`` of chunk payload is spent;
    ties go to the lower (scope, name, chunk). Returns None when
    everything fits, else ``{(scope, name): [kept chunk indices]}``.
    """
    candidates = []   # (neg_energy, scope, name, chunk_idx, chunk_bytes)
    for scope, name, ct in tensors:
        if ct.is_sparse:
            ct = ct.to_dense()
        live = _host_vers(ct) > 0
        if not live.any():
            continue
        _, sumsq = chunk_digest_cached(ct)
        per_chunk = chunk_payload_bytes(ct.values.dtype, ct.values.shape[1])
        for i in np.nonzero(live)[0]:
            candidates.append((-float(sumsq[i]), scope, name, int(i),
                               per_chunk))

    if sum(c[4] for c in candidates) <= budget_bytes:
        return None

    keep: Dict[Tuple[Any, str], list] = {}
    spent = 0
    for _neg_e, scope, name, i, nbytes in sorted(candidates):
        if spent + nbytes > budget_bytes:
            continue
        spent += nbytes
        keep.setdefault((scope, name), []).append(i)
    return keep


def mask_kept_chunks(ct, idx) -> ChunkedTensor:
    """Drop every chunk not in ``idx`` to ⊥ (version 0, zero values), so
    the result is ≤ the input in the lattice order and always safe to
    join."""
    if ct.is_sparse:
        ct = ct.to_dense()
    dev = ct.values.device
    mask = torch.zeros((ct.values.shape[0],), dtype=torch.bool, device=dev)
    mask[torch.as_tensor(np.asarray(idx), dtype=torch.long,
                         device=dev)] = True
    vals = torch.where(mask[:, None], ct.values,
                       torch.zeros_like(ct.values))
    vers = torch.where(mask, ct.versions, torch.zeros_like(ct.versions))
    return ChunkedTensor(vals, vers)


def digest_select(state: TensorState, budget_bytes: int) -> TensorState:
    """Keep only the top-magnitude chunks of ``state`` under a byte budget
    (see :func:`digest_keep_plan`) — the ``DigestBudget`` shipping
    policy's payload transform for single objects. If everything fits the
    input is returned unchanged."""
    tensors = state.as_dict()
    keep = digest_keep_plan(((None, name, ct) for name, ct in
                             tensors.items()), budget_bytes)
    if keep is None:
        return state
    out = {name: mask_kept_chunks(ct, keep[(None, name)])
           for name, ct in tensors.items() if keep.get((None, name))}
    return TensorState.of(out, lamport=state.lamport)


# -- wire format --------------------------------------------------------------

def pack_delta(delta: TensorState,
               known_versions: Optional[Mapping[str, np.ndarray]] = None
               ) -> Dict[str, Any]:
    """Sparse host encoding: per tensor, only chunks with version above ⊥
    (and above the receiver's known version when supplied). This is the
    §4.1 ``size(mᵟ(X)) ≪ size(X)`` payload."""
    out: Dict[str, Any] = {"lamport": delta.lamport, "tensors": {}}
    for name, ct in delta.chunks:
        idx, vals, vers = live_rows(ct)
        if known_versions and name in known_versions:
            keep = vers > np.asarray(known_versions[name])[idx]
            idx, vals, vers = idx[keep], vals[keep], vers[keep]
        if len(idx) == 0:
            continue
        out["tensors"][name] = (idx, vals, vers, ct.shape)
    return out


def unpack_delta(wire: Dict[str, Any], *, sparse: bool = True) -> TensorState:
    """Decode a :func:`pack_delta` message: as :class:`SparseChunks` row
    sets (default), or as full-size host tensors with ⊥ rows."""
    chunks: Dict[str, Any] = {}
    for name, (idx, vals, vers, shape) in wire["tensors"].items():
        if sparse:
            chunks[name] = sparse_chunks(shape[0], idx, vals, vers)
        else:
            chunks[name] = sparse_chunks(shape[0], idx, vals,
                                         vers).to_dense()
    return TensorState.of(chunks, lamport=wire["lamport"])


def packed_size_bytes(wire: Dict[str, Any]) -> int:
    """Bytes of a :func:`pack_delta` message: an 8-byte header, then per
    tensor its name and its index, value and version arrays."""
    total = 8
    for name, (idx, vals, vers, _shape) in wire["tensors"].items():
        total += len(name) + idx.nbytes + vals.nbytes + vers.nbytes
    return total


# ---------------------------------------------------------------------------
# Additive dot-store (pseudo-gradient aggregation) + §7.2-style compression
# ---------------------------------------------------------------------------

def _leaf_equal(x, y) -> bool:
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        dev = common_device(x, y)
        return bool(torch.equal(x.to(dev), y.to(dev)))
    return bool(np.array_equal(to_numpy(x), to_numpy(y)))


def _tree_equal(a, b) -> bool:
    la, ta = tu.flatten(a)
    lb, tb = tu.flatten(b)
    if ta != tb or len(la) != len(lb):
        return False
    return all(_leaf_equal(x, y) for x, y in zip(la, lb))


@dataclass(frozen=True, eq=False)
class DotSumStore:
    """Grow-only map (producer, seq) → update pytree; join = union.

    The lattice of cross-pod additive updates. ``total()`` — the quantity
    the optimizer consumes — is the sum over all dots; because the store
    is a *set* of uniquely-tagged contributions, duplicated or reordered
    delivery cannot double-count (the paper's counter argument, §4.2).
    """

    dots: Tuple[Tuple[Tuple[str, int], Any], ...] = ()

    @staticmethod
    def bottom() -> "DotSumStore":
        return DotSumStore()

    def as_dict(self) -> Dict[Tuple[str, int], Any]:
        return dict(self.dots)

    def contribute_delta(self, producer: str, update: Any) -> "DotSumStore":
        """δ-mutator: a fresh uniquely-dotted contribution."""
        seq = 1 + max((s for (p, s), _ in self.dots if p == producer),
                      default=0)
        return DotSumStore((((producer, seq), update),))

    def contribute_full(self, producer: str, update: Any) -> "DotSumStore":
        return self.join(self.contribute_delta(producer, update))

    def join(self, other: "DotSumStore") -> "DotSumStore":
        merged = self.as_dict()
        for dot, upd in other.dots:
            if dot in merged:
                continue  # unique dots ⇒ identical payload
            merged[dot] = upd
        return DotSumStore(tuple(sorted(merged.items(),
                                        key=lambda kv: kv[0])))

    def decompose(self) -> list:
        """One atom per dot — RemoveRedundant trims re-gossiped dots the
        receiver has already acked."""
        return [DotSumStore((entry,)) for entry in self.dots]

    def leq(self, other: "DotSumStore") -> bool:
        od = other.as_dict()
        return all(dot in od for dot, _ in self.dots)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DotSumStore):
            return NotImplemented
        a, b = self.as_dict(), other.as_dict()
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)

    def __hash__(self):  # pragma: no cover
        raise TypeError("unhashable")

    def total(self) -> Any:
        if not self.dots:
            return None
        acc = tu.tree_map(torch.as_tensor, self.dots[0][1])
        for _, upd in self.dots[1:]:
            acc = tu.tree_map(lambda a, b: a + torch.as_tensor(b), acc, upd)
        return acc

    def version_vector(self) -> Dict[str, int]:
        vv: Dict[str, int] = {}
        for (p, s), _ in self.dots:
            vv[p] = max(vv.get(p, 0), s)
        return vv


class IntervalSum:
    """§7.2-compressed DotSumStore: (per-producer contiguous prefix, sum).

    NOT a free-standing semilattice — the sum cannot deduplicate arbitrary
    overlaps — but under Algorithm-2 delivery (delta-intervals aligned with
    the receiver's acked prefix: the causal delta-merging condition) it is
    an exact, O(1)-memory encoding of the dot store. ``apply_interval``
    enforces the condition and is idempotent for re-delivered intervals.
    """

    def __init__(self):
        self.prefix: Dict[str, int] = {}
        self.sum: Any = None

    def apply_interval(self, producer: str, start_seq: int,
                       updates: Iterable[Any]) -> bool:
        """Apply contributions ``start_seq .. start_seq+len-1`` from
        ``producer``. Returns True if applied; False if rejected (gap —
        the merging condition X ⊒ Xʲᵃ does not hold) or fully stale."""
        updates = list(updates)
        have = self.prefix.get(producer, 0)
        if start_seq - 1 > have:
            return False                      # gap: would skip dots
        end = start_seq + len(updates) - 1
        if end <= have:
            return True                       # duplicate: already absorbed
        fresh = updates[have - (start_seq - 1):]  # drop already-applied prefix
        for upd in fresh:
            if self.sum is None:
                self.sum = tu.tree_map(
                    lambda x: torch.as_tensor(x).clone(), upd)
            else:
                self.sum = tu.tree_map(
                    lambda a, b: a + torch.as_tensor(b), self.sum, upd)
        self.prefix[producer] = end
        return True

    def matches(self, ref: DotSumStore, atol: float = 1e-6) -> bool:
        """Exactness check against the reference dot store."""
        if ref.version_vector() != {p: n for p, n in self.prefix.items()
                                    if n > 0}:
            return False
        t = ref.total()
        if t is None or self.sum is None:
            return t is None and self.sum is None
        la = tu.leaves(t)
        lb = tu.leaves(self.sum)
        return all(np.allclose(to_numpy(a), to_numpy(b), atol=atol)
                   for a, b in zip(la, lb))
