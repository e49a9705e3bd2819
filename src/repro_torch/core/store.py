"""Keyed δ-CRDT object store: a map of independent lattice objects that is
itself a join-semilattice.

The paper's anti-entropy algorithms replicate *one* object per replica; a
serving fleet replicates *millions* (one session table per request, one
tensor shard per model slice, one membership view…). ``LatticeStore`` lifts
any family of lattices to a keyed store with the **pointwise** order:

* join  — per key: both sides present ⇒ ``a[k].join(b[k])``; one side ⇒
          that value (the other side is implicitly at that key's ⊥);
* ⊥     — the empty store; a key bound to its own type's bottom is
          indistinguishable from an absent key (``leq``/``==`` treat them
          identically), so deltas stay sparse;
* δ     — a store containing only the touched keys, each holding a delta
          of the embedded type. Joining single-key deltas yields multi-key
          store deltas, which is how per-key delta-intervals aggregate
          into one store-level wire message in the propagation engine.

This is a semilattice because the product of semilattices under the
pointwise order is one; heterogeneous value types are fine as long as each
*key* keeps one type across its lifetime (joining a GCounter into an
AWORSet at the same key is a type error, exactly as it would be without
the store).

The join has a **batched fast path**: when both sides hold
``tensor_lattice.TensorState`` values under many keys, the per-chunk LWW
merges are stacked into one ``delta_join`` kernel launch
(``kernels.ops.batched_delta_join``) instead of one launch per key. The
per-key Python loop remains as the fallback (``batched=False``, or
automatically for keys whose tensors cannot be stacked).

**Key lifecycle** (``repro_torch.lifecycle``): alongside each value the store
carries a per-key :data:`~repro_torch.lifecycle.lattice.Life` ``(epoch,
expiry)`` — the lexicographic lifecycle lattice. The per-key state is the
lex product ``Life ×lex Value``: equal epochs join expiries (max) and
values (pointwise) as ever; a higher epoch wins wholesale, so a compact
*tombstone* (bumped epoch, no value) ⊥-absorbs every straggler delta
from the reaped incarnation. Keys never touched by the lifecycle
subsystem sit at ``LIFE_BOTTOM`` (canonically absent from ``life``), so
plain stores behave exactly as before.

Replica integration lives in :mod:`repro_torch.core.propagation`:
``Replica``'s durable state is a ``LatticeStore`` (single-object replicas
are one-key stores behind a view property), and ``StoreReplica`` exposes
the keyed API.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from ..dtypes import common_device, to_torch, torch_dtype
from ..lifecycle.lattice import LIFE_BOTTOM, Life, life_join
from .tensor_lattice import (ChunkedTensor, TensorState, digest_keep_plan,
                             live_rows, mask_kept_chunks)


def _is_bottom(value: Any) -> bool:
    """A value equal to its own type's bottom is lattice-identity."""
    return value == type(value).bottom()


@dataclass(frozen=True, eq=False)
class LatticeStore:
    """key → lattice value, itself a join-semilattice (pointwise order).

    ``life`` is the per-key lifecycle component (epoch, expiry) — see the
    module docstring; an entry's value lives *at* its key's life epoch.
    ``LIFE_BOTTOM`` entries are canonically absent.
    """

    entries: Tuple[Tuple[str, Any], ...] = ()
    life: Tuple[Tuple[str, Life], ...] = ()

    # -- construction -----------------------------------------------------------
    @staticmethod
    def bottom() -> "LatticeStore":
        return LatticeStore()

    @staticmethod
    def of(mapping: Mapping[str, Any],
           life: Mapping[str, Life] = ()) -> "LatticeStore":
        return LatticeStore(tuple(sorted(mapping.items())),
                            _canon_life(dict(life).items()))

    @staticmethod
    def key_delta(key: str, delta_value: Any) -> "LatticeStore":
        """δ-mutator lift: a store delta touching exactly one key."""
        return LatticeStore(((key, delta_value),))

    @staticmethod
    def life_delta(key: str, life: Life) -> "LatticeStore":
        """A store delta carrying only lifecycle state for ``key`` — a
        touch (expiry extension) or, with a bumped epoch, a tombstone."""
        return LatticeStore((), _canon_life([(key, life)]))

    def with_life(self, key: str, life: Life) -> "LatticeStore":
        """This store with ``life`` joined into ``key``'s lifecycle —
        how a write delta is stamped with the epoch/TTL it targets."""
        m = dict(self.life)
        m[key] = life_join(m.get(key, LIFE_BOTTOM), life)
        return LatticeStore(self.entries, _canon_life(m.items()))

    # -- views ------------------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        return dict(self.entries)

    def keys(self) -> FrozenSet[str]:
        return frozenset(k for k, _ in self.entries)

    def all_keys(self) -> FrozenSet[str]:
        """Keys with *any* state — a value, an expiry, or a tombstone.
        Sharding/handoff/reaping must iterate this, not ``keys()``:
        tombstones carry no value but must still route and replicate."""
        return self.keys() | frozenset(k for k, _ in self.life)

    def life_of(self, key: str) -> Life:
        return dict(self.life).get(key, LIFE_BOTTOM)

    def tombstoned(self, key: str) -> bool:
        """Reaped and not revived: a past-0 epoch holding no value."""
        return self.life_of(key)[0] > 0 and key not in self.as_dict()

    def tombstoned_keys(self) -> FrozenSet[str]:
        """All tombstoned keys in ONE pass — polling loops ("is the
        whole fleet reaped yet?") should use this instead of calling
        :meth:`tombstoned` per key, which rebuilds both dicts each
        call."""
        held = {k for k, _ in self.entries}
        return frozenset(k for k, (epoch, _) in self.life
                         if epoch > 0 and k not in held)

    def get(self, key: str, typ=None):
        """Value at ``key``; ``typ.bottom()`` (or None) when absent."""
        val = self.as_dict().get(key)
        if val is None and typ is not None:
            return typ.bottom()
        return val

    def restrict(self, keys: Iterable[str]) -> "LatticeStore":
        """Sub-store of the given keys (the ownership-sharding projection).
        Always ≤ self, so joining a restriction is always safe. Carries
        the kept keys' lifecycle state too — tombstones shard and hand
        off like values."""
        keep = set(keys)
        return LatticeStore(tuple((k, v) for k, v in self.entries
                                  if k in keep),
                            tuple((k, lv) for k, lv in self.life
                                  if k in keep))

    # -- δ-mutator lift ----------------------------------------------------------
    def apply_delta(self, key: str, typ, mutator_name: str,
                    *args) -> "LatticeStore":
        """Lift a δ-mutator of the embedded type at ``key``: the returned
        store delta contains only that key. Mirrors ``ORMap.apply_delta``
        (args include the replica id when the mutator wants one)."""
        cur = self.get(key, typ)
        sub_delta = getattr(cur, mutator_name)(*args)
        return LatticeStore.key_delta(key, sub_delta)

    def update_delta(self, key: str, typ,
                     fn: Callable[[Any], Any]) -> "LatticeStore":
        """Like ``apply_delta`` with a free-form mutator function."""
        return LatticeStore.key_delta(key, fn(self.get(key, typ)))

    # -- lattice ----------------------------------------------------------------
    def _epochs(self) -> Dict[str, int]:
        """key → nonzero life epoch (absent ⇒ 0) — the part of the
        lifecycle that decides which side's value contributes to a join."""
        return {k: lv[0] for k, lv in self.life if lv[0]}

    def join(self, other: "LatticeStore", *,
             batched: bool = True) -> "LatticeStore":
        life = _joined_life(self.life, other.life)
        if batched and self._epochs() == other._epochs():
            # identical epochs per key ⇒ every value joins pointwise, so
            # the single-launch fast paths stay valid. Order: device-
            # resident columns (one scatter/fused launch, zero host
            # traffic), then the aligned host-stacked launch, then the
            # in-place host patch for subset deltas. An epoch mismatch
            # (reap/revive) lands in the general path below — which is
            # exactly the cache invalidation the lifecycle needs.
            if self.__dict__.get("_resident_cache") is not None:
                from ..kernels import resident
                fast = resident.try_join(self, other, life)
                if fast is not None:
                    return fast
            fast = _stacked_fast_join(self, other, life)
            if fast is not None:
                return fast
            fast = _patched_fast_join(self, other, life)
            if fast is not None:
                return fast
        a, b = self.as_dict(), other.as_dict()
        la, lb = dict(self.life), dict(other.life)
        out: Dict[str, Any] = {}
        pending: List[Tuple[str, Any, Any]] = []
        for k in set(a) | set(b):
            # lex product: only values at the winning epoch contribute —
            # a higher-epoch tombstone on either side absorbs the other
            ea = la.get(k, LIFE_BOTTOM)[0]
            eb = lb.get(k, LIFE_BOTTOM)[0]
            va = a.get(k) if ea >= eb else None
            vb = b.get(k) if eb >= ea else None
            if va is None and vb is None:
                continue
            if vb is None:
                out[k] = va
            elif va is None:
                out[k] = vb
            elif batched and _both_tensorstates(va, vb):
                pending.append((k, va, vb))
            else:
                out[k] = va.join(vb)
        if pending:
            out.update(_batched_join_tensorstates(pending))
        return LatticeStore(tuple(sorted(out.items())), life)

    def leq(self, other: "LatticeStore") -> bool:
        la, lb = dict(self.life), dict(other.life)
        b = other.as_dict()
        a = self.as_dict()
        for k in set(a) | set(la):
            ea, xa = la.get(k, LIFE_BOTTOM)
            eb, xb = lb.get(k, LIFE_BOTTOM)
            if ea > eb:
                return False
            if ea < eb:
                continue          # other's epoch absorbs this key entirely
            if xa > xb:
                return False
            v = a.get(k)
            if v is None:
                continue
            if k in b:
                if not v.leq(b[k]):
                    return False
            elif not _is_bottom(v):
                return False
        return True

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, LatticeStore):
            return NotImplemented
        if dict(_canon_life(self.life)) != dict(_canon_life(other.life)):
            return False
        a, b = self.as_dict(), other.as_dict()
        for k in set(a) | set(b):
            if k not in a or k not in b:
                # absent key ≡ that key's ⊥
                if not _is_bottom(a.get(k, b.get(k))):
                    return False
            elif a[k] != b[k]:
                return False
        return True

    def __hash__(self):  # pragma: no cover
        raise TypeError("unhashable")

    def decompose(self) -> list:
        """Join-decomposition: per key, one lifecycle atom (when the key
        has non-bottom life) plus the embedded value's atoms (when it
        decomposes) each wrapped as a single-key store; else one atom per
        key. Value atoms of a past-0 epoch carry that epoch (with the
        expiry at bottom) so re-joining them lands in the right
        incarnation. Lets RemoveRedundant trim store payloads key-by-key
        (and finer, where the value supports it)."""
        atoms = []
        la = dict(self.life)
        for k, lv in self.life:
            atoms.append(LatticeStore((), ((k, lv),)))
        for k, v in self.entries:
            epoch = la.get(k, LIFE_BOTTOM)[0]
            lf = ((k, (epoch, LIFE_BOTTOM[1])),) if epoch else ()
            sub = getattr(v, "decompose", None)
            if sub is None:
                atoms.append(LatticeStore(((k, v),), lf))
            else:
                atoms.extend(LatticeStore(((k, a),), lf) for a in sub())
        return atoms

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {type(v).__name__}" for k, v in self.entries)
        tombs = len(self.tombstoned_keys())
        extra = f", {tombs} tombstones" if tombs else ""
        return f"LatticeStore({{{inner}}}{extra})"


def _canon_life(items) -> Tuple[Tuple[str, Life], ...]:
    """Sorted life tuple with bottoms dropped (absent ≡ LIFE_BOTTOM)."""
    return tuple(sorted((k, lv) for k, lv in items if lv != LIFE_BOTTOM))


def _joined_life(a, b) -> Tuple[Tuple[str, Life], ...]:
    if not a:
        return _canon_life(b)
    if not b:
        return _canon_life(a)
    m = dict(a)
    for k, lv in b:
        cur = m.get(k)
        m[k] = lv if cur is None else life_join(cur, lv)
    return _canon_life(m.items())


# ---------------------------------------------------------------------------
# Batched TensorState join (one kernel launch over many keys' chunks)
# ---------------------------------------------------------------------------

def _both_tensorstates(a: Any, b: Any) -> bool:
    return isinstance(a, TensorState) and isinstance(b, TensorState)


def _stackable(act, bct) -> bool:
    if act.is_sparse or bct.is_sparse:
        return False    # sparse deltas join via the gather/scatter path
    return (act.values.shape == bct.values.shape
            and act.values.dtype == bct.values.dtype)


class _StackedChunks:
    """Columnar cache of all of a store's TensorState chunk data: one
    ``[total_rows, chunk]`` values tensor + ``[total_rows]`` versions (on
    the device the chunks live on), with a ``(key, name, start, stop)``
    layout. Built lazily on first batched join and attached to the
    (immutable) store, so a store that joins many deltas pays the
    stacking glue once; the output of a stacked join carries its own
    cache (its ChunkedTensors are views into the stacked result)."""

    __slots__ = ("vals", "vers", "layout", "sig", "_spans")

    def __init__(self, vals, vers, layout, sig):
        self.vals = vals
        self.vers = vers
        self.layout = layout
        self.sig = sig
        self._spans = None

    @property
    def spans(self):
        """(key, name) → (start, stop) row-range lookup, built lazily —
        what the in-place patch path and the resident adopter index by."""
        if self._spans is None:
            self._spans = {(k, n): (s, e) for k, n, s, e in self.layout}
        return self._spans


def _stack_columns(store: LatticeStore, densify: bool):
    """Stack every chunk tensor of a tensor-only store into one column
    pair, on the first accelerator device among the chunks (host chunks
    moved there count as staged), else on the host. Sparse tensors are
    densified when ``densify``, else make the store unstackable. Returns
    None for non-tensor / mixed-signature / empty stores. The signature
    carries the full key sequence too: a key holding an empty
    TensorState contributes no rows but must still align."""
    if not store.entries or not all(isinstance(v, TensorState)
                                    for _, v in store.entries):
        return None
    parts_v, parts_r, layout = [], [], []
    chunkw = dtype = vdtype = None
    row = 0
    for key, val in store.entries:
        for name, ct in val.chunks:
            if ct.is_sparse:
                if not densify:
                    return None
                ct = ct.to_dense()
            v, r = ct.values, ct.versions
            if chunkw is None:
                chunkw, dtype, vdtype = v.shape[1], v.dtype, r.dtype
            elif (v.shape[1] != chunkw or v.dtype != dtype
                  or r.dtype != vdtype):
                return None
            parts_v.append(v)
            parts_r.append(r)
            layout.append((key, name, row, row + v.shape[0]))
            row += v.shape[0]
    if not parts_v:
        return None
    dev = common_device(*parts_v)
    if dev.type != "cpu":
        from ..kernels import ops
        ops.counters.count_h2d(*parts_v, *parts_r, device=dev)
    sig = (tuple(k for k, _ in store.entries),
           tuple((k, n, stop - start) for k, n, start, stop in layout),
           chunkw, dtype, vdtype)
    return _StackedChunks(torch.cat([v.to(dev) for v in parts_v]),
                          torch.cat([r.to(dev) for r in parts_r]),
                          tuple(layout), sig)


def _stack_store(store: LatticeStore):
    """Fetch (or build and cache) the columnar view of ``store``. Returns
    None when the store is not stackable (non-tensor values, sparse
    tensors, mixed chunk widths/dtypes, or empty)."""
    cached = store.__dict__.get("_stacked_cache")
    if cached is not None:
        return cached if isinstance(cached, _StackedChunks) else None
    result = _stack_columns(store, densify=False)
    object.__setattr__(store, "_stacked_cache",
                       result if result is not None else False)
    return result


def _views_store(a_store, lamports, layout, vals, vers, life):
    """The joined store over stacked result columns: every tensor of
    ``a_store`` becomes a view of its span of ``vals``/``vers`` (the
    layout lists ``a_store``'s tensors in entry order), each key at
    ``lamports[key]``. Re-viewing every key, not only the touched ones,
    lets the previous generation of columns go once no older store holds
    it (a torch slice is a view that keeps its whole base alive)."""
    out_entries = []
    li = 0
    for key, A in a_store.entries:
        chunks = []
        for name, _ct in A.chunks:
            _, _, start, stop = layout[li]
            li += 1
            chunks.append((name, ChunkedTensor(vals[start:stop],
                                               vers[start:stop])))
        out_entries.append((key, TensorState(tuple(chunks),
                                             lamports[key])))
    return LatticeStore(tuple(out_entries), life)


def _joined_lamports(a_store, b_store) -> Dict[str, int]:
    """Per key of ``a_store``: its lamport, maxed with ``b_store``'s."""
    b_lam = {k: v.lamport for k, v in b_store.entries}
    return {k: max(v.lamport, b_lam.get(k, v.lamport))
            for k, v in a_store.entries}


def _stacked_fast_join(a_store: LatticeStore,
                       b_store: LatticeStore,
                       life: Tuple[Tuple[str, Life], ...] = ()):
    """Aligned-layout fast path: when both stores stack to the identical
    (key, name, rows) signature the whole join is ONE ``delta_join``
    launch over the cached columns. Returns None when the layouts differ
    (the general per-segment path handles subsets and mismatches).
    ``life`` is the pre-joined lifecycle component (the caller has
    checked both sides agree on epochs, so values join pointwise)."""
    sa = _stack_store(a_store)
    if sa is None:
        return None
    sb = _stack_store(b_store)
    if sb is None or sa.sig != sb.sig:
        return None
    from ..kernels import ops
    ov, over = ops.delta_join(sa.vals, sa.vers, sb.vals, sb.vers)
    result = _views_store(a_store, _joined_lamports(a_store, b_store),
                          sa.layout, ov, over, life)
    object.__setattr__(result, "_stacked_cache",
                       _StackedChunks(ov, over, sa.layout, sa.sig))
    return result


def _patch_entries(a_store, b_store, spans, vals, vers, life):
    """The joined store of a subset delta over patched columns: tensors
    ``b_store`` touched become views of their spans, every untouched
    key keeps its entry object."""
    a_map = dict(a_store.entries)
    touched: Dict[str, Any] = {}
    for key, B in b_store.entries:
        A = a_map[key]
        b_names = frozenset(n for n, _ in B.chunks)
        chunks = []
        for name, ct in A.chunks:
            if name in b_names:
                start, stop = spans[(key, name)]
                chunks.append((name, ChunkedTensor(vals[start:stop],
                                                   vers[start:stop])))
            else:
                chunks.append((name, ct))
        touched[key] = TensorState(tuple(chunks), max(A.lamport, B.lamport))
    entries = tuple((k, touched.get(k, v)) for k, v in a_store.entries)
    return LatticeStore(entries, life)


def _covers_layout(spans, chunkw, a_keys, b_store) -> bool:
    """Every tensor of ``b_store`` lands in an existing span of the
    stacked layout with the same chunk count and width."""
    for key, val in b_store.entries:
        if not isinstance(val, TensorState) or key not in a_keys:
            return False
        for name, ct in val.chunks:
            span = spans.get((key, name))
            if span is None:
                return False
            n_chunks, width = ct.shape
            if n_chunks != span[1] - span[0] or width != chunkw:
                return False
    return True


def _patched_fast_join(a_store: LatticeStore,
                       b_store: LatticeStore,
                       life: Tuple[Tuple[str, Life], ...] = ()):
    """Stacked-cache patch path: ``a_store`` holds a stacked column cache
    and ``b_store`` touches a *subset* of its (key, tensor) spans with
    matching chunk counts. Copy the columns once and LWW-patch only the
    shipped rows; untouched keys reuse their entry objects. Returns None
    on any layout change (new key, new tensor, chunk-count drift)."""
    sa = a_store.__dict__.get("_stacked_cache")
    if not isinstance(sa, _StackedChunks) or not b_store.entries:
        return None
    if not _covers_layout(sa.spans, sa.sig[2], dict(a_store.entries),
                          b_store):
        return None
    dev = sa.vals.device
    patches = []           # (start, local idx, vals rows, vers rows)
    for key, val in b_store.entries:
        for name, ct in val.chunks:
            li, lv, lr = live_rows(ct)
            if torch_dtype(lv.dtype) != sa.sig[3] \
                    or torch_dtype(lr.dtype) != sa.sig[4]:
                return None
            if li.size:
                patches.append((sa.spans[(key, name)][0], li, lv, lr))

    new_vals = sa.vals.clone()
    new_vers = sa.vers.clone()
    for start, li, lv, lr in patches:
        rows = torch.as_tensor(li.astype(np.int64) + start, device=dev)
        lr_t = to_torch(lr, dev)
        take = lr_t > new_vers[rows]
        if bool(take.any()):
            rows = rows[take]
            new_vals[rows] = to_torch(lv, dev)[take]
            new_vers[rows] = lr_t[take]

    result = _patch_entries(a_store, b_store, sa.spans, new_vals, new_vers,
                            life)
    object.__setattr__(result, "_stacked_cache",
                       _StackedChunks(new_vals, new_vers, sa.layout, sa.sig))
    return result


def _batched_join_tensorstates(pairs: List[Tuple[str, Any, Any]]
                               ) -> Dict[str, Any]:
    """Join many (key, TensorState, TensorState) pairs with the chunk
    merges of *all* keys stacked into one kernel launch per (chunk-width,
    dtype, device) group. Keys whose tensors cannot be stacked
    (sparse, shape/dtype mismatch) fall back to the per-key join."""
    from ..kernels import ops

    out: Dict[str, Any] = {}
    segments: List[Tuple[Any, Any, Any, Any]] = []
    # per key: the merged (name, ChunkedTensor-or-segment-index) plan;
    # ``TensorState.chunks`` is sorted by name, so a linear sorted-tuple
    # merge avoids dict/set construction per key on the hot path
    plans: List[Tuple[str, list, int]] = []    # (key, plan, lamport)

    for key, A, B in pairs:
        ca, cb = A.chunks, B.chunks
        ia = ib = 0
        plan: list = []
        seg_start = len(segments)
        ok = True
        while ia < len(ca) or ib < len(cb):
            if ib == len(cb) or (ia < len(ca) and ca[ia][0] < cb[ib][0]):
                plan.append(ca[ia])
                ia += 1
            elif ia == len(ca) or cb[ib][0] < ca[ia][0]:
                plan.append(cb[ib])
                ib += 1
            else:                              # same tensor on both sides
                name, act = ca[ia]
                bct = cb[ib][1]
                if not _stackable(act, bct):
                    ok = False
                    break
                dev = common_device(act.values, bct.values)
                plan.append((name, len(segments)))
                segments.append((act.values.to(dev), act.versions.to(dev),
                                 bct.values.to(dev), bct.versions.to(dev)))
                ia += 1
                ib += 1
        if not ok:
            del segments[seg_start:]           # discard this key's segments
            out[key] = A.join(B)               # per-key fallback
            continue
        plans.append((key, plan, max(A.lamport, B.lamport)))

    results = ops.batched_delta_join(segments) if segments else []
    for key, plan, lamport in plans:
        chunks = tuple(
            (name, ChunkedTensor(*results[v]) if isinstance(v, int) else v)
            for name, v in plan)
        out[key] = TensorState(chunks, lamport)
    return out


# ---------------------------------------------------------------------------
# Store-wide digest selection (the DigestBudget policy over keyed stores)
# ---------------------------------------------------------------------------

def digest_select_store(store: LatticeStore,
                        budget_bytes: int) -> LatticeStore:
    """Byte-budgeted chunk selection across the *whole* store: chunks from
    every ``TensorState`` value under every key enter ONE global energy
    ranking (``tensor_lattice.digest_keep_plan``, scope = store key) — so
    the budget picks *keys* by digest, not just chunks within one object.
    Non-tensor values pass through untouched. Lifecycle state rides
    through whole. The result is ≤ ``store`` pointwise, so joining it is
    always safe. A resident store ranks from its maintained digest
    columns (``resident.keep_plan``: one sort epilogue)."""
    passthrough: Dict[str, Any] = {}
    tensor_keys: Dict[str, Any] = {}
    for key, val in store.as_dict().items():
        (tensor_keys if isinstance(val, TensorState)
         else passthrough)[key] = val

    cache = store.__dict__.get("_resident_cache")
    if cache is not None:
        from ..kernels import resident
        keep = resident.keep_plan(cache, budget_bytes)
    else:
        keep = digest_keep_plan(
            ((key, name, ct) for key, val in tensor_keys.items()
             for name, ct in val.as_dict().items()), budget_bytes)
    if keep is None:
        return store

    out: Dict[str, Any] = dict(passthrough)
    for key, val in tensor_keys.items():
        kept = {name: mask_kept_chunks(ct, keep[(key, name)])
                for name, ct in val.as_dict().items()
                if keep.get((key, name))}
        if kept:
            out[key] = TensorState.of(kept, lamport=val.lamport)
    return LatticeStore(tuple(sorted(out.items())), store.life)
