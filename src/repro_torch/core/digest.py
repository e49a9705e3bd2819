"""Digest summaries for request/response (pull-shaped) anti-entropy.

Push-shaped shipping (the :class:`~repro_torch.core.propagation.Replica`
delta/interval machinery) needs the *sender* to know what the receiver
lacks; when it cannot (a reconnecting replica behind the GC horizon, a
read-heavy replica that generates no deltas of its own), the engine falls
back to shipping the full state. Digest-driven sync (Enes et al.,
*Efficient Synchronization of State-based CRDTs*) closes that gap with a
pull exchange: the replica that wants data summarizes **what it holds** in
a compact digest, and the peer replies with exactly the join-irreducible
pieces the digest provably lacks.

The digest of a :class:`~repro_torch.core.store.LatticeStore` has two parts:

* ``tensors``  — per ``(key, tensor-name)``: the dense ``[n_chunks]``
                 version column of the resident
                 :class:`~repro_torch.core.tensor_lattice.TensorState` value.
                 Chunk versions ``(lamport, writer-rank)`` are totally
                 ordered and unique per write, so ``peer_version >
                 digest_version`` identifies exactly the rows the
                 requester lacks — no content ships for the summary.
* ``opaque``   — per key holding any non-tensor lattice (counters,
                 OR-Sets, registers, membership views, dot stores…): a
                 16-byte blake2b hash of the canonical pickled value.
                 Equal hashes ⇒ equal values ⇒ nothing ships; a
                 representation-sensitive false mismatch only costs a
                 redundant (idempotent) re-ship, never a missed update.
* ``life``     — per key with non-bottom lifecycle state: the
                 ``(epoch, expiry)`` pair (``repro_torch.lifecycle``). Epochs
                 gate the other two sections: rows/hashes only compare
                 within one incarnation, a requester at a *higher* epoch
                 needs nothing for the key (its tombstone absorbs
                 whatever the responder still holds), and a requester at
                 a *lower* epoch gets the key wholesale — so pull-sync
                 propagates reaps and never resurrects them.

``digest_diff(store, digest)`` is the responder's half: the sub-delta of
``store`` that the digest's owner lacks. Its load-bearing property (the
reason pull-sync preserves the causal delta-merging condition) is **join
equivalence to the full state**::

    requester_X ⊔ digest_diff(responder_X, digest(requester_X))
        == requester_X ⊔ responder_X

Every row the filter removes is one the requester's version dominates
(LWW keeps the requester's row either way), and every opaque key it
removes is value-equal — so joining a digest response is indistinguishable
from joining the responder's full state, which Def. 6 always permits.
The wire layer applies the same filter directly at encode time
(``wire.codec.encode_store(known_versions=...)``) so the response frame
is built straight from resident state without materializing this
intermediate; this module is the object-mode path and the oracle.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np

from ..dtypes import to_numpy
from ..lifecycle.lattice import LIFE_BOTTOM, Life
from . import dotcols
from .crdts import CAUSAL_WIRE_TYPES
from .dots import CausalContext, DotFun, DotMap, DotSet
from .store import LatticeStore
from .tensor_lattice import (TensorState, dense_versions, live_rows,
                             sparse_chunks)


def _canon(x: Any) -> Any:
    """Representation-independent form of a lattice value for hashing.

    Equal values must hash equal, but several datatypes store
    ``frozenset``s (GSet, the OR-Set dot clouds, …) whose pickle bytes
    depend on insertion order and on the per-process hash seed — two
    converged replicas would hash-mismatch and re-ship the value every
    pull round forever. Canonicalization sorts every set/dict by the
    ``repr`` of its canonicalized members (``repr`` is deterministic
    across processes; mixed element types make direct ``sorted``
    unusable) and flattens dataclasses into (type-name, field, value)
    tuples so nested containers are reached."""
    if isinstance(x, (frozenset, set)):
        return ("set\x00", tuple(sorted((_canon(v) for v in x), key=repr)))
    if isinstance(x, dict):
        return ("dict\x00", tuple(sorted(
            ((_canon(k), _canon(v)) for k, v in x.items()), key=repr)))
    if isinstance(x, tuple):
        return tuple(_canon(v) for v in x)
    if isinstance(x, list):
        return ("list\x00", tuple(_canon(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, _canon(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    return x


def opaque_hash(value: Any) -> bytes:
    """16-byte content hash of a non-tensor lattice value: blake2b over
    the pickled *canonical* form (see :func:`_canon`), so equal values
    hash equal regardless of internal set/dict ordering or process."""
    return hashlib.blake2b(pickle.dumps(_canon(value), protocol=4),
                           digest_size=16).digest()


@dataclass(eq=False)
class StoreDigest:
    """Compact 'what I hold' summary of a store (see module docstring).

    ``causal`` is the per-dot section: per key holding a causal dot
    store, a :class:`~repro_torch.core.dotcols.CausalDigest` (vv + cloud
    summary plus the flat store dot column) — enough for a responder to
    compute the *exact* missing-dot response instead of re-shipping the
    value whenever a content hash mismatches."""

    tensors: Dict[Tuple[str, str], np.ndarray] = field(default_factory=dict)
    opaque: Dict[str, bytes] = field(default_factory=dict)
    life: Dict[str, Life] = field(default_factory=dict)
    causal: Dict[str, Any] = field(default_factory=dict)

    def epoch_of(self, key: str) -> int:
        return self.life.get(key, LIFE_BOTTOM)[0]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, StoreDigest):
            return NotImplemented
        return (self.opaque == other.opaque
                and self.life == other.life
                and self.causal == other.causal
                and set(self.tensors) == set(other.tensors)
                and all(np.array_equal(v, other.tensors[k])
                        for k, v in self.tensors.items()))

    def __repr__(self) -> str:
        return (f"StoreDigest({len(self.tensors)} tensor cols, "
                f"{len(self.opaque)} opaque keys, "
                f"{len(self.causal)} causal keys, "
                f"{len(self.life)} life keys)")


def store_digest(store: LatticeStore) -> StoreDigest:
    """Summarize ``store``: dense per-chunk version columns for tensor
    values, content hashes for everything else, plus every key's
    non-bottom lifecycle state (expiries and tombstones pull-sync like
    any other state)."""
    out = StoreDigest()
    # A stacked/resident cache already holds every covered tensor's dense
    # version column contiguously (and the resident cache mirrors it on
    # host — vers_host — precisely so digests never touch the device);
    # serve those as zero-copy slices and densify only uncovered tensors.
    spans, vers_col = None, None
    cache = store.__dict__.get("_resident_cache")
    if cache is not None:
        spans, vers_col = cache.spans, cache.vers_host
    else:
        sc = store.__dict__.get("_stacked_cache")
        if sc is not None and sc is not False:   # False = "not stackable"
            spans, vers_col = sc.spans, to_numpy(sc.vers)
    for key, val in store.entries:
        if isinstance(val, TensorState):
            for name, ct in val.chunks:
                span = spans.get((key, name)) if spans is not None else None
                if span is not None:
                    out.tensors[(key, name)] = vers_col[span[0]:span[1]]
                else:
                    out.tensors[(key, name)] = dense_versions(ct)
        elif isinstance(val, CAUSAL_WIRE_TYPES):
            g = dotcols.causal_digest_of(val)
            if g is not None:
                out.causal[key] = g
            else:                     # nested-map shape: hash like opaque
                out.opaque[key] = opaque_hash(val)
        else:
            out.opaque[key] = opaque_hash(val)
    out.life.update(store.life)
    return out


def life_diff(life, shipped_keys, known_life) -> list:
    """The life entries a digest response must carry: every entry
    strictly above the peer's (``known_life`` None ⇒ unfiltered: all of
    them), plus an ``(epoch, -inf)`` stamp for any *shipped* key at a
    past-0 epoch whose full life entry is lex-dominated — an unstamped
    value would join at epoch 0 and be absorbed by the requester's own
    lifecycle state. The single implementation behind both responders
    (object-mode :func:`digest_diff` and the wire encoder's
    ``encode_store(known_life=...)``), so the no-resurrection invariant
    cannot drift between modes. Returns sorted ``(key, Life)`` pairs."""
    out = [(k, lv) for k, lv in life
           if known_life is None or lv > known_life.get(k, LIFE_BOTTOM)]
    have = {k for k, _ in out}
    life_map = dict(life)
    for key in shipped_keys:
        epoch = life_map.get(key, LIFE_BOTTOM)[0]
        if epoch and key not in have:
            out.append((key, (epoch, LIFE_BOTTOM[1])))
    return sorted(out)


def _causal_diff_obj(value, g):
    """Set-based reference implementation of the per-dot digest response
    (:func:`~repro_torch.core.dotcols.causal_diff_cols` is the columnar
    twin that :func:`digest_diff` and the wire encoder use; the tests
    hold the two equal). Computes

        s_ship = {d ∈ s_resp | d ∉ c_req}
        c_ship = {d ∈ g.dots | d ∈ c_resp, d ∉ s_resp} ∪ (c_resp \\ c_req)

    directly with Python sets over the object representation. Joining
    ``(s_ship, c_ship)`` at the requester reproduces the join of the
    responder's full state exactly (DESIGN.md §9), and ``s_ship`` never
    carries a dot the requester's context contains. Returns None when
    the requester lacks nothing."""
    val = dotcols.value_to_obj(value)
    store, ctx = val.store, val.ctx
    gvv = {g.rids[j]: int(n) for j, n in enumerate(g.vvcol) if n}
    gcloud = dotcols._unpack(g.rids, g.cloudcol)
    gdots = dotcols._unpack(g.rids, g.dotcol)

    def req_has(d):
        return d[1] <= gvv.get(d[0], 0) or d in gcloud

    s_all = store.all_dots()
    new = {d for d in s_all if not req_has(d)}
    removed = {d for d in gdots if ctx.contains(d) and d not in s_all}
    extras = set()
    for i, n in ctx.vv:
        for k in range(gvv.get(i, 0) + 1, n + 1):
            if (i, k) not in gcloud:
                extras.add((i, k))
    for d in ctx.cloud:
        if not req_has(d):
            extras.add(d)
    cship = removed | extras
    if not new and not cship:
        return None

    def filt(s):
        if isinstance(s, DotSet):
            return DotSet(frozenset(s.dots & new))
        if isinstance(s, DotFun):
            return DotFun(tuple((d, v) for d, v in s.entries if d in new))
        return DotMap(tuple((k, f) for k, sub in s.entries
                            if not (f := filt(sub)).is_bottom()))

    return type(val)(filt(store), CausalContext.from_dots(cship))


def digest_diff(store: LatticeStore, digest: StoreDigest) -> LatticeStore:
    """The sub-delta of ``store`` that ``digest``'s owner provably lacks:
    per tensor, only the chunk rows whose version strictly exceeds the
    digest's version at that position (as sparse row sets); per opaque
    key, the whole value iff its content hash differs; per causal key,
    the exact missing-dot sub-delta (:func:`~repro_torch.core.dotcols.
    causal_diff_cols`); keys absent from the digest ship wholesale.
    Lifecycle-aware: life entries ship iff
    strictly above the digest's (tombstones and expiry extensions
    propagate through pull), a key whose digest epoch *exceeds* the
    responder's ships nothing (the requester's tombstone absorbs it),
    and version/hash filters only apply within the same incarnation —
    an epoch-0 version column must never suppress epoch-1 rows. Always
    ≤ ``store``, and join-equivalent to it for the digest's owner
    (module docstring)."""
    la = dict(store.life)
    out: Dict[str, Any] = {}
    for key, val in store.entries:
        epoch = la.get(key, LIFE_BOTTOM)[0]
        q_epoch = digest.epoch_of(key)
        if q_epoch > epoch:
            continue                 # requester's incarnation dominates
        same_epoch = q_epoch == epoch
        if isinstance(val, CAUSAL_WIRE_TYPES):
            g = digest.causal.get(key) if same_epoch else None
            if g is None:
                out[key] = val        # requester lacks the key: whole
            else:
                d = (dotcols.causal_diff_cols(val, g)
                     if dotcols.value_to_cols(val) is not None
                     else _causal_diff_obj(val, g))   # nested maps
                if d is not None:
                    out[key] = d      # exact missing-dot sub-delta
            continue
        if not isinstance(val, TensorState):
            h = digest.opaque.get(key) if same_epoch else None
            if h is None or h != opaque_hash(val):
                out[key] = val
            continue
        chunks: Dict[str, Any] = {}
        for name, ct in val.chunks:
            known = (digest.tensors.get((key, name)) if same_epoch
                     else None)
            idx, vals, vers = live_rows(ct, known)
            if idx.size:
                chunks[name] = sparse_chunks(ct.shape[0], idx, vals, vers)
        if chunks:
            out[key] = TensorState.of(chunks, lamport=val.lamport)
    return LatticeStore(tuple(sorted(out.items())),
                        tuple(life_diff(store.life, out, digest.life)))
