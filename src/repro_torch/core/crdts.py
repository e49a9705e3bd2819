"""δ-CRDT datatype catalogue.

Every datatype below is specified as a triple ``(S, Mᵟ, Q)`` (paper Def. 3):

* the state is an immutable value in a join-semilattice (``join`` is
  commutative, associative, idempotent; ``bottom()`` is ⊥);
* *delta-mutators* ``mᵟ`` take the current state (plus the local replica id
  where the paper indexes the mutator by replica) and return a **delta** —
  a small state in the same semilattice, to be joined locally and shipped;
* *full mutators* ``m`` (suffix ``_full``) implement the corresponding
  standard state-based CRDT mutator, so the delta-state-decomposition law
  of §4.1, ``m(X) = X ⊔ mᵟ(X)``, is directly testable for every datatype.

Datatypes implemented (paper figures in brackets):

  GCounter [Figs. 1–2]          PNCounter           GSet            TwoPSet
  AWORSetTombstone [Fig. 3a]    AWORSet [Fig. 3b]   RWORSet         LWWRegister
  MVRegister [Fig. 4]           LWWSet              EWFlag / DWFlag ORMap

``AWORSet`` / ``MVRegister`` / flags / ``ORMap`` use the compressed causal
context of §7.2 (version vector + dot cloud) and the generic causal join
from ``repro_torch.core.dots``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, FrozenSet, Mapping, Optional, Tuple

from .dots import (CausalContext, Dot, DotFun, DotMap, DotSet, ReplicaId,
                   causal_join)


class DeltaCRDT:
    """Mixin: derived partial order and convenience operators."""

    def join(self, other):  # pragma: no cover - overridden
        raise NotImplementedError

    def leq(self, other) -> bool:
        return self.join(other) == other

    def __or__(self, other):
        return self.join(other)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def _map_max(a: Tuple[Tuple[ReplicaId, int], ...],
             b: Tuple[Tuple[ReplicaId, int], ...]) -> Tuple[Tuple[ReplicaId, int], ...]:
    m = dict(a)
    for i, n in b:
        m[i] = max(m.get(i, 0), n)
    return tuple(sorted(m.items()))


@dataclass(frozen=True)
class GCounter(DeltaCRDT):
    """Grow-only counter (paper Figs. 1 & 2). State: 𝕀 ↪ ℕ, join: pointwise max."""

    entries: Tuple[Tuple[ReplicaId, int], ...] = ()

    @staticmethod
    def bottom() -> "GCounter":
        return GCounter()

    def value(self) -> int:
        return sum(n for _, n in self.entries)

    def _get(self, i: ReplicaId) -> int:
        return dict(self.entries).get(i, 0)

    # Fig. 2: incᵟᵢ(m) = {i ↦ m(i) + 1} — ONLY the updated entry.
    def inc_delta(self, i: ReplicaId, by: int = 1) -> "GCounter":
        assert by >= 0
        return GCounter(((i, self._get(i) + by),))

    # Fig. 1: incᵢ(m) = m{i ↦ m(i) + 1} — the full map.
    def inc_full(self, i: ReplicaId, by: int = 1) -> "GCounter":
        m = dict(self.entries)
        m[i] = m.get(i, 0) + by
        return GCounter(tuple(sorted(m.items())))

    def join(self, other: "GCounter") -> "GCounter":
        return GCounter(_map_max(self.entries, other.entries))

    def decompose(self):
        """Join-irreducible atoms (one per map entry) — lets the
        RemoveRedundant shipping policy trim payloads part-wise."""
        return [GCounter(((i, n),)) for i, n in self.entries]


@dataclass(frozen=True)
class PNCounter(DeltaCRDT):
    """Increment/decrement counter: a pair of GCounters (P, N)."""

    pos: GCounter = GCounter()
    neg: GCounter = GCounter()

    @staticmethod
    def bottom() -> "PNCounter":
        return PNCounter()

    def value(self) -> int:
        return self.pos.value() - self.neg.value()

    def inc_delta(self, i: ReplicaId, by: int = 1) -> "PNCounter":
        return PNCounter(pos=self.pos.inc_delta(i, by))

    def dec_delta(self, i: ReplicaId, by: int = 1) -> "PNCounter":
        return PNCounter(neg=self.neg.inc_delta(i, by))

    def inc_full(self, i: ReplicaId, by: int = 1) -> "PNCounter":
        return PNCounter(pos=self.pos.inc_full(i, by), neg=self.neg)

    def dec_full(self, i: ReplicaId, by: int = 1) -> "PNCounter":
        return PNCounter(pos=self.pos, neg=self.neg.inc_full(i, by))

    def join(self, other: "PNCounter") -> "PNCounter":
        return PNCounter(self.pos.join(other.pos), self.neg.join(other.neg))

    def decompose(self):
        return ([PNCounter(pos=a) for a in self.pos.decompose()]
                + [PNCounter(neg=a) for a in self.neg.decompose()])


# ---------------------------------------------------------------------------
# Grow-only / two-phase sets
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GSet(DeltaCRDT):
    """Grow-only set. addᵟ(e) = {e}."""

    elems: FrozenSet[Any] = frozenset()

    @staticmethod
    def bottom() -> "GSet":
        return GSet()

    def elements(self) -> FrozenSet[Any]:
        return self.elems

    def add_delta(self, e: Any) -> "GSet":
        return GSet(frozenset([e]))

    def add_full(self, e: Any) -> "GSet":
        return GSet(self.elems | {e})

    def join(self, other: "GSet") -> "GSet":
        return GSet(self.elems | other.elems)


@dataclass(frozen=True)
class TwoPSet(DeltaCRDT):
    """Two-phase set: adds + tombstones; once removed, never re-added."""

    added: FrozenSet[Any] = frozenset()
    removed: FrozenSet[Any] = frozenset()

    @staticmethod
    def bottom() -> "TwoPSet":
        return TwoPSet()

    def elements(self) -> FrozenSet[Any]:
        return self.added - self.removed

    def add_delta(self, e: Any) -> "TwoPSet":
        return TwoPSet(added=frozenset([e]))

    def rmv_delta(self, e: Any) -> "TwoPSet":
        # Observed-remove discipline: tombstone only what was added (paper
        # Fig. 3a applies the same guard for the tombstoned OR-Set).
        if e in self.added:
            return TwoPSet(removed=frozenset([e]))
        return TwoPSet()

    def add_full(self, e: Any) -> "TwoPSet":
        return self.join(self.add_delta(e))

    def rmv_full(self, e: Any) -> "TwoPSet":
        return self.join(self.rmv_delta(e))

    def join(self, other: "TwoPSet") -> "TwoPSet":
        return TwoPSet(self.added | other.added, self.removed | other.removed)


# ---------------------------------------------------------------------------
# Add-wins OR-Set, tombstone version (paper Fig. 3a)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AWORSetTombstone(DeltaCRDT):
    """Σ = 𝒫(𝕀 × ℕ × E) × 𝒫(𝕀 × ℕ); both components grow-only (Fig. 3a)."""

    s: FrozenSet[Tuple[ReplicaId, int, Any]] = frozenset()
    t: FrozenSet[Dot] = frozenset()  # tombstones

    @staticmethod
    def bottom() -> "AWORSetTombstone":
        return AWORSetTombstone()

    def elements(self) -> FrozenSet[Any]:
        return frozenset(e for (j, n, e) in self.s if (j, n) not in self.t)

    def _next_n(self, i: ReplicaId) -> int:
        # n = max({k | (i, k, ⊥) ∈ s}), max(∅) = 0.
        return max((k for (j, k, _) in self.s if j == i), default=0)

    def add_delta(self, i: ReplicaId, e: Any) -> "AWORSetTombstone":
        n = self._next_n(i)
        return AWORSetTombstone(s=frozenset([(i, n + 1, e)]))

    def rmv_delta(self, i: ReplicaId, e: Any) -> "AWORSetTombstone":
        return AWORSetTombstone(
            t=frozenset((j, n) for (j, n, e2) in self.s if e2 == e))

    def add_full(self, i: ReplicaId, e: Any) -> "AWORSetTombstone":
        return self.join(self.add_delta(i, e))

    def rmv_full(self, i: ReplicaId, e: Any) -> "AWORSetTombstone":
        return self.join(self.rmv_delta(i, e))

    def join(self, other: "AWORSetTombstone") -> "AWORSetTombstone":
        return AWORSetTombstone(self.s | other.s, self.t | other.t)


# ---------------------------------------------------------------------------
# Optimized add-wins OR-Set (paper Fig. 3b) — causal context, no tombstones
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AWORSet(DeltaCRDT):
    """Optimized OR-Set: tagged elements shrink on removal (Fig. 3b).

    The causal context is stored compressed (§7.2).
    """

    store: DotFun = DotFun()          # dot -> element
    ctx: CausalContext = CausalContext()

    @staticmethod
    def bottom() -> "AWORSet":
        return AWORSet()

    def elements(self) -> FrozenSet[Any]:
        # Fig. 3b: elements((s, c)) = {e | (j, n, e) ∈ s} — no tombstone check.
        return frozenset(self.store.values())

    def contains(self, e: Any) -> bool:
        return e in self.elements()

    def add_delta(self, i: ReplicaId, e: Any) -> "AWORSet":
        d = self.ctx.next_dot(i)  # n = max{k | (i,k) ∈ c} + 1
        return AWORSet(DotFun.of({d: e}), CausalContext.from_dots([d]))

    def rmv_delta(self, i: ReplicaId, e: Any) -> "AWORSet":
        dots = [d for d, v in self.store.entries if v == e]
        return AWORSet(DotFun(), CausalContext.from_dots(dots))

    def add_full(self, i: ReplicaId, e: Any) -> "AWORSet":
        return self.join(self.add_delta(i, e))

    def rmv_full(self, i: ReplicaId, e: Any) -> "AWORSet":
        return self.join(self.rmv_delta(i, e))

    def join(self, other: "AWORSet") -> "AWORSet":
        store, ctx = causal_join(self.store, self.ctx, other.store, other.ctx)
        return AWORSet(store, ctx)


# ---------------------------------------------------------------------------
# Remove-wins OR-Set (as in the paper's companion C++ library [11])
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RWORSet(DeltaCRDT):
    """Remove-wins OR-Set: concurrent add ∥ rmv of the same element ⇒ absent.

    Store: dot → (element, is_add_token). An element is present iff it has at
    least one add token and **no** remove token.
    """

    store: DotFun = DotFun()  # dot -> (element, bool)
    ctx: CausalContext = CausalContext()

    @staticmethod
    def bottom() -> "RWORSet":
        return RWORSet()

    def elements(self) -> FrozenSet[Any]:
        tokens: Dict[Any, set] = {}
        for _, (e, is_add) in self.store.entries:
            tokens.setdefault(e, set()).add(is_add)
        return frozenset(e for e, tk in tokens.items() if tk == {True})

    def _token_delta(self, i: ReplicaId, e: Any, token: bool) -> "RWORSet":
        # Supersede all existing tokens for e (their dots go in the context),
        # then place a single fresh token.
        old = [d for d, (e2, _) in self.store.entries if e2 == e]
        d = self.ctx.next_dot(i)
        return RWORSet(DotFun.of({d: (e, token)}),
                       CausalContext.from_dots(old + [d]))

    def add_delta(self, i: ReplicaId, e: Any) -> "RWORSet":
        return self._token_delta(i, e, True)

    def rmv_delta(self, i: ReplicaId, e: Any) -> "RWORSet":
        return self._token_delta(i, e, False)

    def add_full(self, i: ReplicaId, e: Any) -> "RWORSet":
        return self.join(self.add_delta(i, e))

    def rmv_full(self, i: ReplicaId, e: Any) -> "RWORSet":
        return self.join(self.rmv_delta(i, e))

    def join(self, other: "RWORSet") -> "RWORSet":
        store, ctx = causal_join(self.store, self.ctx, other.store, other.ctx)
        return RWORSet(store, ctx)


# ---------------------------------------------------------------------------
# Optimized multi-value register (paper Fig. 4)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MVRegister(DeltaCRDT):
    """Optimized MVR: scalar dots, not per-value version vectors (Fig. 4).

    wrᵟᵢ(v, (s, c)) = ({(i, n+1, v)}, {(i, n+1)} ∪ {(j, m) | (j, m, ⊥) ∈ s})
    — the write's causal context covers every currently-visible value, so
    overwritten values are deleted at replicas that still hold them; values
    written concurrently survive as siblings.
    """

    store: DotFun = DotFun()  # dot -> value
    ctx: CausalContext = CausalContext()

    @staticmethod
    def bottom() -> "MVRegister":
        return MVRegister()

    def read(self) -> FrozenSet[Any]:
        return frozenset(self.store.values())

    def write_delta(self, i: ReplicaId, v: Any) -> "MVRegister":
        d = self.ctx.next_dot(i)
        covered = list(self.store.all_dots()) + [d]
        return MVRegister(DotFun.of({d: v}), CausalContext.from_dots(covered))

    def write_full(self, i: ReplicaId, v: Any) -> "MVRegister":
        return self.join(self.write_delta(i, v))

    def join(self, other: "MVRegister") -> "MVRegister":
        store, ctx = causal_join(self.store, self.ctx, other.store, other.ctx)
        return MVRegister(store, ctx)


# ---------------------------------------------------------------------------
# LWW register / set
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LWWRegister(DeltaCRDT):
    """Last-writer-wins register; (timestamp, replica-id) lexicographic max."""

    stamp: Tuple[int, ReplicaId] = (0, "")
    value: Any = None

    @staticmethod
    def bottom() -> "LWWRegister":
        return LWWRegister()

    def read(self) -> Any:
        return self.value

    def write_delta(self, i: ReplicaId, ts: int, v: Any) -> "LWWRegister":
        return LWWRegister((ts, i), v)

    def write_full(self, i: ReplicaId, ts: int, v: Any) -> "LWWRegister":
        return self.join(self.write_delta(i, ts, v))

    def join(self, other: "LWWRegister") -> "LWWRegister":
        return self if other.stamp <= self.stamp else other


@dataclass(frozen=True)
class LWWSet(DeltaCRDT):
    """LWW element set: per-element (stamp, present) register, max-join."""

    entries: Tuple[Tuple[Any, Tuple[Tuple[int, ReplicaId], bool]], ...] = ()

    @staticmethod
    def bottom() -> "LWWSet":
        return LWWSet()

    def elements(self) -> FrozenSet[Any]:
        return frozenset(e for e, (_, present) in self.entries if present)

    def _write(self, i: ReplicaId, ts: int, e: Any, present: bool) -> "LWWSet":
        return LWWSet(((e, ((ts, i), present)),))

    def add_delta(self, i: ReplicaId, ts: int, e: Any) -> "LWWSet":
        return self._write(i, ts, e, True)

    def rmv_delta(self, i: ReplicaId, ts: int, e: Any) -> "LWWSet":
        return self._write(i, ts, e, False)

    def add_full(self, i: ReplicaId, ts: int, e: Any) -> "LWWSet":
        return self.join(self.add_delta(i, ts, e))

    def rmv_full(self, i: ReplicaId, ts: int, e: Any) -> "LWWSet":
        return self.join(self.rmv_delta(i, ts, e))

    def join(self, other: "LWWSet") -> "LWWSet":
        m = dict(self.entries)
        for e, sv in other.entries:
            cur = m.get(e)
            m[e] = sv if cur is None or cur < sv else cur
        return LWWSet(tuple(sorted(m.items(), key=lambda kv: repr(kv[0]))))


# ---------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EWFlag(DeltaCRDT):
    """Enable-wins flag (concurrent enable ∥ disable ⇒ enabled)."""

    store: DotSet = DotSet()
    ctx: CausalContext = CausalContext()

    @staticmethod
    def bottom() -> "EWFlag":
        return EWFlag()

    def read(self) -> bool:
        return bool(self.store.dots)

    def enable_delta(self, i: ReplicaId) -> "EWFlag":
        d = self.ctx.next_dot(i)
        # fresh dot survives; all old dots are covered (collapses siblings)
        return EWFlag(DotSet(frozenset([d])),
                      CausalContext.from_dots(list(self.store.dots) + [d]))

    def disable_delta(self, i: ReplicaId) -> "EWFlag":
        return EWFlag(DotSet(), CausalContext.from_dots(self.store.dots))

    def enable_full(self, i: ReplicaId) -> "EWFlag":
        return self.join(self.enable_delta(i))

    def disable_full(self, i: ReplicaId) -> "EWFlag":
        return self.join(self.disable_delta(i))

    def join(self, other: "EWFlag") -> "EWFlag":
        store, ctx = causal_join(self.store, self.ctx, other.store, other.ctx)
        return EWFlag(store, ctx)


@dataclass(frozen=True)
class DWFlag(DeltaCRDT):
    """Disable-wins flag: presence of a dot means *disabled*."""

    store: DotSet = DotSet()
    ctx: CausalContext = CausalContext()

    @staticmethod
    def bottom() -> "DWFlag":
        return DWFlag()

    def read(self) -> bool:
        return not self.store.dots

    def disable_delta(self, i: ReplicaId) -> "DWFlag":
        d = self.ctx.next_dot(i)
        return DWFlag(DotSet(frozenset([d])),
                      CausalContext.from_dots(list(self.store.dots) + [d]))

    def enable_delta(self, i: ReplicaId) -> "DWFlag":
        return DWFlag(DotSet(), CausalContext.from_dots(self.store.dots))

    def disable_full(self, i: ReplicaId) -> "DWFlag":
        return self.join(self.disable_delta(i))

    def enable_full(self, i: ReplicaId) -> "DWFlag":
        return self.join(self.enable_delta(i))

    def join(self, other: "DWFlag") -> "DWFlag":
        store, ctx = causal_join(self.store, self.ctx, other.store, other.ctx)
        return DWFlag(store, ctx)


# ---------------------------------------------------------------------------
# ORMap — composable map of causal CRDTs (the Riak-DT-Map shape, paper §1)
# ---------------------------------------------------------------------------

_CAUSAL_TYPES = (AWORSet, RWORSet, MVRegister, EWFlag, DWFlag)


@dataclass(frozen=True)
class ORMap(DeltaCRDT):
    """Observed-remove map: key → embedded causal δ-CRDT, shared context.

    ``apply_delta(i, key, f)`` lifts a delta-mutator of the embedded type;
    ``rmv_delta(i, key)`` deletes a key by covering all its dots (the
    embedded store becomes ⊥ at join time — observed-remove semantics).
    Values must be causal δ-CRDTs (AWORSet/RWORSet/MVRegister/flags/ORMap).
    """

    store: DotMap = DotMap()
    ctx: CausalContext = CausalContext()

    @staticmethod
    def bottom() -> "ORMap":
        return ORMap()

    def keys(self) -> FrozenSet[Any]:
        return frozenset(k for k, _ in self.store.entries)

    def get(self, key: Any, typ=None):
        """View of the embedded CRDT at ``key`` (with the shared context)."""
        sub = self.store.get(key, None)
        if sub is None:
            if typ is None:
                return None
            return typ.bottom()
        return self._wrap(sub)

    def _wrap(self, sub):
        if isinstance(sub, DotFun):
            raise TypeError("ambiguous DotFun embedding; use typed wrapper")
        return sub

    def get_value(self, key: Any, typ):
        """Typed read: returns an instance of ``typ`` sharing this map's ctx.

        Uses the store's keyed ``get`` (O(log n) on the columnar
        representation) rather than materializing ``as_dict`` — per-op
        delta mutators call this on every write."""
        sub = self.store.get(key, None)
        inner_store = sub if sub is not None else typ.bottom().store
        return typ(inner_store, self.ctx)

    def apply_delta(self, i: ReplicaId, key: Any, typ, mutator_name: str,
                    *args) -> "ORMap":
        """Run ``typ.<mutator_name>ᵟ`` on the embedded value, lift to a map delta."""
        cur = self.get_value(key, typ)
        sub_delta = getattr(cur, mutator_name)(i, *args)
        return ORMap(DotMap.of({key: sub_delta.store}), sub_delta.ctx)

    def rmv_delta(self, i: ReplicaId, key: Any) -> "ORMap":
        sub = self.store.get(key, None)
        dots = sub.all_dots() if sub is not None else frozenset()
        return ORMap(DotMap(), CausalContext.from_dots(dots))

    def apply_full(self, i: ReplicaId, key: Any, typ, mutator_name: str,
                   *args) -> "ORMap":
        """Standard (state-based) map mutator: mutate the embedded value in
        place — NOT defined via the delta join, so the decomposition law
        ``m(X) = X ⊔ mᵟ(X)`` is a real property for this type too."""
        cur = self.get_value(key, typ)
        full_name = mutator_name.replace("_delta", "_full")
        new_sub = getattr(cur, full_name)(i, *args)
        store = self.store.as_dict()
        if new_sub.store.is_bottom():
            store.pop(key, None)          # bottom payload ⇒ absent key
        else:
            store[key] = new_sub.store
        return ORMap(DotMap.of(store), self.ctx.join(new_sub.ctx))

    def rmv_full(self, i: ReplicaId, key: Any) -> "ORMap":
        return self.join(self.rmv_delta(i, key))

    def join(self, other: "ORMap") -> "ORMap":
        store, ctx = causal_join(self.store, self.ctx, other.store, other.ctx)
        return ORMap(store, ctx)


ALL_CRDT_TYPES = (GCounter, PNCounter, GSet, TwoPSet, AWORSetTombstone,
                  AWORSet, RWORSet, MVRegister, LWWRegister, LWWSet,
                  EWFlag, DWFlag, ORMap)

# Positional wire type-id registry for the dot-column store encoding
# (wire.codec _KIND_DOTSTORE bodies) and the causal digest section.
# Append-only: the index IS the on-wire type id.
CAUSAL_WIRE_TYPES = (AWORSet, RWORSet, MVRegister, EWFlag, DWFlag, ORMap)
