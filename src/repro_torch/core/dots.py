"""Dots, causal contexts, and dot stores — the meta-data substrate of δ-CRDTs.

This module implements:

* ``Dot`` — a globally-unique event tag ``(replica_id, counter)`` from 𝕀 × ℕ
  (paper §7.1: "Globally unique tags of the form 𝕀 × ℕ").
* ``CausalContext`` — the set ``c`` of Fig. 3b/4, with the compression of
  §7.2 ("Causal Context Compression"): a version vector encoding the
  contiguous prefix of tags per replica, plus a *dot cloud* for the
  non-contiguous tags that appear under non-causal anti-entropy. As
  anti-entropy proceeds each cloud dot is eventually absorbed into the
  vector, so the cloud remains small.
* Dot stores (``DotSet``, ``DotFun``, ``DotMap``) and the *causal join*,
  the generic form of the join in Fig. 3b/4:

      (s, c) ⊔ (s', c') = ((s ∩ s') ∪ {d ∈ s | d ∉ c'} ∪ {d ∈ s' | d ∉ c},
                           c ∪ c')

  i.e. keep events seen by both, or seen by one and *not yet observed*
  (not in the causal context) by the other. Observed-but-absent ⇒ deleted.

These structures are plain immutable Python values so that the lattice laws
(commutativity / associativity / idempotence) can be property-tested
directly with hypothesis, and so that simulator state snapshots are cheap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Iterable, Mapping, Optional, Tuple

ReplicaId = str
Dot = Tuple[ReplicaId, int]  # (replica id, 1-based counter)

# guard for CausalContext.dots(): materializing is O(total events), so
# it is reserved for tests/debug on small contexts (see its docstring)
_DOTS_MATERIALIZE_LIMIT = 1 << 16


def _freeze_vv(vv: Mapping[ReplicaId, int]) -> Tuple[Tuple[ReplicaId, int], ...]:
    return tuple(sorted((i, n) for i, n in vv.items() if n > 0))


@dataclass(frozen=True)
class CausalContext:
    """Compressed causal context: version-vector prefix + sparse dot cloud.

    Invariant (enforced by ``_normalize``): for every replica ``i`` the dots
    ``(i, 1) .. (i, vv[i])`` are contained, and the cloud holds only dots
    ``(i, k)`` with ``k > vv[i] + 1`` or gaps above the prefix (never dots
    already covered by the prefix, and never the dot that would extend it).
    """

    vv: Tuple[Tuple[ReplicaId, int], ...] = ()
    cloud: FrozenSet[Dot] = frozenset()

    # -- constructors -------------------------------------------------------
    @staticmethod
    def bottom() -> "CausalContext":
        return _CC_BOTTOM

    @staticmethod
    def from_dots(dots: Iterable[Dot]) -> "CausalContext":
        return CausalContext().add_dots(dots)

    @staticmethod
    def from_vv(vv: Mapping[ReplicaId, int]) -> "CausalContext":
        return CausalContext(vv=_freeze_vv(vv))

    # -- queries -------------------------------------------------------------
    def vv_dict(self) -> Dict[ReplicaId, int]:
        return dict(self.vv)

    def contains(self, dot: Dot) -> bool:
        i, n = dot
        if n <= 0:
            return True
        if n <= dict(self.vv).get(i, 0):
            return True
        return dot in self.cloud

    def max_for(self, i: ReplicaId) -> int:
        """max{k | (i,k) ∈ c}, 0 if none (paper: max(∅) = 0)."""
        base = dict(self.vv).get(i, 0)
        cloud_max = max((k for (j, k) in self.cloud if j == i), default=0)
        return max(base, cloud_max)

    def next_dot(self, i: ReplicaId) -> Dot:
        """The next unique tag for replica ``i`` (Fig. 3b: n+1 with
        n = max{k | (i,k) ∈ c})."""
        return (i, self.max_for(i) + 1)

    def dots(self) -> FrozenSet[Dot]:
        """Explicit dot set — **test/debug only**. Materializing every
        covered dot is O(total events) and is exactly what the §7.2
        compression exists to avoid; no engine path may call this
        (audited: only tests do). Bulk consumers should iterate ``vv``
        and ``cloud``, or use :mod:`repro_torch.core.dotcols` columns."""
        total = sum(n for _, n in self.vv) + len(self.cloud)
        assert total <= _DOTS_MATERIALIZE_LIMIT, (
            f"CausalContext.dots() would materialize {total} dots "
            f"(> {_DOTS_MATERIALIZE_LIMIT}); it is a test/debug helper — "
            "iterate vv/cloud or use repro_torch.core.dotcols for bulk work")
        out = set(self.cloud)
        for i, n in self.vv:
            out.update((i, k) for k in range(1, n + 1))
        return frozenset(out)

    # -- mutation (functional) ------------------------------------------------
    def add_dot(self, dot: Dot) -> "CausalContext":
        return self.add_dots((dot,))

    def add_dots(self, dots: Iterable[Dot]) -> "CausalContext":
        ds = dots if isinstance(dots, (tuple, list)) else tuple(dots)
        if not ds:
            return self
        # Contiguous-append fast path: per-op δ-mutators add exactly the
        # next dot per replica, so the common case extends vv prefixes
        # in place — no dict+set copy of the cloud and no per-replica
        # re-sort in _normalize. Only safe when the cloud holds nothing
        # for the touched replicas (an extension could absorb it).
        touched = {i for i, _ in ds}
        if not any(i in touched for i, _ in self.cloud):
            vv = dict(self.vv)
            for i, n in ds:
                cur = vv.get(i, 0)
                if n == cur + 1:
                    vv[i] = n
                elif n > cur:
                    break              # gap above the prefix: cloud path
            else:
                return CausalContext(vv=_freeze_vv(vv), cloud=self.cloud)
        vv = dict(self.vv)
        cloud = set(self.cloud)
        for d in ds:
            i, n = d
            if n > vv.get(i, 0):
                cloud.add(d)
        return _normalize(vv, cloud)

    def join(self, other: "CausalContext") -> "CausalContext":
        """c ∪ c' (then re-compressed)."""
        vv = dict(self.vv)
        for i, n in other.vv:
            vv[i] = max(vv.get(i, 0), n)
        cloud = set(self.cloud) | set(other.cloud)
        return _normalize(vv, cloud)

    def leq(self, other: "CausalContext") -> bool:
        """Direct dominance check, equivalent to the lattice definition
        ``other.join(self) == other`` but without allocating and
        re-normalizing a joined context per comparison. Relies on the
        normalization invariant: ``other``'s cloud never holds the dot
        that would extend a vv prefix, so a prefix of ``self`` that
        exceeds ``other``'s vv cannot be covered by ``other``'s cloud."""
        ovv = dict(other.vv)
        if any(n > ovv.get(i, 0) for i, n in self.vv):
            return False
        oc = other.cloud
        return all(k <= ovv.get(i, 0) or (i, k) in oc
                   for i, k in self.cloud)

    def __le__(self, other: "CausalContext") -> bool:  # pragma: no cover
        return self.leq(other)


def _normalize(vv: Dict[ReplicaId, int], cloud: set) -> CausalContext:
    """Absorb contiguous cloud dots into the version-vector prefix (§7.2)."""
    by_rep: Dict[ReplicaId, list] = {}
    for (i, n) in cloud:
        by_rep.setdefault(i, []).append(n)
    out_cloud = set()
    for i, ks in by_rep.items():
        base = vv.get(i, 0)
        for k in sorted(set(ks)):
            if k <= base:
                continue  # already covered
            if k == base + 1:
                base = k  # extend the contiguous prefix
            else:
                out_cloud.add((i, k))
        if base > 0:
            vv[i] = base
    return CausalContext(vv=_freeze_vv(vv), cloud=frozenset(out_cloud))


_CC_BOTTOM = CausalContext()


# ---------------------------------------------------------------------------
# Dot stores
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DotSet:
    """A set of dots (the store behind flags and the tag component of sets)."""

    dots: FrozenSet[Dot] = frozenset()

    @staticmethod
    def bottom() -> "DotSet":
        return DotSet()

    def is_bottom(self) -> bool:
        return not self.dots

    def all_dots(self) -> FrozenSet[Dot]:
        return self.dots

    def causal_join(self, c: CausalContext, other: "DotSet",
                    c_other: CausalContext) -> "DotSet":
        keep = (self.dots & other.dots)
        keep |= {d for d in self.dots if not c_other.contains(d)}
        keep |= {d for d in other.dots if not c.contains(d)}
        return DotSet(frozenset(keep))


@dataclass(frozen=True)
class DotFun:
    """A map dot → value (MVRegister payloads, tagged set elements)."""

    entries: Tuple[Tuple[Dot, Any], ...] = ()

    @staticmethod
    def bottom() -> "DotFun":
        return DotFun()

    @staticmethod
    def of(mapping: Mapping[Dot, Any]) -> "DotFun":
        return DotFun(tuple(sorted(mapping.items())))

    def as_dict(self) -> Dict[Dot, Any]:
        return dict(self.entries)

    def is_bottom(self) -> bool:
        return not self.entries

    def all_dots(self) -> FrozenSet[Dot]:
        return frozenset(d for d, _ in self.entries)

    def values(self) -> Tuple[Any, ...]:
        return tuple(v for _, v in self.entries)

    def causal_join(self, c: CausalContext, other: "DotFun",
                    c_other: CausalContext) -> "DotFun":
        a, b = self.as_dict(), other.as_dict()
        out: Dict[Dot, Any] = {}
        for d, v in a.items():
            if d in b or not c_other.contains(d):
                out[d] = v
        for d, v in b.items():
            if d not in a and not c.contains(d):
                out[d] = v
        return DotFun.of(out)


@dataclass(frozen=True)
class DotMap:
    """A map key → dot store (recursively composable — the Riak-Map shape).

    The causal join is applied pointwise with the *shared* causal contexts;
    keys whose joined sub-store is ⊥ disappear (observed-remove semantics).
    """

    entries: Tuple[Tuple[Any, Any], ...] = ()  # key -> DotSet|DotFun|DotMap

    @staticmethod
    def bottom() -> "DotMap":
        return DotMap()

    @staticmethod
    def of(mapping: Mapping[Any, Any]) -> "DotMap":
        return DotMap(tuple(sorted(mapping.items(), key=lambda kv: repr(kv[0]))))

    def as_dict(self) -> Dict[Any, Any]:
        return dict(self.entries)

    def is_bottom(self) -> bool:
        return not self.entries

    def all_dots(self) -> FrozenSet[Dot]:
        out: set = set()
        for _, store in self.entries:
            out |= store.all_dots()
        return frozenset(out)

    def get(self, key: Any, default: Any) -> Any:
        return self.as_dict().get(key, default)

    def causal_join(self, c: CausalContext, other: "DotMap",
                    c_other: CausalContext) -> "DotMap":
        a, b = self.as_dict(), other.as_dict()
        out: Dict[Any, Any] = {}
        for k in set(a) | set(b):
            sa = a.get(k)
            sb = b.get(k)
            if sa is None:
                sa = type(sb).bottom()
            if sb is None:
                sb = type(sa).bottom()
            joined = sa.causal_join(c, sb, c_other)
            if not joined.is_bottom():
                out[k] = joined
        return DotMap.of(out)


def causal_join(store_a, ctx_a: CausalContext, store_b, ctx_b: CausalContext):
    """Join two causal states ((store, ctx) pairs); returns (store, ctx).

    Dispatch point for the dual representation: when either side is
    columnar (:mod:`repro_torch.core.dotcols`), the join runs vectorized and
    the result stays columnar; pure-object joins keep the paper-shaped
    path below, which doubles as the oracle the columnar path is
    property-tested against.
    """
    if (getattr(store_a, "columnar", False)
            or getattr(store_b, "columnar", False)):
        from . import dotcols
        return dotcols.causal_join_cols(store_a, ctx_a, store_b, ctx_b)
    return store_a.causal_join(ctx_a, store_b, ctx_b), ctx_a.join(ctx_b)
