"""Elastic cluster membership + straggler mitigation, as δ-CRDTs.

The live-worker set is an **add-wins OR-Set** (paper §7): a pod that
rejoins after a partition wins over a stale eviction — exactly the add-wins
conflict policy wanted for elasticity. Heartbeats are per-worker monotone
LWW entries. Both pieces form a product lattice, so the whole cluster view
gossips through the same anti-entropy machinery as everything else, over
lossy links, with no coordinator.

Straggler policy: a worker whose heartbeat lags ``timeout`` behind the
observer's clock is a straggler; after ``evict_after`` it is removed from
the membership set (an observed-remove — concurrent rejoin wins). The
local-SGD layer simply stops waiting for contributions from workers outside
the live set (bounded-staleness barrier), which is the δ-CRDT version of
backup-worker straggler mitigation: progress never blocks on a slow pod,
and a late pod's dots still merge idempotently when they eventually arrive.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import (Callable, Dict, FrozenSet, Iterable, Optional, Sequence,
                    Tuple, Union)

from ..core.crdts import AWORSet, DeltaCRDT, LWWSet
from ..core.dots import ReplicaId
from ..core.propagation import Replica, ShippingPolicy
from ..core.store import LatticeStore
from ..topology import Topology


@dataclass(frozen=True)
class HeartbeatMap(DeltaCRDT):
    """worker → monotone max timestamp (grow-only pointwise-max map)."""

    entries: Tuple[Tuple[ReplicaId, float], ...] = ()

    @staticmethod
    def bottom() -> "HeartbeatMap":
        return HeartbeatMap()

    def beat_delta(self, worker: ReplicaId, ts: float) -> "HeartbeatMap":
        return HeartbeatMap(((worker, ts),))

    def beat_full(self, worker: ReplicaId, ts: float) -> "HeartbeatMap":
        return self.join(self.beat_delta(worker, ts))

    def last_seen(self, worker: ReplicaId) -> float:
        return dict(self.entries).get(worker, float("-inf"))

    def join(self, other: "HeartbeatMap") -> "HeartbeatMap":
        m = dict(self.entries)
        for w, ts in other.entries:
            m[w] = max(m.get(w, float("-inf")), ts)
        return HeartbeatMap(tuple(sorted(m.items())))


@dataclass(frozen=True)
class ClusterState(DeltaCRDT):
    """Product lattice: membership OR-Set × heartbeat map."""

    members: AWORSet = AWORSet()
    heartbeats: HeartbeatMap = HeartbeatMap()

    @staticmethod
    def bottom() -> "ClusterState":
        return ClusterState()

    def join(self, other: "ClusterState") -> "ClusterState":
        return ClusterState(self.members.join(other.members),
                            self.heartbeats.join(other.heartbeats))

    # -- delta-mutators --------------------------------------------------------
    def join_delta(self, i: ReplicaId, worker: ReplicaId,
                   ts: float) -> "ClusterState":
        return ClusterState(self.members.add_delta(i, worker),
                            self.heartbeats.beat_delta(worker, ts))

    def leave_delta(self, i: ReplicaId, worker: ReplicaId) -> "ClusterState":
        return ClusterState(self.members.rmv_delta(i, worker),
                            HeartbeatMap.bottom())

    def beat_delta(self, worker: ReplicaId, ts: float) -> "ClusterState":
        return ClusterState(AWORSet.bottom(),
                            self.heartbeats.beat_delta(worker, ts))

    # -- queries -------------------------------------------------------------
    def workers(self) -> FrozenSet[ReplicaId]:
        return self.members.elements()

    def alive(self, now: float, timeout: float) -> FrozenSet[ReplicaId]:
        return frozenset(w for w in self.workers()
                         if now - self.heartbeats.last_seen(w) <= timeout)

    def stragglers(self, now: float, timeout: float) -> FrozenSet[ReplicaId]:
        return self.workers() - self.alive(now, timeout)


class Membership:
    """Local membership agent for one pod: wraps delta-mutations so the
    surrounding anti-entropy node (Basic/Causal) can gossip them."""

    def __init__(self, self_id: ReplicaId, timeout: float = 30.0,
                 evict_after: float = 90.0):
        self.self_id = self_id
        self.timeout = timeout
        self.evict_after = evict_after

    def announce(self, state: ClusterState, now: float) -> ClusterState:
        return state.join_delta(self.self_id, self.self_id, now)

    def heartbeat(self, state: ClusterState, now: float) -> ClusterState:
        return state.beat_delta(self.self_id, now)

    def stale(self, state: ClusterState, now: float) -> FrozenSet[ReplicaId]:
        """Workers (other than self) silent for ≥ evict_after."""
        return frozenset(
            w for w in state.workers()
            if w != self.self_id
            and now - state.heartbeats.last_seen(w) >= self.evict_after)

    def evictions(self, state: ClusterState, now: float) -> ClusterState:
        """Delta that removes every worker silent for ≥ evict_after."""
        delta = ClusterState.bottom()
        for w in self.stale(state, now):
            delta = delta.join(state.leave_delta(self.self_id, w))
        return delta

    def quorum(self, state: ClusterState, now: float,
               fraction: float = 0.5) -> FrozenSet[ReplicaId]:
        """The bounded-staleness barrier set: contributions awaited only
        from currently-alive workers (straggler mitigation)."""
        alive = state.alive(now, self.timeout)
        need = max(1, int(len(state.workers()) * fraction))
        return alive if len(alive) >= need else frozenset()


# ---------------------------------------------------------------------------
# Hash-sharded key ownership (rendezvous hashing over the live worker set)
# ---------------------------------------------------------------------------

def rendezvous_score(worker: ReplicaId, key: str) -> int:
    """Deterministic, process-independent score of ``worker`` for ``key``
    (highest-random-weight / rendezvous hashing). blake2b, not ``hash()``:
    the builtin is salted per process, which would shard every replica
    differently."""
    h = hashlib.blake2b(f"{worker}\x00{key}".encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def owners_for_key(key: str, workers: Iterable[ReplicaId],
                   replication: int = 1) -> Tuple[ReplicaId, ...]:
    """The ``replication`` highest-scoring live workers for ``key``.

    Rendezvous hashing gives minimal disruption under elasticity: a
    worker joining or leaving only moves the keys it scores highest on
    (expected 1/n of the keyspace) — every other key keeps its owners.
    """
    ranked = sorted(workers, key=lambda w: (-rendezvous_score(w, key), w))
    return tuple(ranked[:max(1, replication)])


class KeyOwnership:
    """Key → replica-set assignment over a (possibly live) worker set.

    ``workers`` is either a static iterable of worker ids or a callable
    returning the current set — pass e.g.
    ``lambda: cluster_replica.X.workers()`` so ownership re-shuffles as
    the gossiped membership OR-Set changes (join/leave), with rendezvous
    hashing keeping the re-shuffle minimal. ``replication`` is the number
    of replicas per key (the key's **write** replica set = its owners).

    The *read* set is wider: ``read_replication`` statically extends
    every key's readers to the next rendezvous-ranked workers, and
    :meth:`subscribe` dynamically adds a specific worker to a specific
    hot key's readers. Readers receive the key's gossip through
    digest-sync pull (``ShardByKey.restrict_pull`` routes by
    ``reads``), but stay out of the write set — they are not pushed to,
    never buffer/forward the key, and never gate its reap quorum.

    ``topology`` (a :class:`repro_torch.topology.Topology`) turns on
    **zone-spreading**: whenever the cluster spans ≥ 2 zones and
    ``replication ≥ 2``, a key's write set is forced across ≥ 2 failure
    domains — the rendezvous prefix keeps its first ``replication - 1``
    slots, and if the whole prefix landed in one zone the *last* slot is
    swapped for the highest-ranked worker of any other zone. Read
    extension becomes zone-coverage-greedy: the extra
    ``read_replication`` slots first place a replica in each not-yet-
    covered zone (in rank order), then fill by rank — so every zone
    prefers a zone-local read replica. With one zone (or no topology)
    the ranking is *exactly* the flat rendezvous order, and reshuffle
    under join/leave stays minimal: a key's write set changes only when
    the changed worker sits in the rendezvous prefix or in the write set
    itself (the swap target is itself rank-maximal among its zone)."""

    _CACHE_MAX = 1 << 16    # bound the per-key memo (serving keyspaces
                            # are unbounded; rendezvous recompute is cheap)

    def __init__(self, workers: Union[Iterable[ReplicaId],
                                      Callable[[], Iterable[ReplicaId]]],
                 replication: int = 1,
                 read_replication: Optional[int] = None,
                 topology: Optional[Topology] = None):
        if replication < 1:
            raise ValueError(f"replication must be ≥ 1, got {replication}")
        if read_replication is not None and read_replication < replication:
            raise ValueError(
                f"read_replication must be ≥ replication "
                f"({replication}), got {read_replication}")
        self._workers = workers
        self.replication = replication
        self.read_replication = (replication if read_replication is None
                                 else read_replication)
        self.topology = topology
        # owners() sits on the gossip hot path (ShardByKey consults it per
        # key per destination per round): memoize the read-width ranking
        # per key (owners = its prefix), invalidated whenever the live
        # worker set changes
        self._cache_workers: Tuple[ReplicaId, ...] = ()
        self._cache: Dict[str, Tuple[ReplicaId, ...]] = {}
        # dynamic hot-key subscriptions: key → workers that asked to read
        self._subs: Dict[str, set] = {}

    def workers(self) -> Tuple[ReplicaId, ...]:
        ws = self._workers() if callable(self._workers) else self._workers
        return tuple(sorted(ws))

    def _rank_among(self, key: str,
                    ws: Tuple[ReplicaId, ...]) -> Tuple[ReplicaId, ...]:
        """The read-width, zone-aware ranking of ``ws`` for ``key`` —
        the write set is its ``replication`` prefix. Pure function of
        (key, worker snapshot), so :class:`RebalanceHandoff` can replay
        it against the *previous* worker set."""
        width = self.read_replication
        ranked = sorted(ws, key=lambda w: (-rendezvous_score(w, key), w))
        topo = self.topology
        if topo is None:
            return tuple(ranked[:width])
        zone = {w: topo.zone(w) for w in ranked}
        if len(set(zone.values())) < 2:
            return tuple(ranked[:width])   # one zone ⇒ exactly flat
        r = self.replication
        write = ranked[:r]
        if r >= 2 and len({zone[w] for w in write}) < 2:
            # single-zone prefix: the last slot yields to the highest-
            # ranked worker of any other zone (≥ 2 failure domains)
            swap = next(w for w in ranked[r:] if zone[w] != zone[write[0]])
            write = write[:-1] + [swap]
        out = list(write)
        covered = {zone[w] for w in out}
        rest = [w for w in ranked if w not in out]
        for w in rest:                     # zone-coverage-greedy readers
            if len(out) >= width:
                break
            if zone[w] not in covered:
                out.append(w)
                covered.add(zone[w])
        for w in rest:                     # then fill by rank
            if len(out) >= width:
                break
            if w not in out:
                out.append(w)
        return tuple(out)

    def _ranked(self, key: str) -> Tuple[ReplicaId, ...]:
        ws = self.workers()
        if ws != self._cache_workers:
            self._cache_workers = ws       # membership changed: re-shuffle
            self._cache = {}
        hit = self._cache.get(key)
        if hit is None:
            hit = self._rank_among(key, ws) if ws else ()
            if len(self._cache) >= self._CACHE_MAX:
                self._cache.clear()
            self._cache[key] = hit
        return hit

    def owners(self, key: str) -> Tuple[ReplicaId, ...]:
        return self._ranked(key)[:self.replication]

    def owners_among(self, key: str, workers: Iterable[ReplicaId]
                     ) -> Tuple[ReplicaId, ...]:
        """The write set ``key`` *would* have over an arbitrary worker
        snapshot — same zone-spread rule, no cache. Rebalance uses this
        to recover a key's owners under the previous membership."""
        ws = tuple(sorted(workers))
        if not ws:
            return ()
        return self._rank_among(key, ws)[:self.replication]

    def owner(self, key: str) -> Optional[ReplicaId]:
        """The primary (top-scoring) owner, or None with no workers."""
        owners = self.owners(key)
        return owners[0] if owners else None

    def replicates(self, worker: ReplicaId, key: str) -> bool:
        return worker in self.owners(key)

    # -- the wider read set ------------------------------------------------------
    def subscribe(self, worker: ReplicaId, key: str) -> None:
        """Add ``worker`` to ``key``'s readers (a hot key it wants to
        serve locally). Pull responses start routing the key to it on
        the next digest exchange; nothing else changes — no write-set
        membership, no reap-quorum seat."""
        self._subs.setdefault(key, set()).add(worker)

    def unsubscribe(self, worker: ReplicaId, key: str) -> None:
        subs = self._subs.get(key)
        if subs is not None:
            subs.discard(worker)
            if not subs:
                del self._subs[key]

    def readers(self, key: str) -> Tuple[ReplicaId, ...]:
        """The key's read set: the write owners, the statically wider
        ``read_replication`` rank prefix, and any live subscribers."""
        ranked = self._ranked(key)
        subs = self._subs.get(key)
        if not subs:
            return ranked
        live = set(self.workers())
        extra = sorted(w for w in subs if w in live and w not in ranked)
        return ranked + tuple(extra)

    def reads(self, worker: ReplicaId, key: str) -> bool:
        return worker in self.readers(key)

    # -- zone relays (hierarchical gossip aggregation) -----------------------------
    def relays(self) -> Dict[str, ReplicaId]:
        """zone → its elected relay over the current worker set (empty
        without a topology)."""
        if self.topology is None:
            return {}
        ws = self.workers()
        return {z: r for z in self.topology.zone_names(ws)
                if (r := self.topology.relay(z, ws)) is not None}

    def _relay_reads(self, worker: ReplicaId, key: str) -> bool:
        """Is ``worker`` its zone's elected relay AND does anyone in
        that zone read ``key``? The aggregation rule of hierarchical
        gossip: a relay carries its whole zone's read interest across
        the zone boundary."""
        topo = self.topology
        if topo is None:
            return False
        ws = self.workers()
        z = topo.zone(worker)
        if topo.relay(z, ws) != worker:
            return False
        return any(self.reads(m, key) for m in topo.members(z, ws))

    def buffers(self, worker: ReplicaId, key: str) -> bool:
        """May ``worker`` buffer/forward ``key``'s received deltas?
        Owners always; additionally its zone's relay buffers any key a
        zone-mate reads, so rows pulled across the zone boundary survive
        long enough to be pushed on to the zone (Def. 6 makes the extra
        forwarding join-equivalent — it can only deliver sooner)."""
        return self.replicates(worker, key) or self._relay_reads(worker, key)

    def routes_pull(self, worker: ReplicaId, key: str) -> bool:
        """Does a digest response to ``worker`` carry ``key``? Readers
        always; additionally a zone relay pulls on behalf of every
        zone-mate's read set — the responder cannot see *why* a relay
        asks, so the aggregated interest lives here, in the ownership
        map both sides share."""
        return self.reads(worker, key) or self._relay_reads(worker, key)


class ShardByKey(ShippingPolicy):
    """Ship each key's deltas only to the replicas that own/replicate it.

    ``include`` drops buffered store entries carrying nothing the
    destination replicates; ``finalize`` restricts every outgoing store
    payload (delta-interval joins AND full-state fallbacks) to the
    destination's shard, so bytes shipped per round scale with the keys a
    peer replicates, not with store size. Non-store payloads pass through
    (the policy composes with single-object replicas as a no-op).

    Sharding intentionally relaxes *global* convergence to *per-key*
    convergence across each key's replica set — a destination never
    receives keys outside its shard, so whole-store equality across all
    replicas no longer holds (and ``ghost_check``, which asserts exactly
    that equivalence, must stay off). Acks remain truthful for the shard
    the receiver is responsible for, which is all it serves.

    Push traffic routes by the **write** set (``replicates``); pull
    responses route by the wider **read** set (``reads``) — that split
    is what makes read replicas work: a subscriber's digest request
    comes back with its hot keys' rows, while nobody ever pushes to it
    or waits on it. Key enumeration uses ``all_keys()``, so lifecycle
    tombstones (which hold no value) shard, ship, and hand off exactly
    like values — a reaped key must reach its whole replica set or
    stragglers could resurrect it.
    """

    def __init__(self, ownership: KeyOwnership):
        self.ownership = ownership
        self.name = f"shard:{ownership.replication}"

    def _dst_keys(self, dst: ReplicaId, store: LatticeStore):
        # Push routes by the destination's *buffer* set: identical to
        # ``replicates`` on a flat topology, but under a zoned one it
        # additionally lets a zone relay accept (and re-push) the keys
        # its zone-mates read, which is how a delta born in a zone with
        # no other owner of its key reaches the key's remote replicas
        # without any cross-zone fanout.
        may = getattr(self.ownership, "buffers", None)
        route = may if may is not None else self.ownership.replicates
        return [k for k in store.all_keys() if route(dst, k)]

    def include(self, replica, dst, index, entry) -> bool:
        if not isinstance(entry.delta, LatticeStore):
            return True
        return bool(self._dst_keys(dst, entry.delta))

    def finalize(self, replica, dst, payload):
        if not isinstance(payload, LatticeStore):
            return payload
        return payload.restrict(self._dst_keys(dst, payload))

    def credit(self, replica, dst, delta):
        """Unlike BP/RR, this policy withholds state the receiver does
        NOT hold (keys outside its shard), so acked buffered entries may
        only be credited to the receiver's known-state bound after the
        same restriction — otherwise keys that later move into the shard
        look 'already delivered' and RR trims them out of the full-state
        fallback forever."""
        if not isinstance(delta, LatticeStore):
            return delta
        return delta.restrict(self._dst_keys(dst, delta))

    def restrict_pull(self, replica, dst, store):
        """Digest responses route by the READ set: a requester receives
        the keys it replicates *or subscribes to* (a pure routing
        restriction, which is all the pull hook permits) — this is the
        entire transport story of read replicas. Under a zoned topology
        the route widens to ``routes_pull``: a zone relay's request also
        pulls every key its zone-mates read (cross-zone aggregation)."""
        if not isinstance(store, LatticeStore):
            return store
        routes = getattr(self.ownership, "routes_pull",
                         self.ownership.reads)
        return store.restrict(k for k in store.all_keys()
                              if routes(dst, k))


class RebalanceHandoff:
    """Rebalance-aware handoff: push moved keys instead of waiting.

    When the live worker set changes, rendezvous hashing moves ~1/n of
    the keyspace to new owners. Organic anti-entropy eventually delivers
    those keys (``ShardByKey`` starts routing them on the next rounds),
    but a fresh owner serves ⊥ until its first delta-interval lands —
    and under ``bp+rr`` a long-converged key generates no new deltas at
    all until someone writes it, so the wait is unbounded. This agent
    closes the gap: it watches the ownership's worker set, and on a
    change each **old** owner immediately pushes every moved key's
    full-state delta to each **new** owner it gained (a ``handoff``
    frame under the wire codec). The push is a plain join — idempotent,
    unacked, safe under loss/duplication — so organic anti-entropy
    remains the convergence safety net and the merging condition is
    untouched (handoffs bypass the interval machinery entirely on the
    send side; the receiver buffers them like any received delta so it
    can forward).

    Call :meth:`check` after membership events (or periodically — it is
    a no-op while the worker set is stable). Keys are batched per
    destination into ONE store payload per push.
    """

    def __init__(self, replica: Replica, ownership: KeyOwnership):
        self.replica = replica
        self.ownership = ownership
        self._workers: Tuple[ReplicaId, ...] = ownership.workers()

    def check(self) -> int:
        """Detect a worker-set change and push moved keys; returns the
        number of handoff messages sent."""
        cur = self.ownership.workers()
        if cur == self._workers:
            return 0
        prev, self._workers = self._workers, cur
        store = self.replica.X
        if not isinstance(store, LatticeStore):
            return 0
        # receiver-state bounds were derived under the old shard map;
        # dropping them is always sound (an under-approximation may only
        # shrink — RR briefly trims less). _inflight is kept: it records
        # the exact payloads that were shipped, which is precisely what
        # acks in flight across the change should credit.
        self.replica._known.clear()
        by_dst: Dict[ReplicaId, list] = {}
        for key in store.all_keys():    # tombstones hand off like values
            # replay the ownership's own (possibly zone-aware) rule over
            # the previous snapshot — flat owners_for_key would disagree
            # with a zone-spread write set and mis-assign the pusher role
            old = (self.ownership.owners_among(key, prev) if prev else ())
            if self.replica.id not in old:
                continue              # only a key's old owners push it
            for dst in self.ownership.owners(key):
                if dst not in old and dst != self.replica.id:
                    by_dst.setdefault(dst, []).append(key)
        for dst, keys in by_dst.items():
            self.replica.push_handoff(dst, store.restrict(keys))
        return len(by_dst)


class ClusterReplica(Replica):
    """One pod's cluster-view replica on the unified propagation runtime:
    the :class:`Membership` agent's delta-mutations gossip through the same
    ``Replica`` engine (Algorithm 2 + pluggable shipping policy) as every
    other lattice. On a full mesh, ``AvoidBackPropagation`` +
    ``RemoveRedundant`` keep heartbeat chatter from echoing back to its
    producer or re-shipping state the receiver already acked."""

    def __init__(self, node_id: ReplicaId, neighbors: Sequence[ReplicaId],
                 *, policy: Optional[ShippingPolicy] = None,
                 rng: Optional[random.Random] = None,
                 timeout: float = 30.0, evict_after: float = 90.0,
                 wire: Optional[object] = None):
        super().__init__(node_id, ClusterState.bottom(), neighbors,
                         causal=True, policy=policy, rng=rng, wire=wire)
        self.agent = Membership(node_id, timeout=timeout,
                                evict_after=evict_after)

    # -- delta-mutations through the engine -----------------------------------
    def announce(self, now: float) -> None:
        self.operation(lambda X: self.agent.announce(X, now))

    def heartbeat(self, now: float) -> None:
        self.operation(lambda X: self.agent.heartbeat(X, now))

    def evict_stragglers(self, now: float) -> FrozenSet[ReplicaId]:
        """Record an eviction delta for every worker silent ≥ evict_after;
        returns the set evicted by this call."""
        doomed = self.agent.stale(self.X, now)
        if doomed:
            self.operation(lambda X: self.agent.evictions(X, now))
        return doomed

    # -- queries over the replicated view --------------------------------------
    def alive_workers(self, now: float) -> FrozenSet[ReplicaId]:
        return self.X.alive(now, self.agent.timeout)

    def quorum(self, now: float, fraction: float = 0.5) -> FrozenSet[ReplicaId]:
        return self.agent.quorum(self.X, now, fraction)
