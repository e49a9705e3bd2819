"""Derived probes: convergence-lag and engine-health gauges.

The absorbers in :mod:`repro_torch.obs.registry` mirror counters that already
exist; the probes compute the quantities 1803.02750 actually argues
about — how far behind each peer is, how long a write takes to be safe,
whether the reaper's quorums are making progress:

* :class:`ReplicaProbes` — per-peer delta-buffer and ack-horizon health
  read straight off a live :class:`~repro_torch.core.propagation.Replica`:
  buffer depth, the GC horizon and its *age* (entries the slowest peer
  has not acknowledged — the quantity that pins buffer memory), per-peer
  unacked-entry counts, the in-flight/ack credit balance
  (``_inflight`` records awaiting acknowledgment), and reap-quorum
  progress (pending proposals, outstanding votes, committed/evicted
  totals) when a reaper is attached.
* :class:`AckLagProbe` — write→fully-acked latency: :meth:`note_write`
  stamps each local δ-mutation's counter tag; a poll (every scrape, or
  every tick via :meth:`poll`) resolves tags once every *push peer's*
  cumulative ack has passed them and feeds the latency histogram. This
  is the locally-measurable replication-lag signal: a fully-acked write
  is durable at every push peer, so it upper-bounds visibility lag on
  the push set without writing any probe keys into the store (a socket
  cluster's key set is workload state — bench_net asserts on it).
* :func:`marker_lag_histogram` — the cross-process marker technique's
  home: ``bench_net``'s UDP load generator writes marker keys and polls
  the *read side* for visibility; the measured write→visible-everywhere
  latencies feed this histogram, giving the scrape surface true
  end-to-end per-key replication lag where a read set is observable.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Optional, Tuple

from .registry import Histogram, Registry

LAG_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
               5.0, 10.0, 30.0)


def marker_lag_histogram(registry: Registry, *, node: str = "") -> Any:
    """The per-key replication-lag histogram (marker technique): callers
    observe write→visible-on-read-set seconds into the returned child."""
    return registry.histogram(
        "repro_marker_lag_seconds",
        "per-key write→visible-on-read-set replication lag "
        "(marker technique)",
        ("node",), buckets=LAG_BUCKETS).labels(node)


class ReplicaProbes:
    """Collect-time gauges over one replica's engine state.

    Registers a single collector; every scrape reads the live maps
    (``entries``, ``A``, ``_basic_sent``, ``_inflight``, the reaper's
    ``_pending``) — the engine's hot path is untouched.
    """

    def __init__(self, registry: Registry, replica: Any, *,
                 node: Optional[str] = None):
        self.replica = replica
        node = node if node is not None else replica.id
        depth = registry.gauge("repro_replica_delta_buffer_depth",
                               "buffered delta entries", ("node",))
        counter = registry.gauge("repro_replica_counter",
                                 "the causal counter c", ("node",))
        rounds = registry.counter("repro_replica_rounds_total",
                                  "anti-entropy rounds run", ("node",))
        horizon = registry.gauge("repro_replica_gc_horizon",
                                 "entry index every push peer has "
                                 "passed (acks / basic watermarks)",
                                 ("node",))
        horizon_age = registry.gauge(
            "repro_replica_gc_horizon_age",
            "entries above the GC horizon — what the slowest push peer "
            "pins in memory", ("node",))
        unacked = registry.gauge("repro_replica_unacked_entries",
                                 "entries this peer has not acked "
                                 "(c - A[peer]; basic mode: c - "
                                 "broadcast watermark)", ("node", "peer"))
        inflight = registry.gauge(
            "repro_replica_inflight",
            "remembered in-flight payloads awaiting this peer's ack "
            "(the ack credit balance)", ("node", "peer"))
        tomb = registry.gauge("repro_replica_tombstoned_keys",
                              "keys held only as tombstones", ("node",))
        reap_pending = registry.gauge("repro_reap_pending",
                                      "open reap proposals", ("node",))
        reap_votes = registry.gauge(
            "repro_reap_votes_outstanding",
            "quorum votes still missing across open proposals",
            ("node",))
        reap_committed = registry.counter("repro_reap_committed_total",
                                          "tombstones committed",
                                          ("node",))
        reap_evicted = registry.counter("repro_reap_evicted_total",
                                        "foreign expired copies shed",
                                        ("node",))

        def collect() -> None:
            r = self.replica
            depth.labels(node).set(len(r.entries))
            counter.labels(node).set(r.c)
            rounds.labels(node).set_total(r.rounds)
            peers = r.policy.ack_peers(r, list(r.neighbors))
            marks = r.A if r.causal else r._basic_sent
            for j in peers:
                unacked.labels(node, j).set(r.c - marks.get(j, 0))
            h = min((marks.get(j, 0) for j in peers), default=r.c)
            horizon.labels(node).set(h)
            horizon_age.labels(node).set(r.c - h)
            per_peer: dict = {}
            for (dst, _tag) in r._inflight:
                per_peer[dst] = per_peer.get(dst, 0) + 1
            for j in peers:
                inflight.labels(node, j).set(per_peer.get(j, 0))
            try:
                tomb.labels(node).set(len(r.store.tombstoned_keys()))
            except AttributeError:
                pass
            reaper = r.reaper
            if reaper is not None:
                pend = reaper._pending
                reap_pending.labels(node).set(len(pend))
                missing = 0
                for key, prop in list(pend.items()):
                    missing += max(
                        0, len(reaper._quorum(key)) - len(prop.acks))
                reap_votes.labels(node).set(missing)
                reap_committed.labels(node).set_total(reaper.reaped)
                reap_evicted.labels(node).set_total(reaper.evicted)

        registry.add_collector(collect)


class AckLagProbe:
    """Write→fully-acked-by-push-peers latency for one causal replica.

    ``note_write()`` after each local δ-mutation stamps ``(replica.c,
    now)``; :meth:`poll` resolves every stamp whose tag all current push
    peers have acked (``min A ≥ tag``) into the lag histogram. The probe
    registers itself as a collector, so an idle scrape also resolves —
    but calling ``poll`` from the tick loop gives tick-resolution
    latencies instead of scrape-resolution ones.
    """

    MAX_PENDING = 4096      # stamps; beyond this the oldest are shed

    def __init__(self, registry: Registry, replica: Any, *,
                 node: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.replica = replica
        self.clock = clock if clock is not None else replica.now
        node = node if node is not None else replica.id
        self._pending: Deque[Tuple[int, float]] = deque()
        self.shed = 0
        self.lag: Histogram = registry.histogram(
            "repro_ack_lag_seconds",
            "write→fully-acked-by-push-peers latency",
            ("node",), buckets=LAG_BUCKETS)
        self._lag_child = self.lag.labels(node)
        self._pending_gauge = registry.gauge(
            "repro_ack_pending_writes",
            "local writes not yet acked by every push peer", ("node",))
        self._pending_child = self._pending_gauge.labels(node)
        registry.add_collector(self.poll)

    def note_write(self) -> None:
        """Stamp the just-recorded write (call right after ``update`` /
        ``operation``: the write holds tag ``c - 1``, so it is covered
        once acks reach ``c``)."""
        self._pending.append((self.replica.c, self.clock()))
        while len(self._pending) > self.MAX_PENDING:
            self._pending.popleft()
            self.shed += 1

    def poll(self, now: Optional[float] = None) -> int:
        """Resolve fully-acked stamps; returns how many resolved."""
        r = self.replica
        peers = r.policy.ack_peers(r, list(r.neighbors))
        if not self._pending or not peers:
            self._pending_child.set(len(self._pending))
            return 0
        acked = min(r.A.get(j, 0) for j in peers)
        now = self.clock() if now is None else now
        n = 0
        while self._pending and self._pending[0][0] <= acked:
            _, t0 = self._pending.popleft()
            self._lag_child.observe(now - t0)
            n += 1
        self._pending_child.set(len(self._pending))
        return n
