"""Discrete-event simulator of the paper's network model (§2).

The network is asynchronous and unreliable: messages can be **lost,
duplicated, or reordered** (never corrupted); arbitrarily long partitions
happen but eventually heal; if a node sends infinitely many messages,
infinitely many get through. Nodes have durable storage, can crash, and
recover with the durable content as of the last atomic state transition.

The simulator drives ``Node`` subclasses (anti-entropy replicas, pods in the
training runtime) with:

* seeded randomness — every run is reproducible;
* per-link loss / duplication probability and delay jitter (reordering
  falls out of random delays);
* time-windowed partitions;
* crash / recover events that reset volatile state from durable state;
* message / byte accounting (structural sizes) for the §9
  message-complexity benchmarks.
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Structural size accounting (the Õ(·) of §9: counts of atoms, ignoring
# logarithmic factors in the size of integers and ids)
# ---------------------------------------------------------------------------

def structural_size(x: Any) -> int:
    """Number of atomic entries in a (nested) CRDT value / message.

    Encoded wire frames (bytes) are the exception: their size is not an
    estimate but the measured frame length, so byte accounting under the
    wire codec reports real bytes shipped."""
    if x is None:
        return 0
    if isinstance(x, (bytes, bytearray)):
        return len(x)
    if isinstance(x, (int, float, str, bool)):
        return 1
    try:
        import numpy as _np
        if isinstance(x, _np.ndarray):
            return int(x.size)    # digest version columns in object mode
    except ImportError:  # pragma: no cover
        pass
    if isinstance(x, (list, tuple, set, frozenset)):
        return sum(structural_size(v) for v in x)
    if isinstance(x, dict):
        return sum(structural_size(k) + structural_size(v) for k, v in x.items())
    if hasattr(x, "__dataclass_fields__"):
        return sum(structural_size(getattr(x, f)) for f in x.__dataclass_fields__)
    return 1


@dataclass
class NetConfig:
    loss: float = 0.0          # P(drop) per transmission
    dup: float = 0.0           # P(one extra copy) per delivered message
    min_delay: float = 0.05
    max_delay: float = 1.0
    seed: int = 0


@dataclass
class NetStats:
    sent: int = 0
    delivered: int = 0
    dropped: int = 0
    duplicated: int = 0
    bytes_sent: int = 0        # structural size of all sent payloads
    by_kind: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    # link-class split (populated only under a Topology): the same byte
    # totals re-bucketed by intra / inter / wan, plus the cost-model
    # accumulator (bytes × the link's byte_cost — WAN egress is billed)
    by_class: Dict[str, int] = field(default_factory=dict)
    bytes_by_class: Dict[str, int] = field(default_factory=dict)
    link_cost: float = 0.0

    def record(self, kind: str, size: int,
               link_class: Optional[str] = None,
               byte_cost: float = 1.0) -> None:
        self.sent += 1
        self.bytes_sent += size
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + size
        if link_class is not None:
            self.by_class[link_class] = self.by_class.get(link_class, 0) + 1
            self.bytes_by_class[link_class] = (
                self.bytes_by_class.get(link_class, 0) + size)
            self.link_cost += size * byte_cost

    def cross_zone_bytes(self) -> int:
        """Bytes shipped on links that leave the sender's zone (the
        inter + wan classes) — what hierarchical gossip exists to
        minimize, and what ``bench_topology`` compares against the flat
        mesh. Zero when no topology was attached (nothing was classed)."""
        return sum(v for cls, v in self.bytes_by_class.items()
                   if cls != "intra")

    PAYLOAD_KINDS = ("delta", "state", "handoff", "membership",
                     "digest", "digest-resp")

    def payload_atoms(self) -> int:
        """Size of all traffic a shipping policy pays for: delta / state
        / handoff / membership payloads plus BOTH halves of a digest
        exchange — requests carry per-chunk version columns that scale
        with store size, so excluding them would flatter pull policies
        in the §9 tables and policy benchmarks. Only fixed-size control
        traffic (acks) is excluded. Structural atoms for object
        messages; measured frame bytes when replicas ship through the
        wire codec."""
        return sum(v for k, v in self.bytes_by_kind.items()
                   if k in self.PAYLOAD_KINDS)

    def pull_bytes(self) -> int:
        """Total cost of digest exchanges: requests (summaries) plus
        responses (the rows the requester lacked) — what a reconnect
        catch-up pays under digest-sync, compared against one full-state
        frame in ``bench_wire``."""
        return (self.bytes_by_kind.get("digest", 0)
                + self.bytes_by_kind.get("digest-resp", 0))


class Node:
    """Base replica. Subclasses define durable/volatile state and handlers."""

    def __init__(self, node_id: str):
        self.id = node_id
        self.sim: Optional["Simulator"] = None
        self.alive = True

    # -- wiring ---------------------------------------------------------------
    def attach(self, sim: "Simulator") -> None:
        self.sim = sim

    def send(self, dst: str, msg: Any) -> None:
        assert self.sim is not None
        self.sim.send(self.id, dst, msg)

    # -- handlers (override) ----------------------------------------------------
    def on_receive(self, src: str, msg: Any) -> None:  # pragma: no cover
        raise NotImplementedError

    def on_periodic(self) -> None:  # pragma: no cover
        pass

    # -- crash model --------------------------------------------------------------
    def durable_snapshot(self) -> Any:
        """What survives a crash (atomic at each state transition)."""
        return None

    def recover(self, durable: Any) -> None:
        """Reinitialise volatile state from durable state."""

    def crash_and_recover(self) -> None:
        self.recover(self.durable_snapshot())


class Simulator:
    """Discrete-event network; ``topology`` (a ``Topology``-shaped
    object, duck-typed) makes links non-uniform: each message's loss/dup/delay
    come from the link's class profile (falling back to ``config`` for
    classes without an override) and bytes are accounted per class.
    Without a topology every link behaves identically — the flat mesh."""

    def __init__(self, config: NetConfig = NetConfig(),
                 topology: Optional[Any] = None):
        self.cfg = config
        self.topology = topology
        self.rng = random.Random(config.seed)
        self.time = 0.0
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.nodes: Dict[str, Node] = {}
        self.stats = NetStats()
        # partitions: list of (t_start, t_end, set_a, set_b); messages between
        # the two sides are dropped while t in [t_start, t_end).
        self.partitions: List[Tuple[float, float, frozenset, frozenset]] = []

    # -- topology ------------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        node.attach(self)
        self.nodes[node.id] = node
        return node

    def add_partition(self, t_start: float, t_end: float,
                      side_a: Iterable[str], side_b: Iterable[str]) -> None:
        self.partitions.append((t_start, t_end, frozenset(side_a),
                                frozenset(side_b)))

    def add_zone_partition(self, t_start: float, t_end: float,
                           zone: str) -> None:
        """Cut one zone off from the rest of the world for a window —
        the canonical multi-region failure. Requires a topology; sides
        are computed from the nodes added so far."""
        if self.topology is None:
            raise ValueError("zone partitions need a Simulator topology")
        side_a = [i for i in self.nodes if self.topology.zone(i) == zone]
        side_b = [i for i in self.nodes if self.topology.zone(i) != zone]
        if not side_a or not side_b:
            raise ValueError(f"zone {zone!r} partition has an empty side")
        self.add_partition(t_start, t_end, side_a, side_b)

    def _partitioned(self, src: str, dst: str) -> bool:
        for t0, t1, a, b in self.partitions:
            if t0 <= self.time < t1 and (
                    (src in a and dst in b) or (src in b and dst in a)):
                return True
        return False

    # -- scheduling ------------------------------------------------------------
    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._q, (self.time + delay, next(self._seq), fn))

    def every(self, interval: float, fn: Callable[[], None],
              jitter: float = 0.1, until: float = float("inf")) -> None:
        def tick():
            if self.time >= until:
                return
            fn()
            self.schedule(interval * (1.0 + self.rng.uniform(-jitter, jitter)),
                          tick)
        self.schedule(self.rng.uniform(0, interval), tick)

    # -- transport ------------------------------------------------------------
    def send(self, src: str, dst: str, msg: Any) -> None:
        # encoded frames carry their traffic class as a .kind attribute
        kind = getattr(msg, "kind", None)
        if kind is None:
            kind = (msg[0] if isinstance(msg, tuple) and msg
                    else type(msg).__name__)
        # per-link-class conditions: the link's profile overrides the
        # flat NetConfig when the topology carries one for its class
        link_cls: Optional[str] = None
        loss, dup = self.cfg.loss, self.cfg.dup
        min_delay, max_delay = self.cfg.min_delay, self.cfg.max_delay
        byte_cost = 1.0
        if self.topology is not None:
            link_cls = self.topology.link_class(src, dst)
            prof = self.topology.profiles.get(link_cls)
            if prof is not None:
                loss, dup = prof.loss, prof.dup
                min_delay, max_delay = prof.min_delay, prof.max_delay
                byte_cost = prof.byte_cost
        self.stats.record(str(kind), structural_size(msg),
                          link_class=link_cls, byte_cost=byte_cost)
        if self._partitioned(src, dst) or self.rng.random() < loss:
            self.stats.dropped += 1
            return
        copies = 1
        if self.rng.random() < dup:
            copies += 1
            self.stats.duplicated += 1
        for _ in range(copies):
            delay = self.rng.uniform(min_delay, max_delay)

            def deliver(dst=dst, src=src, msg=msg):
                node = self.nodes.get(dst)
                if node is not None and node.alive:
                    self.stats.delivered += 1
                    node.on_receive(src, msg)

            self.schedule(delay, deliver)

    # -- fault injection ----------------------------------------------------------
    def crash(self, node_id: str, downtime: float) -> None:
        node = self.nodes[node_id]
        durable = node.durable_snapshot()
        node.alive = False

        def back_up():
            node.alive = True
            node.recover(durable)

        self.schedule(downtime, back_up)

    # -- run loop -------------------------------------------------------------
    def run_until(self, t_end: float) -> None:
        while self._q and self._q[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._q)
            self.time = max(self.time, t)
            fn()
        self.time = max(self.time, t_end)

    def run_for(self, dt: float) -> None:
        self.run_until(self.time + dt)
