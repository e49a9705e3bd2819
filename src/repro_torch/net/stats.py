"""Byte accounting for the socket transports — the simulator's counters.

The network simulator and the real transports must report traffic in the
same shape, or the bench tables are apples-to-oranges: a sim row says
"digest-sync reconnect costs 1.5% of a full-state frame" and the socket
row must be directly comparable. So the socket layer does not grow its
own stats class — :class:`LinkStats` **is** :class:`repro_torch.core.sim.NetStats`
(same ``record``/``by_kind``/``bytes_by_kind``/``payload_atoms``/
``pull_bytes``), extended with the counters only a real link has:
datagram/chunk counts, reassembly and queue-overrun drops, stream
resyncs, reconnects, and the receive-side mirror of the per-kind byte
columns (a simulator sees both ends of every link; a process sees only
its own, so catch-up cost is measured at the receiver).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..core.sim import NetStats


@dataclass
class LinkStats(NetStats):
    """Per-node transport counters; see module docstring.

    Inherited from ``NetStats`` (identical semantics): ``sent``,
    ``delivered``, ``dropped``, ``duplicated``, ``bytes_sent``,
    ``by_kind``, ``bytes_by_kind``, ``record(kind, size)``,
    ``payload_atoms()``, ``pull_bytes()``. ``dropped`` counts frames this
    node *chose* to drop (queue overrun admission) — loss on the wire is
    invisible to a sender and shows up only as the receiver not acking.
    """

    # receive-side mirror of the per-kind byte columns
    bytes_recv: int = 0
    recv_by_kind: Dict[str, int] = field(default_factory=dict)
    recv_bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    # receive-side mirror of the per-link-class split (populated only
    # when the node carries a Topology; send side inherits by_class /
    # bytes_by_class / link_cost from NetStats)
    recv_by_class: Dict[str, int] = field(default_factory=dict)
    recv_bytes_by_class: Dict[str, int] = field(default_factory=dict)
    # datagram channel
    datagrams_sent: int = 0
    datagrams_recv: int = 0
    chunks_sent: int = 0           # oversized-frame shards
    reassembly_drops: int = 0      # partial oversized frames evicted
    # stream channel
    resyncs: int = 0               # FrameStream skipped garbage/corruption
    reconnects: int = 0            # TCP dial retries that followed a drop
    # admission control
    queue_drops: int = 0           # frames dropped by bounded send queues

    def record_recv(self, kind: str, size: int,
                    link_class: Optional[str] = None) -> None:
        self.delivered += 1
        self.bytes_recv += size
        self.recv_by_kind[kind] = self.recv_by_kind.get(kind, 0) + 1
        self.recv_bytes_by_kind[kind] = (
            self.recv_bytes_by_kind.get(kind, 0) + size)
        if link_class is not None:
            self.recv_by_class[link_class] = (
                self.recv_by_class.get(link_class, 0) + 1)
            self.recv_bytes_by_class[link_class] = (
                self.recv_bytes_by_class.get(link_class, 0) + size)

    def recv_cross_zone_bytes(self) -> int:
        """Bytes received over links that left the sender's zone — the
        receive-side twin of :meth:`NetStats.cross_zone_bytes`."""
        return sum(v for cls, v in self.recv_bytes_by_class.items()
                   if cls != "intra")

    # the kinds that carry state toward the receiver (PAYLOAD_KINDS minus
    # digest *requests* — those are the poller's cost, scale with the
    # responder's store, and arrive in steady state whether or not this
    # node is behind, so they'd drown a catch-up measurement)
    STATE_KINDS = ("delta", "state", "handoff", "digest-resp",
                   "membership", "topk")

    def recv_payload_bytes(self) -> int:
        """Receive-side counterpart of :meth:`NetStats.payload_atoms` —
        everything a shipping policy pays for, seen from this end."""
        return sum(v for k, v in self.recv_bytes_by_kind.items()
                   if k in self.PAYLOAD_KINDS)

    def recv_state_bytes(self) -> int:
        """State-carrying bytes received — what a reconnecting node
        actually paid to catch up (see ``STATE_KINDS``)."""
        return sum(v for k, v in self.recv_bytes_by_kind.items()
                   if k in self.STATE_KINDS)

    def summary(self) -> Dict[str, int]:
        out = {
            "sent": self.sent, "bytes_sent": self.bytes_sent,
            "delivered": self.delivered, "bytes_recv": self.bytes_recv,
            "queue_drops": self.queue_drops,
            "reassembly_drops": self.reassembly_drops,
            "resyncs": self.resyncs, "reconnects": self.reconnects,
        }
        if self.bytes_by_class:          # zoned node: show the class split
            out["bytes_by_class"] = dict(self.bytes_by_class)
        if self.recv_bytes_by_class:
            out["recv_bytes_by_class"] = dict(self.recv_bytes_by_class)
        return out
