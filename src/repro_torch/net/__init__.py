"""Real network transport: the δ-wire subsystem over asyncio sockets.

Everything below :mod:`repro_torch.core.sim` was built for real networks —
versioned, CRC-checksummed, self-describing frames; digest-sync as a
reconnect story; drop-tolerant δ-semantics — and this package finally
ships them between OS processes:

* ``transport`` — one ``Transport`` interface, two channels: UDP
  (fire-and-forget, MTU-aware batching/splitting with drop-whole-frame
  reassembly, seeded loss/dup/reorder injection) and TCP
  (length-from-the-frame-header streaming through ``FrameStream``,
  hello-identified connections, capped-backoff reconnect).
* ``node`` — ``GossipNode``: drives a ``core.propagation.Replica`` from
  an event loop (the replica sees the node as its ``sim``), with
  periodic anti-entropy ticks, inbound frame dispatch, and bounded
  drop-oldest per-peer send queues.
* ``stats`` — ``LinkStats``: ``sim.NetStats`` plus the counters only a
  real link has, so socket byte reports line up column-for-column with
  simulator byte reports.

The simulator stays the deterministic fault harness; the contract
between the two worlds is that one write schedule replayed through both
converges to identical stores (asserted in ``tests/test_torch_net.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .node import (DEFAULT_POLICY, GossipNode, cluster_converged,
                   default_replica_factory, start_cluster, start_gossip,
                   stop_cluster, wait_converged)
from .stats import LinkStats
from .transport import (TcpTransport, Transport, UdpTransport, format_addr,
                        make_transport, parse_addr)

TRANSPORTS = ("udp", "tcp")


@dataclass
class NetSpec:
    """Validated socket-cluster shape behind ``serve.py --listen/--peers``.

    ``node_id``/``peer_ids`` are the *logical* replica ids (the simulator
    id space); addresses are where the sockets live. The CLI accepts
    ``id@host:port`` to name a member, bare ``host:port`` to let the
    address be the name, and ``id@host:port@zone`` to additionally place
    the member in a failure domain (``zone`` or ``region/zone``) —
    ``zones`` then maps every member id to its zone and :attr:`topology`
    carries the cluster's :class:`~repro_torch.topology.Topology`.

    ``session_ttl`` is the key-lifecycle TTL to run over the socket
    cluster (None = lifecycle off).
    """

    node_id: str
    listen: str
    transport: str = "udp"
    peers: Dict[str, str] = field(default_factory=dict)   # id → host:port
    zones: Dict[str, str] = field(default_factory=dict)   # id → zone
    session_ttl: Optional[float] = None

    @property
    def cluster_ids(self) -> List[str]:
        return sorted([self.node_id, *self.peers])

    @property
    def topology(self):
        """The cluster :class:`~repro_torch.topology.Topology`, or None when no
        member carries a zone annotation (flat mesh)."""
        if not self.zones:
            return None
        from ..topology import Topology
        return Topology(self.zones)


def _split_member(spec: str) -> tuple:
    """``[id@]host:port[@zone]`` → ``(id, "host:port", zone|None)``
    (id defaults to the canonical address; a zone requires the id)."""
    parts = spec.split("@")
    if len(parts) == 1:
        name, addr, zone = None, parts[0], None
    elif len(parts) == 2:
        (name, addr), zone = parts, None
    elif len(parts) == 3:
        name, addr, zone = parts
    else:
        raise ValueError(f"member {spec!r} is not [ID@]HOST:PORT[@ZONE]")
    if zone is not None and (not name or not zone):
        raise ValueError(f"member {spec!r}: a zone annotation needs the "
                         "full ID@HOST:PORT@ZONE form")
    host, port = parse_addr(addr)            # raises ValueError on junk
    canonical = format_addr((host, port))
    return (name if name else canonical), canonical, zone


def validate_net_args(listen: Optional[str], peers: Optional[str], *,
                      transport: str = "udp", wire: bool = True,
                      udp_loss: float = 0.0,
                      session_ttl: Optional[float] = None) -> NetSpec:
    """Check a socket-mode CLI combination and shape it into a
    :class:`NetSpec` — every rejection here is a one-line error at arg
    parse time instead of a deep failure after sockets are up.
    """
    if bool(listen) != bool(peers):
        raise ValueError("socket mode needs BOTH --listen and --peers "
                         "(a gossip cluster has at least two members)")
    assert listen is not None and peers is not None
    if not wire:
        raise ValueError(
            "--no-wire is incompatible with --listen/--peers: socket "
            "gossip ships binary δ-wire frames — objects cannot cross "
            "a process boundary")
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown --transport {transport!r}; "
                         f"have {', '.join(TRANSPORTS)}")
    if udp_loss and transport != "udp":
        raise ValueError("--udp-loss injects datagram loss and is "
                         "UDP-only (TCP retransmits under the socket)")
    if not 0.0 <= udp_loss < 1.0:
        raise ValueError(f"--udp-loss must be in [0, 1), got {udp_loss}")
    if session_ttl is not None and session_ttl <= 0:
        raise ValueError(f"--session-ttl must be positive seconds, "
                         f"got {session_ttl}")
    node_id, listen_addr, self_zone = _split_member(listen)
    zones: Dict[str, str] = {}
    if self_zone:
        zones[node_id] = self_zone
    peer_map: Dict[str, str] = {}
    for part in peers.split(","):
        part = part.strip()
        if not part:
            continue
        pid, addr, zone = _split_member(part)
        if addr == listen_addr or pid == node_id:
            raise ValueError(f"--peers entry {part!r} is this node's own "
                             "--listen address/id (no self-gossip)")
        if pid in peer_map:
            raise ValueError(f"duplicate peer {pid!r} in --peers")
        peer_map[pid] = addr
        if zone:
            zones[pid] = zone
    if not peer_map:
        raise ValueError("--peers names no cluster members")
    for pid, addr in peer_map.items():
        if addr.endswith(":0"):
            raise ValueError(f"peer {pid!r} has port 0 — peers need "
                             "concrete ports (only --listen may use 0)")
    if zones and len(zones) != len(peer_map) + 1:
        missing = sorted(({node_id, *peer_map} - zones.keys()))
        raise ValueError(
            f"zone annotations must cover every member or none — "
            f"missing for {', '.join(missing)} (use ID@HOST:PORT@ZONE)")
    return NetSpec(node_id=node_id, listen=listen_addr,
                   transport=transport, peers=peer_map, zones=zones,
                   session_ttl=session_ttl or None)


__all__ = [
    "DEFAULT_POLICY", "GossipNode", "LinkStats", "NetSpec",
    "TcpTransport", "TRANSPORTS", "Transport", "UdpTransport",
    "cluster_converged", "default_replica_factory", "format_addr",
    "make_transport", "parse_addr", "start_cluster", "start_gossip",
    "stop_cluster", "validate_net_args", "wait_converged",
]
