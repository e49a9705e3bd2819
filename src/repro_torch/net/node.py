"""Asyncio gossip node: a real-network harness for the `Replica` engine.

:class:`GossipNode` is to a socket what :class:`~repro_torch.core.sim.Simulator`
is to the discrete-event queue — the engine cannot tell them apart. It
presents the two-attribute surface a :class:`~repro_torch.core.propagation.Replica`
needs from its ``sim`` (``send(src, dst, msg)`` and ``time``), attaches
the replica to itself, and drives it from an event loop:

* **periodic anti-entropy ticks** — jittered ``on_periodic`` every
  ``tick`` seconds, ``gc_deltas`` every ``gc_every`` ticks, exactly the
  cadence ``run_to_convergence`` schedules in the simulator;
* **inbound dispatch** — transport frames resolve their sender's logical
  id and feed ``replica.on_receive``; the engine's wire codec does the
  decoding, so a socket delivery and a simulator delivery are the same
  bytes hitting the same method;
* **per-peer bounded send queues** — the engine's sends enqueue
  per-destination; a sender task per peer drains batches into the
  transport. When a slow link's queue overruns, the **oldest frames are
  dropped** (counted in ``stats.queue_drops``): δ-groups re-ship until
  acked in causal mode and digest-sync re-pulls anything else, so
  shedding is an admission policy, not data loss.

Replica ids stay *logical* (``gw0``…), with a separate ``peers`` map of
id → ``host:port``. That split is what makes the object-mode ≡
socket-mode equivalence contract checkable: the same write schedule
replayed through a ``Simulator`` and through a loopback socket cluster
mints identical dots and must converge to identical stores
(``tests/test_torch_net.py::test_sim_socket_equivalence``).

Frames only: a ``GossipNode`` refuses a replica without a wire codec —
sockets move bytes, and the byte accounting (:class:`LinkStats`, the
same counters as ``sim.NetStats``) is measured frame lengths.
"""

from __future__ import annotations

import asyncio
import random
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.propagation import (Replica, ShippingPolicy, StoreReplica,
                                make_policy, stable_seed)
from ..topology import Topology
from ..wire import WireCodec
from .stats import LinkStats
from .transport import Transport, make_transport

DEFAULT_POLICY = "bp+rr+digest-sync:4"


class _PeerQueue:
    """Bounded drop-oldest frame queue with an async drain."""

    def __init__(self, cap: int):
        self.cap = cap
        self.frames: deque = deque()
        self._ready = asyncio.Event()

    def put(self, frame) -> int:
        """Enqueue; returns how many old frames were shed to make room."""
        drops = 0
        while len(self.frames) >= self.cap:
            self.frames.popleft()
            drops += 1
        self.frames.append(frame)
        self._ready.set()
        return drops

    async def get_batch(self) -> List[Any]:
        while not self.frames:
            self._ready.clear()
            await self._ready.wait()
        batch = list(self.frames)
        self.frames.clear()
        return batch


def default_replica_factory(policy=DEFAULT_POLICY,
                            **replica_kwargs) -> Callable[..., Replica]:
    """A factory building the standard socket-mode replica: causal keyed
    :class:`StoreReplica` gossiping binary frames under ``policy`` — a
    spec string, a ready :class:`ShippingPolicy` (hook state lives on the
    replica, so one instance serves a whole in-process cluster), or a
    zero-arg callable returning one per replica."""
    def make(node_id: str, neighbors: Sequence[str]) -> Replica:
        if isinstance(policy, str):
            pol = make_policy(policy)
        elif isinstance(policy, ShippingPolicy):
            pol = policy
        else:
            pol = policy()
        kw = dict(causal=True, policy=pol,
                  rng=random.Random(stable_seed(node_id)),
                  wire=WireCodec())
        kw.update(replica_kwargs)
        return StoreReplica(node_id, list(neighbors), **kw)
    return make


class GossipNode:
    """One cluster member: a replica, a transport, and the loop glue.

    Two-phase startup so ephemeral ports compose: ``await bind()``
    resolves the listen address (port 0 → the OS assigns one, read back
    from ``.addr``); ``set_peers({id: addr})`` names the rest of the
    cluster; ``await start()`` builds the replica and launches the tick
    and sender tasks. ``start()`` runs ``bind`` itself when the caller
    already knew its port.
    """

    def __init__(self, node_id: str, listen: str, *,
                 transport: str = "udp",
                 peers: Optional[Dict[str, str]] = None,
                 replica_factory: Optional[Callable] = None,
                 policy=DEFAULT_POLICY,
                 topology: Optional[Topology] = None,
                 tick: float = 0.1, gc_every: int = 7,
                 queue_cap: int = 256, mtu: int = 1400,
                 loss: float = 0.0, dup: float = 0.0, reorder: float = 0.0,
                 seed: int = 0,
                 tracer: Optional[Any] = None):
        self.id = node_id
        # structured trace bus: installed on the replica at build time
        # (ensure_replica) and fed queue_drop events from the send path
        self.tracer = tracer
        self.listen = listen
        # zone annotations: classify every sent/received frame's link
        # (intra / inter / wan) in the byte accounting — the socket-side
        # measurement ``bench_topology`` compares against the simulator
        self.topology = topology
        self.zone: Optional[str] = (topology.zone(node_id)
                                    if topology is not None else None)
        self.stats = LinkStats()
        self.transport: Transport = make_transport(
            transport, node_id, mtu=mtu, loss=loss, dup=dup,
            reorder=reorder, seed=seed, stats=self.stats)
        self.transport.set_receiver(self._on_frame)
        self.peers: Dict[str, str] = dict(peers or {})
        self._addr_to_id: Dict[str, str] = {}
        self._factory = (replica_factory if replica_factory is not None
                         else default_replica_factory(policy))
        self.replica: Optional[Replica] = None
        self.tick = tick
        self.gc_every = gc_every
        self.queue_cap = queue_cap
        self._queues: Dict[str, _PeerQueue] = {}
        self._tasks: List[asyncio.Task] = []
        self._rng = random.Random(seed ^ stable_seed(node_id))
        self.addr: Optional[str] = None
        self.errors: List[BaseException] = []
        self._running = False
        # observability surface (export_metrics / serve_metrics)
        self.metrics_registry: Optional[Any] = None
        self.metrics_addr: Optional[str] = None
        self.lag_probe: Optional[Any] = None
        self._metrics_server: Optional[Any] = None

    # -- what the replica sees as its "sim" -------------------------------------
    @property
    def time(self) -> float:
        return time.monotonic()

    def send(self, src: str, dst: str, msg: Any) -> None:
        """The engine's transmit path (``Node.send`` → ``sim.send``)."""
        if not isinstance(msg, (bytes, bytearray)):
            raise TypeError(
                "socket gossip ships binary δ-wire frames; attach a "
                "WireCodec to the replica (wire=WireCodec())")
        kind = getattr(msg, "kind", "frame")
        link_cls, cost = None, 1.0
        if self.topology is not None:
            link_cls = self.topology.link_class(self.id, dst)
            cost = self.topology.byte_cost(self.id, dst)
        self.stats.record(str(kind), len(msg),
                          link_class=link_cls, byte_cost=cost)
        q = self._queues.get(dst)
        if q is None:
            self.stats.dropped += 1          # unknown/departed peer
            return
        drops = q.put(msg)
        if drops:
            self.stats.queue_drops += drops
            self.stats.dropped += drops
            if self.tracer is not None:
                self.tracer.emit("queue_drop", dst=dst, dropped=drops)

    # -- lifecycle -------------------------------------------------------------
    async def bind(self) -> str:
        if self.addr is None:
            self.addr = await self.transport.start(self.listen)
        return self.addr

    def set_peers(self, peers: Dict[str, str]) -> None:
        self.peers = dict(peers)

    def ensure_replica(self) -> Replica:
        """Build the replica from the factory once peers are known —
        callable before ``start()`` so writes can precede gossip."""
        assert self.peers, "a gossip node needs at least one peer"
        if self.replica is None:
            self.replica = self._factory(self.id, sorted(self.peers))
            if self.tracer is not None:
                self.replica.tracer = self.tracer
        return self.replica

    async def start(self) -> None:
        await self.bind()
        assert self.peers, "a gossip node needs at least one peer"
        self._addr_to_id = {addr: pid for pid, addr in self.peers.items()}
        self.ensure_replica()
        if self.replica.wire is None:
            raise ValueError("socket gossip requires replica.wire — "
                             "frames are what cross the network")
        self.replica.attach(self)            # replica.sim = this node
        self._running = True
        for pid, addr in self.peers.items():
            q = self._queues[pid] = _PeerQueue(self.queue_cap)
            self._tasks.append(asyncio.ensure_future(
                self._sender(pid, addr, q)))
        self._tasks.append(asyncio.ensure_future(self._ticker()))

    def adopt_replica(self, replica: Replica) -> None:
        """Install a pre-built replica (e.g. one recovered from a durable
        snapshot for a restart test) instead of the factory's fresh one."""
        self.replica = replica

    async def _sender(self, pid: str, addr: str, q: _PeerQueue) -> None:
        try:
            while self._running:
                frames = await q.get_batch()
                await self.transport.send_frames(addr, frames)
        except asyncio.CancelledError:
            pass
        except Exception as e:               # pragma: no cover - surfaced
            self.errors.append(e)

    async def _ticker(self) -> None:
        ticks = 0
        try:
            while self._running:
                await asyncio.sleep(
                    self.tick * (1.0 + self._rng.uniform(-0.1, 0.1)))
                assert self.replica is not None
                self.replica.on_periodic()
                if self.lag_probe is not None:
                    self.lag_probe.poll()   # tick-resolution ack lag
                ticks += 1
                if ticks % self.gc_every == 0:
                    self.replica.gc_deltas()
        except asyncio.CancelledError:
            pass
        except Exception as e:
            self.errors.append(e)            # engine bug: stop ticking,

    # -- inbound ---------------------------------------------------------------
    def _on_frame(self, src_key: str, frame) -> None:
        """Transport delivery: ``src_key`` is a logical id (TCP hello) or
        a source address (UDP) mapped through the peer table."""
        src = self._addr_to_id.get(src_key, src_key)
        link_cls = (self.topology.link_class(src, self.id)
                    if self.topology is not None else None)
        self.stats.record_recv(getattr(frame, "kind", "frame"), len(frame),
                               link_class=link_cls)
        if self.replica is None:
            return
        try:
            self.replica.on_receive(src, frame)
        except Exception as e:
            self.errors.append(e)

    # -- convenience write API ---------------------------------------------------
    def update(self, key: str, typ, mutator_name: str, *args) -> Any:
        assert isinstance(self.replica, StoreReplica)
        out = self.replica.update(key, typ, mutator_name, *args)
        if self.lag_probe is not None:
            self.lag_probe.note_write()
        return out

    def operation(self, m_delta: Callable[[Any], Any]) -> Any:
        assert self.replica is not None
        out = self.replica.operation(m_delta)
        if self.lag_probe is not None:
            self.lag_probe.note_write()
        return out

    @property
    def X(self):
        assert self.replica is not None
        return self.replica.X

    async def stop(self, *, abort: bool = False) -> None:
        self._running = False
        if self._metrics_server is not None:
            await self._metrics_server.stop()
            self._metrics_server = None
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if abort and hasattr(self.transport, "abort_connections"):
            self.transport.abort_connections()
        await self.transport.close()

    def check_healthy(self) -> None:
        """Raise the first error a background task swallowed, if any."""
        if self.errors:
            raise self.errors[0]

    # -- observability -----------------------------------------------------------
    def export_metrics(self, registry: Optional[Any] = None) -> Any:
        """Wire this node into a metrics registry (default: a fresh one):
        the transport's :class:`LinkStats` (with scrape-window byte-rate
        gauges), per-peer replica health probes, write→fully-acked lag,
        and the process-wide kernel counters. Returns the registry —
        everything is collect-time, so the gossip hot path is untouched."""
        from ..obs import AckLagProbe, Registry, ReplicaProbes
        if registry is None:
            registry = Registry()
        registry.absorb_link_stats(self.stats, node=self.id,
                                   clock=lambda: self.time)
        registry.absorb_kernel_counters(node=self.id)
        replica = self.ensure_replica()
        ReplicaProbes(registry, replica, node=self.id)
        self.lag_probe = AckLagProbe(registry, replica, node=self.id,
                                     clock=lambda: self.time)
        return registry

    async def serve_metrics(self, registry: Optional[Any] = None, *,
                            host: str = "127.0.0.1", port: int = 0) -> str:
        """Start the sidecar scrape endpoint (Prometheus text at
        ``/metrics``, JSON at ``/metrics.json``) on this node's event
        loop; returns (and remembers, as ``metrics_addr``) its address.
        Stopped with the node."""
        from ..obs import MetricsServer
        if registry is None:
            registry = self.export_metrics()
        self.metrics_registry = registry
        self._metrics_server = MetricsServer(registry, host=host, port=port)
        self.metrics_addr = await self._metrics_server.start()
        return self.metrics_addr


# ---------------------------------------------------------------------------
# Cluster helpers (tests + benchmarks)
# ---------------------------------------------------------------------------

async def start_cluster(n: int, *, transport: str = "udp",
                        policy=DEFAULT_POLICY,
                        replica_factory: Optional[Callable] = None,
                        topology: Optional[Topology] = None,
                        tick: float = 0.05, queue_cap: int = 256,
                        mtu: int = 1400, loss: float = 0.0,
                        dup: float = 0.0, reorder: float = 0.0,
                        seed: int = 0, host: str = "127.0.0.1",
                        start_gossip: bool = True,
                        tracer_factory: Optional[Callable[[str], Any]]
                        = None) -> List[GossipNode]:
    """N in-process nodes on ephemeral loopback ports, fully meshed.

    Binds everyone first (so the OS assigns ports), then wires the peer
    tables, then — unless ``start_gossip=False``, for callers that want
    to apply writes before the first tick — starts the gossip tasks.
    ``topology`` annotates the members with zones: frame bytes are
    classed intra/inter/wan per link (pair with a zone-aware policy via
    ``policy``/``replica_factory`` for hierarchical gossip).
    ``tracer_factory`` (node id → :class:`~repro_torch.obs.Tracer`) attaches a
    trace bus per member.
    """
    nodes = [GossipNode(f"gw{k}", f"{host}:0", transport=transport,
                        policy=policy, replica_factory=replica_factory,
                        topology=topology,
                        tick=tick, queue_cap=queue_cap, mtu=mtu,
                        loss=loss, dup=dup, reorder=reorder,
                        seed=seed + k,
                        tracer=(tracer_factory(f"gw{k}")
                                if tracer_factory is not None else None))
             for k in range(n)]
    for node in nodes:
        await node.bind()
    addrs = {node.id: node.addr for node in nodes}
    for node in nodes:
        node.set_peers({pid: a for pid, a in addrs.items()
                        if pid != node.id})
        node.ensure_replica()    # writes may precede the first tick
    if start_gossip:
        for node in nodes:
            await node.start()
    return nodes


async def start_gossip(nodes: Sequence[GossipNode]) -> None:
    for node in nodes:
        await node.start()


def cluster_converged(nodes: Sequence[GossipNode]) -> bool:
    states = [n.X for n in nodes]
    return all(s == states[0] for s in states[1:])


async def wait_converged(nodes: Sequence[GossipNode], *,
                         timeout: float = 30.0, poll: float = 0.1,
                         settle: Optional[Callable[[], bool]] = None
                         ) -> float:
    """Poll until every node's state agrees (or ``settle()`` says done);
    returns the seconds it took. Raises on timeout or a node error."""
    t0 = time.monotonic()
    done = settle if settle is not None else (
        lambda: cluster_converged(nodes))
    while True:
        for node in nodes:
            node.check_healthy()
        if done():
            return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise AssertionError(
                f"no convergence within {timeout}s; stats="
                + "; ".join(f"{n.id}:{n.stats.summary()}" for n in nodes))
        await asyncio.sleep(poll)


async def stop_cluster(nodes: Sequence[GossipNode]) -> None:
    for node in nodes:
        await node.stop()
