"""The port's socket transport (``repro_torch.net``): the JAX package's
``tests/test_net.py`` run against the port, plus the port held to the
reference across the process boundary.

* a UDP mesh with injected loss/dup/reorder converges; frames above the
  MTU are sharded and reassembled, and losing one shard drops the whole
  frame; duplicated datagrams are idempotent;
* a TCP peer dying mid-frame poisons nothing, and a restarted peer
  catches up through digest-sync;
* bounded per-peer send queues shed the oldest frames, and the cluster
  converges afterwards;
* ``validate_net_args`` rejects every malformed CLI combination with the
  reference's messages;
* the equivalence contract, flat and zoned: one write schedule replayed
  through the port's loopback socket cluster converges to the store of
  the port's ``Simulator`` run and to the session fingerprint of the JAX
  package's ``Simulator`` run of the same schedule;
* a small basic-mode tensor store, device-resident on the CPU, gossiped
  over TCP loopback under digest-sync equals bit for bit the JAX
  package's join of the same writes.

Loopback only, ephemeral ports, a timeout on every wait.
"""

import asyncio
import random
import socket

import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.core.tensor_lattice as rtl
import repro.launch.serve as rserve
import repro.topology as rtopo
from repro_torch.core import (MVRegister, NetConfig, Simulator,
                              StoreReplica, converged, hierarchical_policy,
                              make_policy, run_to_convergence)
from repro_torch.launch import serve as tserve
from repro_torch.net import (GossipNode, NetSpec, UdpTransport,
                             default_replica_factory, start_cluster,
                             start_gossip, stop_cluster, validate_net_args,
                             wait_converged)
from repro_torch.net.node import _PeerQueue
from repro_torch.topology import Topology
from repro_torch.wire import WireCodec, decode_frame, encode_frame


# ---------------------------------------------------------------------------
# UDP: faulty mesh convergence, sharding, drop-whole-frame
# ---------------------------------------------------------------------------

def test_udp_cluster_converges_under_loss_dup_reorder():
    async def scenario():
        nodes = await start_cluster(3, transport="udp", tick=0.03,
                                    loss=0.15, dup=0.10, reorder=0.10,
                                    seed=3)
        try:
            for i in range(30):
                nodes[i % 3].update(f"k{i % 11}", MVRegister,
                                    "write_delta", nodes[i % 3].id, i)
                await asyncio.sleep(0.004)
            await wait_converged(nodes, timeout=30.0)
            assert sum(n.transport.injected_losses for n in nodes) > 0
            for n in nodes:
                n.check_healthy()
        finally:
            await stop_cluster(nodes)
    asyncio.run(scenario())


def test_udp_oversized_frame_is_sharded_and_reassembled():
    async def scenario():
        nodes = await start_cluster(2, transport="udp", tick=0.03,
                                    mtu=600, seed=7)
        try:
            big = "v" * 5000
            nodes[0].update("blob", MVRegister, "write_delta",
                            nodes[0].id, big)
            await wait_converged(nodes, timeout=15.0)
            got = nodes[1].replica.get("blob", MVRegister).read()
            assert got == {big}
            assert nodes[0].stats.chunks_sent > 0
        finally:
            await stop_cluster(nodes)
    asyncio.run(scenario())


def test_udp_lost_shard_drops_whole_frame():
    async def scenario():
        got = []
        a, b = UdpTransport(mtu=200), UdpTransport(mtu=200)
        await a.start("127.0.0.1:0")
        await b.start("127.0.0.1:0")
        b.set_receiver(lambda src, fr: got.append(fr))
        big = encode_frame("state", b"y" * 1000)
        emit = a._emit
        calls = {"n": 0}

        def drop_second_shard(datagram, addr):
            calls["n"] += 1
            if calls["n"] != 2:
                emit(datagram, addr)

        try:
            a._emit = drop_second_shard
            await a.send_frames(b.addr, [big])
            await asyncio.sleep(0.15)
            assert got == []                  # no half-frame smuggled up
            assert calls["n"] > 2
            a._emit = emit
            await a.send_frames(b.addr, [big])
            for _ in range(100):
                if got:
                    break
                await asyncio.sleep(0.01)
            assert len(got) == 1 and got[0].kind == "state"
            kind, payload = decode_frame(got[0])
            assert kind == "state" and bytes(payload) == b"y" * 1000
        finally:
            await a.close()
            await b.close()
    asyncio.run(scenario())


def test_udp_duplicate_datagrams_are_idempotent():
    async def scenario():
        nodes = await start_cluster(2, transport="udp", tick=0.03,
                                    dup=0.5, seed=13)
        try:
            for i in range(10):
                nodes[0].update(f"d{i}", MVRegister, "write_delta",
                                nodes[0].id, i)
            await wait_converged(nodes, timeout=15.0)
            assert nodes[1].replica.get("d3", MVRegister).read() == {3}
        finally:
            await stop_cluster(nodes)
    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# TCP: mid-frame crash, reconnect, digest-sync repair
# ---------------------------------------------------------------------------

def test_tcp_midframe_crash_then_reconnect_converges():
    async def scenario():
        nodes = await start_cluster(2, transport="tcp", tick=0.03,
                                    start_gossip=False, seed=17)
        a, b = nodes
        try:
            torn = encode_frame("delta", b"x" * 300)
            await a.transport.inject_raw(b.addr, bytes(torn)[:40])
            await asyncio.sleep(0.05)
            a.transport.abort_connections()
            await asyncio.sleep(0.05)
            assert b.stats.delivered == 0

            await start_gossip(nodes)
            a.update("after", MVRegister, "write_delta", a.id, "crash")
            await wait_converged(nodes, timeout=15.0)
            assert b.replica.get("after", MVRegister).read() == {"crash"}
            for n in nodes:
                n.check_healthy()
        finally:
            await stop_cluster(nodes)
    asyncio.run(scenario())


def test_tcp_peer_restart_catches_up_via_digest_sync():
    async def scenario():
        policy = "digest-sync"
        nodes = await start_cluster(2, transport="tcp", tick=0.03,
                                    policy=policy, seed=19)
        a, b = nodes
        reborn = None
        try:
            for i in range(12):
                a.update(f"pre{i}", MVRegister, "write_delta", a.id, i)
            await wait_converged(nodes, timeout=15.0)

            durable = b.replica.durable_snapshot()
            addr = b.addr
            await b.stop(abort=True)          # crash
            a.update("while-down", MVRegister, "write_delta", a.id, "w")
            await asyncio.sleep(0.2)

            reborn = GossipNode(b.id, addr, transport="tcp",
                                policy=policy, peers={a.id: a.addr},
                                tick=0.03)
            replica = default_replica_factory(policy)(b.id, [a.id])
            replica.recover(durable)
            reborn.adopt_replica(replica)
            await reborn.start()
            await wait_converged([a, reborn], timeout=15.0)
            got = reborn.replica.get("while-down", MVRegister).read()
            assert got == {"w"}
            assert reborn.stats.recv_by_kind.get("digest-resp", 0) > 0
            assert reborn.stats.recv_by_kind.get("state", 0) == 0
        finally:
            if reborn is not None:
                await reborn.stop()
            await a.stop()
    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# Backpressure: bounded queues shed oldest, digest-sync repairs
# ---------------------------------------------------------------------------

def test_peer_queue_drops_oldest():
    async def scenario():
        q = _PeerQueue(cap=3)
        drops = [q.put(i) for i in range(5)]
        assert sum(drops) == 2
        assert await q.get_batch() == [2, 3, 4]
    asyncio.run(scenario())


def test_backpressure_overrun_then_convergence():
    async def scenario():
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dark_port = probe.getsockname()[1]
        probe.close()
        dark = f"127.0.0.1:{dark_port}"

        a = GossipNode("gw0", "127.0.0.1:0", transport="tcp",
                       peers={"gw1": dark}, tick=0.01, queue_cap=4)
        await a.start()
        b = None
        try:
            for i in range(40):
                a.update(f"q{i}", MVRegister, "write_delta", a.id, i)
                await asyncio.sleep(0.01)
            assert a.stats.queue_drops > 0

            b = GossipNode("gw1", dark, transport="tcp",
                           peers={"gw0": a.addr}, tick=0.01)
            await b.start()
            await wait_converged([a, b], timeout=30.0)
            assert b.replica.get("q0", MVRegister).read() == {0}
        finally:
            await stop_cluster([n for n in (a, b) if n is not None])
    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# CLI validation (serve --listen/--peers)
# ---------------------------------------------------------------------------

def test_validate_net_args_happy_path():
    spec = validate_net_args("gw0@127.0.0.1:7000",
                             "gw1@127.0.0.1:7001,gw2@127.0.0.1:7002")
    assert isinstance(spec, NetSpec)
    assert spec.node_id == "gw0" and spec.listen == "127.0.0.1:7000"
    assert spec.peers == {"gw1": "127.0.0.1:7001",
                          "gw2": "127.0.0.1:7002"}
    assert spec.cluster_ids == ["gw0", "gw1", "gw2"]


def test_validate_net_args_bare_addresses_name_themselves():
    spec = validate_net_args("127.0.0.1:7000", "127.0.0.1:7001")
    assert spec.node_id == "127.0.0.1:7000"
    assert spec.peers == {"127.0.0.1:7001": "127.0.0.1:7001"}


@pytest.mark.parametrize("listen,peers,kwargs,match", [
    ("127.0.0.1:7000", None, {}, "BOTH"),
    (None, "127.0.0.1:7001", {}, "BOTH"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001", {"wire": False}, "no-wire"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001",
     {"transport": "carrier-pigeon"}, "transport"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001",
     {"transport": "tcp", "udp_loss": 0.1}, "UDP-only"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001", {"udp_loss": 1.5}, "0, 1"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001",
     {"session_ttl": -2.0}, "positive"),
    ("a@127.0.0.1:7000@z0", "b@127.0.0.1:7001", {}, "every member"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001@z1,c@127.0.0.1:7002", {},
     "every member"),
    ("@127.0.0.1:7000@z0", "b@127.0.0.1:7001@z1", {}, "ID@HOST:PORT@ZONE"),
    ("a@127.0.0.1:7000@z0@extra", "b@127.0.0.1:7001@z1", {},
     r"\[ID@\]HOST:PORT\[@ZONE\]"),
    ("a@127.0.0.1:7000", "a@127.0.0.1:7001", {}, "self-gossip"),
    ("a@127.0.0.1:7000", "127.0.0.1:7000", {}, "self-gossip"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:7001,b@127.0.0.1:7002", {},
     "duplicate"),
    ("a@127.0.0.1:7000", ",", {}, "no cluster members"),
    ("a@127.0.0.1:7000", "b@127.0.0.1:0", {}, "port 0"),
    ("a@127.0.0.1:notaport", "b@127.0.0.1:7001", {}, "port"),
])
def test_validate_net_args_rejections(listen, peers, kwargs, match):
    import repro.net as rnet
    with pytest.raises(ValueError, match=match) as got:
        validate_net_args(listen, peers, **kwargs)
    with pytest.raises(ValueError) as want:
        rnet.validate_net_args(listen, peers, **kwargs)
    assert str(got.value) == str(want.value)


def test_validate_net_args_zones_and_ttl():
    spec = validate_net_args(
        "gw0@127.0.0.1:7000@eu/a",
        "gw1@127.0.0.1:7001@eu/b,gw2@127.0.0.1:7002@us/a",
        session_ttl=4.0)
    assert spec.zones == {"gw0": "eu/a", "gw1": "eu/b", "gw2": "us/a"}
    assert spec.session_ttl == 4.0
    topo = spec.topology
    assert topo.link_class("gw0", "gw1") == "inter"
    assert topo.link_class("gw0", "gw2") == "wan"
    flat = validate_net_args("gw0@127.0.0.1:7000", "gw1@127.0.0.1:7001")
    assert flat.zones == {} and flat.topology is None
    assert flat.session_ttl is None


def test_gossip_node_refuses_objects_on_the_wire():
    async def scenario():
        nodes = await start_cluster(2, transport="udp", tick=0.03,
                                    seed=37)
        try:
            with pytest.raises(TypeError, match="WireCodec"):
                nodes[0].send("gw0", "gw1", {"not": "bytes"})
        finally:
            await stop_cluster(nodes)
    asyncio.run(scenario())


def test_gossip_node_refuses_wireless_replica():
    async def scenario():
        def wireless(node_id, neighbors):
            return StoreReplica(node_id, list(neighbors), causal=True,
                                policy=make_policy("bp+rr"),
                                rng=random.Random(1), wire=None)
        nodes = await start_cluster(2, transport="udp",
                                    replica_factory=wireless,
                                    start_gossip=False, seed=41)
        try:
            with pytest.raises(ValueError, match="wire"):
                await start_gossip(nodes)
        finally:
            await stop_cluster(nodes)
    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# The equivalence contract: sim replay ≡ socket replay ≡ the reference
# ---------------------------------------------------------------------------

def _schedule(n_writes=36, n_keys=9, seed=29):
    rng = random.Random(seed)
    return [(rng.randrange(3), f"k{rng.randrange(n_keys)}", f"v{i}")
            for i in range(n_writes)]


IDS = ["gw0", "gw1", "gw2"]


def _reference_fingerprint(schedule, zones):
    """The JAX package's Simulator run of ``schedule`` (its socket-mode
    replica factory and policy; hierarchical when ``zones``): the
    session fingerprint its serve.py publishes."""
    import repro.net as rnet
    topo = rtopo.Topology.zoned(IDS, zones) if zones else None
    policy = ((lambda: rcore.hierarchical_policy(topo, base="bp+rr"))
              if zones else rnet.DEFAULT_POLICY)
    sim = rcore.Simulator(rcore.NetConfig(seed=0), topology=topo)
    nodes = [sim.add_node(rnet.default_replica_factory(policy=policy)(
        i, [j for j in IDS if j != i])) for i in IDS]
    for who, key, val in schedule:
        nodes[who].update(key, rcore.MVRegister, "write_delta", IDS[who],
                          val)
    rcore.run_to_convergence(sim, nodes, interval=1.0, max_time=60_000)
    assert rcore.converged(nodes)
    keys = sorted({k for _, k, _ in schedule})
    return rserve._session_fingerprint(nodes[0], keys)


def test_sim_socket_equivalence():
    from repro_torch.obs import Tracer, report, semantic_trace

    schedule = _schedule()
    keys = sorted({k for _, k, _ in schedule})

    sim = Simulator(NetConfig(seed=0))
    sim_tracers = {i: Tracer(node=i, clock=lambda: sim.time) for i in IDS}
    sim_nodes = []
    for i in IDS:
        r = default_replica_factory()(i, [j for j in IDS if j != i])
        r.tracer = sim_tracers[i]
        sim_nodes.append(sim.add_node(r))
    for who, key, val in schedule:
        sim_nodes[who].update(key, MVRegister, "write_delta", IDS[who], val)
    run_to_convergence(sim, sim_nodes, interval=1.0, max_time=60_000)
    assert converged(sim_nodes)

    socket_tracers = {}

    def tracer_factory(node_id):
        socket_tracers[node_id] = Tracer(node=node_id)
        return socket_tracers[node_id]

    async def scenario():
        nodes = await start_cluster(3, transport="udp", tick=0.03,
                                    start_gossip=False, seed=31,
                                    tracer_factory=tracer_factory)
        try:
            for who, key, val in schedule:
                nodes[who].update(key, MVRegister, "write_delta",
                                  IDS[who], val)
            await start_gossip(nodes)
            await wait_converged(nodes, timeout=30.0)
            return ([n.X for n in nodes],
                    [tserve._session_fingerprint(n.replica, keys)
                     for n in nodes])
        finally:
            await stop_cluster(nodes)

    socket_states, prints = asyncio.run(scenario())
    for xs in socket_states:
        assert xs == sim_nodes[0].X
    for key in keys:
        assert (socket_states[0].get(key).read()
                == sim_nodes[0].X.get(key).read())
    assert set(prints) == {_reference_fingerprint(schedule, 0)}

    sim_semantic = semantic_trace(list(sim_tracers.values()))
    sock_semantic = semantic_trace(list(socket_tracers.values()))
    assert sim_semantic == sock_semantic
    assert set(sim_semantic) == set(keys)
    assert all(rec["joined"] == IDS for rec in sim_semantic.values())
    for tracers in (sim_tracers, socket_tracers):
        rep = report(list(tracers.values()), expect_converged=IDS)
        assert rep["anomaly_list"] == []
        assert rep["unconverged_keys"] == {}


def test_sim_socket_equivalence_zoned():
    schedule = _schedule()
    keys = sorted({k for _, k, _ in schedule})
    topo = Topology.zoned(IDS, 3)

    def policy():
        return hierarchical_policy(topo, base="bp+rr")

    sim = Simulator(NetConfig(seed=0), topology=topo)
    sim_nodes = [sim.add_node(default_replica_factory(policy=policy)(
        i, [j for j in IDS if j != i])) for i in IDS]
    for who, key, val in schedule:
        sim_nodes[who].update(key, MVRegister, "write_delta", IDS[who], val)
    run_to_convergence(sim, sim_nodes, interval=1.0, max_time=60_000)
    assert converged(sim_nodes)
    assert sim.stats.cross_zone_bytes() > 0

    async def scenario():
        nodes = await start_cluster(
            3, transport="udp", tick=0.03, start_gossip=False, seed=31,
            topology=topo,
            replica_factory=default_replica_factory(policy=policy))
        try:
            for who, key, val in schedule:
                nodes[who].update(key, MVRegister, "write_delta",
                                  IDS[who], val)
            await start_gossip(nodes)
            await wait_converged(nodes, timeout=30.0)
            return ([n.X for n in nodes], [n.stats for n in nodes],
                    [tserve._session_fingerprint(n.replica, keys)
                     for n in nodes])
        finally:
            await stop_cluster(nodes)

    socket_states, stats, prints = asyncio.run(scenario())
    for xs in socket_states:
        assert xs == sim_nodes[0].X
    assert sum(s.cross_zone_bytes() for s in stats) > 0
    assert set(prints) == {_reference_fingerprint(schedule, 3)}


def test_socket_zoned_cluster_only_relays_cross_zones():
    ids = [f"gw{k}" for k in range(6)]
    topo = Topology.zoned(ids, 3)
    relays = {topo.relay(z, ids) for z in topo.zone_names(ids)}
    assert len(relays) == 3

    async def scenario():
        nodes = await start_cluster(
            6, transport="udp", tick=0.03, seed=47, topology=topo,
            start_gossip=False,
            replica_factory=default_replica_factory(
                policy=lambda: hierarchical_policy(topo)))
        try:
            for i, n in enumerate(nodes):
                n.update(f"k{i}", MVRegister, "write_delta", n.id, i)
            await start_gossip(nodes)
            await wait_converged(nodes, timeout=30.0)
            await asyncio.sleep(0.2)
            return {n.id: n.stats for n in nodes}
        finally:
            await stop_cluster(nodes)

    stats = asyncio.run(scenario())
    for nid, s in stats.items():
        assert s.bytes_by_class, f"{nid}: no frames were link-classed"
        if nid in relays:
            assert s.cross_zone_bytes() > 0, f"relay {nid} never crossed"
        else:
            assert s.cross_zone_bytes() == 0, (nid, s.bytes_by_class)


def test_socket_session_ttl_reaper_quorum_over_udp():
    import time
    from repro_torch.core.propagation import stable_seed
    from repro_torch.lifecycle import ReaperProtocol
    from repro_torch.sync import KeyOwnership

    ownership = KeyOwnership(IDS, replication=len(IDS))

    def factory(node_id, neighbors):
        r = StoreReplica(node_id, list(neighbors), causal=True,
                         policy=make_policy("bp+rr+digest-sync:4"),
                         rng=random.Random(stable_seed(node_id)),
                         wire=WireCodec(), ownership=ownership, ttl=0.8)
        ReaperProtocol(r, ownership, grace=0.2, retry=0.3)
        return r

    async def scenario():
        nodes = await start_cluster(3, replica_factory=factory, tick=0.05,
                                    seed=53)
        try:
            for i, n in enumerate(nodes):
                n.update(f"sess{i}", MVRegister, "write_delta", n.id,
                         "done")
            await wait_converged(nodes, timeout=20.0)

            def reaped():
                return all(len(n.X.tombstoned_keys()) == 3
                           and not n.X.keys() for n in nodes)
            t0 = time.monotonic()
            while not reaped() and time.monotonic() - t0 < 20.0:
                for n in nodes:
                    n.check_healthy()
                await asyncio.sleep(0.1)
            assert reaped(), "; ".join(
                f"{n.id}:{sorted(n.X.keys())}" for n in nodes)
            assert sum(n.stats.by_kind.get("reap", 0) for n in nodes) > 0
            assert sum(n.stats.by_kind.get("reap-ack", 0)
                       for n in nodes) > 0
        finally:
            await stop_cluster(nodes)

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# A resident tensor store over TCP, held to the reference's join
# ---------------------------------------------------------------------------

CHUNK = 16
ROWS = (40, 24, 9, 33)                 # rows of each key's one tensor


def _initial(rng):
    return [rng.normal(size=(r, CHUNK)).astype(np.float32) for r in ROWS]


def _write_plan(rng, rounds=3):
    """Per round, per writer: (key index, sorted rows, values)."""
    plan = []
    for _ in range(rounds):
        per = []
        for _ in IDS:
            k = int(rng.integers(len(ROWS)))
            idx = np.sort(rng.choice(ROWS[k], size=min(6, ROWS[k]),
                                     replace=False))
            per.append((k, idx, rng.normal(size=(len(idx), CHUNK))
                        .astype(np.float32)))
        plan.append(per)
    return plan


def _reference_store(init, plan):
    """The JAX package: each writer's δ-mutation on its own converged
    store, all stores joined after every round."""
    import jax.numpy as jnp
    base = rcore.LatticeStore.of({f"k{i}": rtl.TensorState.of(
        {"w": rtl.ChunkedTensor(jnp.asarray(v), jnp.full(
            (len(v),), rtl.make_version(1, 0), jnp.int32))}, lamport=1)
        for i, v in enumerate(init)})
    stores = [base] * len(IDS)
    for per in plan:
        for rank, (k, idx, vals) in enumerate(per):
            cur = stores[rank].get(f"k{k}", rtl.TensorState)
            d = cur.write_delta(rank, "w", vals, chunk_idx=idx)
            stores[rank] = stores[rank].join(
                rcore.LatticeStore.key_delta(f"k{k}", d))
        joined = stores[0]
        for s in stores[1:]:
            joined = joined.join(s)
        stores = [joined] * len(IDS)
    return stores[0]


def _canonical(store):
    out = {}
    for key, val in store.entries:
        for name, ct in val.chunks:
            if ct.is_sparse:
                ct = ct.to_dense()
            v, r = ct.values, ct.versions
            v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            r = r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
            out[(key, name)] = (v.tobytes(), r.tobytes())
    return out


def test_resident_tensor_store_over_tcp_equals_the_reference_join():
    from repro_torch.core import LatticeStore, TensorState
    from repro_torch.core.digest import store_digest
    from repro_torch.core.propagation import stable_seed
    from repro_torch.core.tensor_lattice import ChunkedTensor, make_version
    from repro_torch.kernels import resident

    rng = np.random.default_rng(71)
    init = _initial(rng)
    plan = _write_plan(rng)

    def factory(node_id, neighbors):
        return StoreReplica(
            node_id, list(neighbors), causal=False, resident=True,
            device="cpu", wire=WireCodec(to_device=True, device="cpu"),
            policy=make_policy("digest-sync"),
            rng=random.Random(stable_seed(node_id)))

    async def scenario():
        nodes = await start_cluster(3, transport="tcp", tick=0.03,
                                    replica_factory=factory,
                                    start_gossip=False, seed=73)
        try:
            for n in nodes:
                model = {f"k{i}": TensorState.of({"w": ChunkedTensor(
                    torch.from_numpy(v), torch.full(
                        (len(v),), make_version(1, 0), dtype=torch.int32))},
                    lamport=1) for i, v in enumerate(init)}
                n.replica.operation(lambda _s, m=model: LatticeStore.of(m))
            await start_gossip(nodes)

            def agreed():
                d0 = store_digest(nodes[0].replica.store)
                return all(store_digest(n.replica.store) == d0
                           for n in nodes[1:])

            for per in plan:
                for rank, (n, (k, idx, vals)) in enumerate(zip(nodes, per)):
                    cur = n.replica.get(f"k{k}", TensorState)
                    n.replica.put(f"k{k}", cur.write_delta(
                        rank, "w", torch.from_numpy(vals), chunk_idx=idx))
                await wait_converged(nodes, timeout=30.0, poll=0.02,
                                     settle=agreed)
            for n in nodes:
                n.check_healthy()
                assert resident.resident_of(n.replica.store) is not None
            return ([n.replica.store for n in nodes],
                    sum(n.stats.recv_by_kind.get("digest-resp", 0)
                        for n in nodes))
        finally:
            await stop_cluster(nodes)

    stores, responses = asyncio.run(scenario())
    want = _canonical(_reference_store(init, plan))
    for s in stores:
        assert _canonical(s) == want
    assert responses >= len(plan) * 2
