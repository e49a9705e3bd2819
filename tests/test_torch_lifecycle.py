"""The port's reaper (``repro_torch.lifecycle.ReaperProtocol``) against
the JAX package's, on the same seeds. A TTL run in each package must
leave the same tombstone set, the same live keys and the same lifecycle
entry ``(epoch, expiry)`` per key on every gateway, with equal reap and
eviction counts and equal message counts per kind (frame bytes too where
frames cross and every body is a causal dot column; in object mode the
simulator counts structural atoms of each package's own objects, which
differ by design). All comparisons are exact. The
scenarios are the reference's own lifecycle tests: full-quorum reaps with
a touched key, a partitioned member, a straggler replay, a touch that
cancels a proposal, a crashed proposer, a departed peer, foreign ingress
copies, read replicas, and the randomized write/expire/reap schedule."""

import random
from types import SimpleNamespace

import pytest

import repro.core as rcore
import repro.lifecycle as rlife
import repro.sync as rsync
import repro.wire as rwire
import repro_torch.core as tcore
import repro_torch.lifecycle as tlife
import repro_torch.sync as tsync
import repro_torch.wire as twire

PKGS = {
    "jax": SimpleNamespace(core=rcore, life=rlife, sync=rsync, wire=rwire),
    "port": SimpleNamespace(core=tcore, life=tlife, sync=tsync, wire=twire),
}


def both(fn, *args, **kwargs):
    return fn(PKGS["jax"], *args, **kwargs), fn(PKGS["port"], *args,
                                                **kwargs)


def _codec(pk, wire):
    if wire == "wire":
        return pk.wire.WireCodec()
    if wire == "wire-z":
        return pk.wire.WireCodec(True)
    return None


def _outcome(sim, nodes, reapers, keys, bytes_too=True) -> dict:
    out = {}
    for n in nodes:
        X = n.X
        out[n.id] = {
            "tombstones": sorted(X.tombstoned_keys()),
            "live": sorted(X.keys()),
            "all": sorted(X.all_keys()),
            "life": {k: X.life_of(k) for k in keys},
            "reads": {k: sorted(map(repr, v.read()))
                      for k in keys if (v := X.get(k)) is not None},
        }
    out["reaped"] = [r.reaped for r in reapers]
    out["evicted"] = [r.evicted for r in reapers]
    out["by_kind"] = dict(sim.stats.by_kind)
    if bytes_too:
        out["bytes_by_kind"] = dict(sim.stats.bytes_by_kind)
    return out


def _mesh(pk, wire=None, replication=2, ttl=5.0, loss=0.1, seed=3,
          read_replication=None, n=3):
    ids = [f"gw{k}" for k in range(n)]
    own = pk.sync.KeyOwnership(ids, replication=replication,
                               read_replication=read_replication)
    sim = pk.core.Simulator(pk.core.NetConfig(loss=loss, seed=seed))
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.Compose(pk.core.make_policy("bp+rr+digest-sync:4"),
                               pk.sync.ShardByKey(own)),
        rng=random.Random(seed + k), ownership=own, wire=_codec(pk, wire),
        ttl=ttl)) for k, i in enumerate(ids)]
    reapers = [pk.life.ReaperProtocol(node, own, grace=1.0, retry=2.0)
               for node in nodes]
    for node in nodes:
        sim.every(1.0, node.on_periodic)
        sim.every(7.0, node.gc_deltas)
    return sim, nodes, reapers, own


def _full_quorum(pk, wire):
    sim, nodes, reapers, own = _mesh(pk, wire=wire)
    keys = [f"sess{i}" for i in range(8)]
    for i, key in enumerate(keys):
        nodes[i % 3].update(key, pk.core.MVRegister, "write_delta",
                            nodes[i % 3].id, "done")
    sim.run_for(3.0)
    for t in range(25):
        nodes[0].update("sess0", pk.core.MVRegister, "write_delta", "gw0",
                        f"w{t}")
        sim.run_for(1.0)
    return _outcome(sim, nodes, reapers, keys, bytes_too=wire is not None)


@pytest.mark.parametrize("wire", [None, "wire", "wire-z"])
def test_full_quorum_reap_matches_reference(wire):
    want, got = both(_full_quorum, wire)
    assert got == want
    assert len(want["gw0"]["tombstones"]) + len(want["gw1"]["tombstones"]) \
        + len(want["gw2"]["tombstones"]) >= 7


def _partitioned(pk, seed):
    sim, nodes, reapers, own = _mesh(pk, loss=0.0, seed=seed, wire="wire")
    nodes[0].update("cold", pk.core.MVRegister, "write_delta", "gw0", "x")
    sim.run_for(3.0)
    owners = own.owners("cold")
    blocked = owners[1]
    sim.add_partition(sim.time, sim.time + 20.0, [blocked],
                      [n.id for n in nodes if n.id != blocked])
    sim.run_for(18.0)
    during = _outcome(sim, nodes, reapers, ["cold"])
    sim.run_for(30.0)
    return during, _outcome(sim, nodes, reapers, ["cold"])


@pytest.mark.parametrize("seed", [11, 12])
def test_partitioned_member_reap_matches_reference(seed):
    want, got = both(_partitioned, seed)
    assert got == want


def _straggler(pk, wire):
    sim, nodes, reapers, own = _mesh(pk, wire=wire, loss=0.0, seed=17)
    by_id = {n.id: n for n in nodes}
    owners = own.owners("ghost")
    straggler = [i for i in by_id if i not in owners][0]
    ingress = by_id[straggler]
    ingress.update("ghost", pk.core.MVRegister, "write_delta", straggler,
                   "alive")
    sim.run_for(3.0)
    pre_reap = ingress.X.restrict(["ghost"])
    sim.run_for(30.0)
    codec = _codec(pk, wire)
    for w in owners:
        by_id[w].on_receive(straggler,
                            codec.encode_msg(("handoff", pre_reap))
                            if codec else ("handoff", pre_reap))
    return _outcome(sim, nodes, reapers, ["ghost"],
                    bytes_too=wire is not None)


@pytest.mark.parametrize("wire", [None, "wire"])
def test_straggler_replay_matches_reference(wire):
    want, got = both(_straggler, wire)
    assert got == want


def _touch_cancels(pk):
    sim, nodes, reapers, own = _mesh(pk, loss=0.0, seed=23, ttl=4.0,
                                     wire="wire")
    primary = {n.id: n for n in nodes}[own.owners("busy")[0]]
    primary.update("busy", pk.core.MVRegister, "write_delta", primary.id,
                   "v0")
    sim.run_for(5.5)
    primary.update("busy", pk.core.MVRegister, "write_delta", primary.id,
                   "v1")
    sim.run_for(2.0)
    mid = _outcome(sim, nodes, reapers, ["busy"])
    sim.run_for(30.0)
    return mid, _outcome(sim, nodes, reapers, ["busy"])


def test_touched_key_run_matches_reference():
    want, got = both(_touch_cancels)
    assert got == want


def _crash(pk):
    sim, nodes, reapers, own = _mesh(pk, loss=0.0, seed=29, wire="wire")
    primary = {n.id: n for n in nodes}[own.owners("crashkey")[0]]
    primary.update("crashkey", pk.core.MVRegister, "write_delta",
                   primary.id, "x")
    sim.run_for(7.0)
    sim.crash(primary.id, 3.0)
    pending = sorted(primary.reaper.pending_keys())
    sim.run_for(35.0)
    return pending, _outcome(sim, nodes, reapers, ["crashkey"])


def test_crashed_proposer_run_matches_reference():
    want, got = both(_crash)
    assert got == want


def _departed(pk):
    ids = ["gw0", "gw1", "gw2"]
    live = set(ids)
    own = pk.sync.KeyOwnership(lambda: sorted(live), replication=3)
    sim = pk.core.Simulator(pk.core.NetConfig(loss=0.0, seed=31))
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.make_policy("bp+rr"), rng=random.Random(31 + k),
        ownership=own, ttl=4.0, wire=pk.wire.WireCodec()))
        for k, i in enumerate(ids)]
    reapers = [pk.life.ReaperProtocol(n, own, grace=0.5, retry=1.0)
               for n in nodes]
    for n in nodes:
        sim.every(1.0, n.on_periodic)
    by_id = {n.id: n for n in nodes}
    primary = by_id[own.owner("doomed")]
    dead = [i for i in ids if i != primary.id][0]
    sim.nodes[dead].alive = False
    primary.update("doomed", pk.core.MVRegister, "write_delta", primary.id,
                   "x")
    sim.run_for(10.0)
    stuck = _outcome(sim, nodes, reapers, ["doomed"])
    live.discard(dead)
    primary.neighbors = [j for j in primary.neighbors if j != dead]
    primary.prune_departed()
    sim.run_for(10.0)
    return stuck, _outcome(sim, nodes, reapers, ["doomed"])


def test_departed_peer_run_matches_reference():
    want, got = both(_departed)
    assert got == want


def _foreign(pk):
    sim, nodes, reapers, own = _mesh(pk, loss=0.0, seed=37, wire="wire")
    by_id = {n.id: n for n in nodes}
    owners = own.owners("fkey")
    foreign = [i for i in by_id if i not in owners][0]
    by_id[foreign].update("fkey", pk.core.MVRegister, "write_delta",
                          foreign, "x")
    sim.run_for(33.0)
    return _outcome(sim, nodes, reapers, ["fkey"])


def test_foreign_ingress_eviction_matches_reference():
    want, got = both(_foreign)
    assert got == want
    assert sum(want["evicted"]) >= 1


def _read_replica(pk):
    sim, nodes, reapers, own = _mesh(pk, loss=0.0, seed=41, n=4,
                                     wire="wire")
    by_id = {n.id: n for n in nodes}
    owners = own.owners("hot")
    reader = [i for i in by_id if i not in owners][0]
    own.subscribe(reader, "hot")
    writer = by_id[owners[0]]
    for t in range(8):
        writer.update("hot", pk.core.MVRegister, "write_delta", writer.id,
                      f"v{t}")
        sim.run_for(1.0)
    sim.run_for(8.0)
    served = _outcome(sim, nodes, reapers, ["hot"])
    sim.run_for(60.0)
    return served, _outcome(sim, nodes, reapers, ["hot"])


def test_read_replica_run_matches_reference():
    want, got = both(_read_replica)
    assert got == want


def _schedule(pk, seed, wire):
    """The reference's randomized write/expire/reap schedule (GCounter
    values under loss, duplication, partitions, crashes and straggler
    replays). GCounter bodies ride opaque, so bytes are not compared."""
    rng = random.Random(seed)
    ids = ["n0", "n1", "n2"]
    own = pk.sync.KeyOwnership(ids, replication=2)
    codec = pk.wire.WireCodec() if wire else None
    sim = pk.core.Simulator(pk.core.NetConfig(
        loss=rng.choice([0.0, 0.15, 0.3]), dup=0.1, seed=seed))
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.Compose(pk.core.make_policy("bp+rr+digest-sync:4"),
                               pk.sync.ShardByKey(own)),
        rng=random.Random(seed + k), ownership=own, wire=codec,
        ttl=6.0)) for k, i in enumerate(ids)]
    reapers = []
    for node in nodes:
        reapers.append(pk.life.ReaperProtocol(node, own, grace=1.0,
                                              retry=1.5))
        sim.every(1.0, node.on_periodic)
        sim.every(5.0, node.gc_deltas)
    keys = [f"k{i}" for i in range(5)]
    keep_alive = sorted(rng.sample(keys, 2))
    captured = []

    def replay():
        if not captured:
            return
        d = rng.choice(captured)
        dst = rng.choice(nodes)
        msg = ("handoff", d)
        dst.on_receive(rng.choice(ids),
                       codec.encode_msg(msg) if codec else msg)

    for _ in range(35):
        node = rng.choice([n for n in nodes if n.alive])
        key = rng.choice(keys)
        node.update(key, pk.core.GCounter, "inc_delta", node.id, 1)
        captured.append(node.X.restrict([key]))
        for ka in keep_alive:
            toucher = rng.choice([n for n in nodes if n.alive])
            toucher.update(ka, pk.core.GCounter, "inc_delta", toucher.id, 1)
        if rng.random() < 0.10:
            cut = rng.choice(ids)
            sim.add_partition(sim.time, sim.time + rng.uniform(2.0, 5.0),
                              [cut], [i for i in ids if i != cut])
        if rng.random() < 0.08:
            sim.crash(rng.choice(ids), rng.uniform(1.0, 3.0))
        if rng.random() < 0.25:
            replay()
        sim.run_for(rng.uniform(0.5, 1.5))
    mid = {n.id: sorted(n.X.tombstoned_keys()) for n in nodes}
    sim.run_for(60.0)
    for _ in keys:
        replay()
    sim.run_for(20.0)
    out = _outcome(sim, nodes, reapers, keys, bytes_too=False)
    for n in nodes:
        out[n.id]["reads"] = {k: n.X.get(k, pk.core.GCounter).value()
                              for k in keys}
    return mid, out


@pytest.mark.parametrize("seed,wire", [(0, False), (1, True), (2, False),
                                       (3, True), (4, True)])
def test_lifecycle_schedule_matches_reference(seed, wire):
    want, got = both(_schedule, seed, wire)
    assert got == want
    for n in ("n0", "n1", "n2"):
        assert set(want[1][n]["tombstones"]) <= {f"k{i}" for i in range(5)}


def _sessions_ttl(pk, seed, n_sessions, ttl):
    """``serve --sessions N --session-ttl T``'s simulator run."""
    ids = ["gw0", "gw1", "gw2"]
    own = pk.sync.KeyOwnership(ids, replication=2)
    sim = pk.core.Simulator(pk.core.NetConfig(loss=0.25, dup=0.1, seed=seed))
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.Compose(pk.core.make_policy("bp+rr"),
                               pk.sync.ShardByKey(own)),
        rng=random.Random(seed + k), ownership=own,
        wire=pk.wire.WireCodec(), ttl=ttl)) for k, i in enumerate(ids)]
    reapers = []
    for n in nodes:
        reapers.append(pk.life.ReaperProtocol(n, own, grace=1.0, retry=2.0))
        sim.every(1.0, n.on_periodic)
        sim.every(7.0, n.gc_deltas)
    keys = [f"sess{s}" for s in range(n_sessions)]
    for s, key in enumerate(keys):
        gw = nodes[s % 3]
        for status in ("queued", "prefilling", "decoding", "done"):
            gw.update(key, pk.core.MVRegister, "write_delta", gw.id, status)
        if s % 8 == 7:
            sim.run_for(0.5)
    sim.run_for(ttl + 200.0)
    return _outcome(sim, nodes, reapers, keys)


@pytest.mark.parametrize("seed,n_sessions,ttl", [(0, 24, 5.0),
                                                 (7, 40, 3.0)])
def test_session_ttl_run_matches_reference(seed, n_sessions, ttl):
    want, got = both(_sessions_ttl, seed, n_sessions, ttl)
    assert got == want
    for gw in ("gw0", "gw1", "gw2"):
        assert want[gw]["live"] == []


def test_reap_frames_round_trip_like_the_reference():
    msgs = [("reap", "sess0", 3, 17.5), ("reap-ack", "k/é", 1, 2.25, 1),
            ("reap-ack", "x", 0, 0.0, 0)]
    for msg in msgs:
        t = twire.WireCodec().encode_msg(msg)
        r = rwire.WireCodec().encode_msg(msg)
        assert bytes(t) == bytes(r) and t.kind == r.kind == msg[0]
        assert twire.WireCodec().decode_msg(t) == msg
