"""The port's membership layer (``repro_torch.sync``) against the JAX
package's, on the same inputs and seeds. All comparisons are exact:

* ``rendezvous_score``, ``owners_for_key`` and ``KeyOwnership`` (owners,
  readers, subscriptions, relays, zone spreading, reshuffle under
  join/leave) give equal answers for 10,000 keys;
* ``ClusterState``/``Membership`` agree on workers, heartbeats,
  stragglers, evictions and quorums along one schedule;
* a ``ShardByKey`` session run (the ``serve --sessions`` shape: causal
  MVRegister sessions, whose dot-column bodies are byte-identical) gives
  the same per-gateway key counts, per-key settled values and frame
  bytes by kind as the reference, and ``RebalanceHandoff`` the same
  handoffs after a worker leaves;
* ``ClusterState`` frames (kind ``membership``) round-trip port to port
  with an equal ``opaque_hash`` — equal to the reference's hash of the
  same view, while the bytes name each package's module and differ by
  design — and ``ClusterReplica`` gossip reaches the reference's view
  with the same message counts.
"""

import random
from types import SimpleNamespace

import pytest

import repro.core as rcore
import repro.core.digest as rdigest
import repro.sync as rsync
import repro.topology as rtopo
import repro.wire as rwire
import repro_torch.core as tcore
import repro_torch.core.digest as tdigest
import repro_torch.sync as tsync
import repro_torch.topology as ttopo
import repro_torch.wire as twire

PKGS = {
    "jax": SimpleNamespace(core=rcore, sync=rsync, topo=rtopo, wire=rwire),
    "port": SimpleNamespace(core=tcore, sync=tsync, topo=ttopo, wire=twire),
}


def both(fn, *args, **kwargs):
    return fn(PKGS["jax"], *args, **kwargs), fn(PKGS["port"], *args,
                                                **kwargs)


def _keys(n=10_000, seed=0):
    rng = random.Random(seed)
    return [f"sess{rng.randrange(1 << 40)}" for _ in range(n)]


# ---------------------------------------------------------------------------
# Rendezvous ownership
# ---------------------------------------------------------------------------

def test_rendezvous_score_and_owners_for_key_match():
    workers = [f"w{k}" for k in range(7)]
    for key in _keys(2_000, seed=1):
        for w in workers:
            assert tsync.rendezvous_score(w, key) \
                == rsync.rendezvous_score(w, key)
        for r in (1, 2, 3):
            assert tsync.owners_for_key(key, workers, r) \
                == rsync.owners_for_key(key, workers, r)


def _ownership(pk, n, replication, read_replication, zones):
    ids = [f"gw{k}" for k in range(n)]
    topo = pk.topo.Topology.zoned(ids, zones) if zones else None
    return ids, pk.sync.KeyOwnership(ids, replication=replication,
                                     read_replication=read_replication,
                                     topology=topo)


@pytest.mark.parametrize("n,replication,read_replication,zones", [
    (3, 1, None, 0), (3, 2, None, 0), (5, 2, 3, 0), (8, 3, 5, 0),
    (6, 2, 4, 3), (9, 3, 5, 3), (4, 2, 2, 1), (7, 2, 3, 2),
])
def test_key_ownership_owners_match_for_10000_keys(n, replication,
                                                   read_replication, zones):
    def run(pk):
        ids, own = _ownership(pk, n, replication, read_replication, zones)
        keys = _keys()
        out = [(own.owners(k), own.owner(k), own.readers(k)) for k in keys]
        out.append(own.relays())
        out.append([own.owners_among(k, ids[1:]) for k in keys[:500]])
        out.append([[own.buffers(w, k), own.routes_pull(w, k)]
                    for k in keys[:300] for w in ids])
        return out
    want, got = both(run)
    assert got == want


def test_key_ownership_subscriptions_and_reshuffle_match():
    def run(pk):
        live = {f"w{k}" for k in range(6)}
        own = pk.sync.KeyOwnership(lambda: sorted(live), replication=2,
                                   read_replication=3)
        keys = _keys(2_000, seed=3)
        before = [own.owners(k) for k in keys]
        own.subscribe("w5", keys[0])
        own.subscribe("w4", keys[1])
        subs = [own.readers(k) for k in keys[:4]]
        own.unsubscribe("w5", keys[0])
        live.discard("w2")                    # leave: minimal reshuffle
        after_leave = [own.owners(k) for k in keys]
        live.add("w9")                        # join
        after_join = [own.owners(k) for k in keys]
        moved = sum(a != b for a, b in zip(before, after_leave))
        return before, subs, own.readers(keys[0]), after_leave, \
            after_join, moved
    want, got = both(run)
    assert got == want
    assert 0 < want[-1] < len(want[0])


def test_key_ownership_rejects_like_the_reference():
    for pk in PKGS.values():
        with pytest.raises(ValueError, match="replication"):
            pk.sync.KeyOwnership(["a"], replication=0)
        with pytest.raises(ValueError, match="read_replication"):
            pk.sync.KeyOwnership(["a"], replication=2, read_replication=1)


# ---------------------------------------------------------------------------
# Cluster views
# ---------------------------------------------------------------------------

def _membership_schedule(pk):
    C, M = pk.sync.ClusterState, pk.sync.Membership
    m0 = M("w0", timeout=10.0, evict_after=30.0)
    S = C.bottom()
    S = S.join(m0.announce(S, now=0.0))
    for w in ("w1", "w2", "w3"):
        S = S.join(S.join_delta(w, w, 0.0))
    seen = []
    for t in (5.0, 10.0, 15.0, 20.0, 25.0, 31.0):
        for w in ("w0", "w1", "w3"):
            S = S.join(m0.heartbeat(S, t) if w == "w0"
                       else S.beat_delta(w, t))
        seen.append((sorted(S.alive(t, 10.0)), sorted(S.stragglers(t, 10.0)),
                     sorted(m0.stale(S, t)), sorted(m0.quorum(S, t, 0.5))))
    evicted = S.join(m0.evictions(S, now=31.0))
    rejoin = S.join_delta("w2", "w2", 40.0)
    healed = [sorted(evicted.join(rejoin).workers()),
              sorted(rejoin.join(S).join(m0.evictions(S, 31.0)).workers())]
    return seen, sorted(evicted.workers()), healed, \
        [S.heartbeats.last_seen(w) for w in ("w0", "w1", "w2", "w3", "x")]


def test_cluster_state_schedule_matches_reference():
    want, got = both(_membership_schedule)
    assert got == want


def _cluster(pk):
    C = pk.sync.ClusterState
    S = C.bottom()
    for w in ("w0", "w1", "w2"):
        S = S.join(S.join_delta(w, w, 1.5))
    S = S.join(S.beat_delta("w1", 7.25)).join(S.leave_delta("w0", "w2"))
    return S


def test_cluster_state_frames_round_trip_port_to_port():
    state = _cluster(PKGS["port"])
    codec = twire.WireCodec()
    for msg in (("delta", state), ("delta", state, 3, None)):
        frame = codec.encode_msg(msg)
        assert frame.kind == "membership"
        assert twire.decode_frame(frame)[0] == "membership"
        back = codec.decode_msg(frame)
        assert back[0] == "delta" and back[2:] == msg[2:]
        assert back[1] == state
        assert tdigest.opaque_hash(back[1]) == tdigest.opaque_hash(state)
    full = codec.encode_msg(("delta", state), full_state=True)
    assert full.kind == "membership"
    # the same view hashes alike in both packages; its bytes name the
    # package's module, so the frames differ by design
    ref = _cluster(PKGS["jax"])
    assert tdigest.opaque_hash(state) == rdigest.opaque_hash(ref)
    rframe = rwire.WireCodec().encode_msg(("delta", ref))
    assert rframe.kind == "membership"
    assert bytes(rframe) != bytes(codec.encode_msg(("delta", state)))


def _cluster_replicas(pk, seed, wire):
    ids = ["w0", "w1", "w2", "w3"]
    sim = pk.core.Simulator(pk.core.NetConfig(loss=0.2, dup=0.1, seed=seed))
    nodes = [sim.add_node(pk.sync.ClusterReplica(
        i, [j for j in ids if j != i],
        policy=pk.core.make_policy("bp+rr"), rng=random.Random(seed + k),
        timeout=5.0, evict_after=12.0,
        wire=pk.wire.WireCodec() if wire else None))
        for k, i in enumerate(ids)]
    for n in nodes:
        n.announce(0.0)
    for t in range(1, 16):
        for n in nodes[:3]:                   # w3 goes silent
            n.heartbeat(float(t))
        sim.run_for(1.0)
        for n in nodes:
            n.on_periodic()
    evicted = nodes[0].evict_stragglers(16.0)
    pk.core.run_to_convergence(sim, nodes, interval=1.0, max_time=60_000)
    views = [(sorted(n.X.workers()), sorted(n.alive_workers(16.0)),
              sorted(n.quorum(16.0))) for n in nodes]
    return (sorted(evicted), views, dict(sim.stats.by_kind),
            sim.stats.sent, sim.stats.delivered)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wire", [True, False], ids=["wire", "objects"])
def test_cluster_replica_gossip_matches_reference(seed, wire):
    """Opaque ClusterState bodies differ in length between the packages,
    so only views and message counts are held equal."""
    want, got = both(_cluster_replicas, seed, wire)
    assert got == want
    assert want[0] == ["w3"]
    if wire:
        assert want[2].get("membership", 0) > 0


# ---------------------------------------------------------------------------
# Sharded session stores
# ---------------------------------------------------------------------------

def _sharded_sessions(pk, seed, policy, replication, n_sessions, n_gw):
    ids = [f"gw{k}" for k in range(n_gw)]
    own = pk.sync.KeyOwnership(ids, replication=replication)
    sim = pk.core.Simulator(pk.core.NetConfig(loss=0.25, dup=0.1, seed=seed))
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.Compose(pk.core.make_policy(policy),
                               pk.sync.ShardByKey(own)),
        rng=random.Random(seed + k), ownership=own,
        wire=pk.wire.WireCodec())) for k, i in enumerate(ids)]
    for n in nodes:
        sim.every(1.0, n.on_periodic)
        sim.every(7.0, n.gc_deltas)
    keys = [f"sess{s}" for s in range(n_sessions)]
    for s, key in enumerate(keys):
        gw = nodes[s % len(nodes)]
        for status in ("queued", "prefilling", "decoding", "done"):
            gw.update(key, pk.core.MVRegister, "write_delta", gw.id, status)
        if s % 8 == 7:
            sim.run_for(0.5)
    by_id = {n.id: n for n in nodes}

    def settled():
        for key in keys:
            states = [by_id[w].get(key, pk.core.MVRegister)
                      for w in own.owners(key)]
            if any(s != states[0] for s in states[1:]) \
                    or states[0].read() != frozenset({"done"}):
                return False
        return True

    t0 = sim.time
    while sim.time - t0 < 10_000 and not settled():
        sim.run_for(2.0)
    assert settled()
    per_gw = {i: len([k for k in keys if own.replicates(i, k)])
              for i in ids}
    held = {i: sorted(by_id[i].X.keys()) for i in ids}
    return (per_gw, held, dict(sim.stats.bytes_by_kind),
            dict(sim.stats.by_kind), sim.stats.payload_atoms(), sim.time)


@pytest.mark.parametrize("seed,policy,replication,n_sessions,n_gw", [
    (0, "bp+rr", 2, 24, 3),
    (1, "bp+rr+digest-sync:4", 2, 40, 3),
    (2, "digest-sync", 2, 16, 4),
    (3, "bp+rr", 3, 30, 5),
    (4, "every:2", 1, 20, 3),
])
def test_shard_by_key_session_run_matches_reference(seed, policy,
                                                    replication, n_sessions,
                                                    n_gw):
    want, got = both(_sharded_sessions, seed, policy, replication,
                     n_sessions, n_gw)
    assert got == want


def _rebalance(pk, seed):
    live = {f"w{k}" for k in range(5)}
    own = pk.sync.KeyOwnership(lambda: sorted(live), replication=2)
    ids = sorted(live)
    sim = pk.core.Simulator(pk.core.NetConfig(seed=seed))
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.Compose(pk.core.make_policy("bp+rr"),
                               pk.sync.ShardByKey(own)),
        rng=random.Random(seed + k), ownership=own,
        wire=pk.wire.WireCodec())) for k, i in enumerate(ids)]
    agents = [pk.sync.RebalanceHandoff(n, own) for n in nodes]
    keys = [f"k{j}" for j in range(30)]
    by_id = {n.id: n for n in nodes}
    for j, key in enumerate(keys):
        w = by_id[own.owner(key)]
        w.update(key, pk.core.MVRegister, "write_delta", w.id, f"v{j}")
    for _ in range(10):
        for n in nodes:
            n.on_periodic()
        sim.run_for(1.0)
    live.discard("w1")
    by_id["w1"].alive = False
    pushed = [a.check() for a in agents if a.replica.id != "w1"]
    sim.run_for(2.0)
    held = {n.id: sorted(k for k in keys if n.X.get(k) is not None)
            for n in nodes if n.id != "w1"}
    return pushed, held, dict(sim.stats.by_kind), \
        dict(sim.stats.bytes_by_kind)


@pytest.mark.parametrize("seed", [5, 6])
def test_rebalance_handoff_matches_reference(seed):
    want, got = both(_rebalance, seed)
    assert got == want
    assert sum(want[0]) > 0 and want[2].get("handoff", 0) > 0
