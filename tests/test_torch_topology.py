"""The port's topology layer and hierarchical gossip against the JAX
package's, on the same inputs and seeds. All comparisons are exact:

* ``zone_region``, ``link_class``, ``hrw_score``, ``relay_for``,
  ``parse_zone_map`` and the ``Topology`` helpers (zones, members,
  relays, byte costs, round-robin zoning) return equal values;
* a zoned ``Simulator`` run under ``HierarchicalGossip`` (frames on the
  wire, MVRegister values, whose dot-column bodies are byte-identical
  between the packages) gives the same message and byte counts per kind
  and per link class, the same link cost and the same converged read
  sets as the reference — flat and zoned, with a zone partition, with a
  relay failover and composed with ``ShardByKey``.
"""

import dataclasses
import random
from types import SimpleNamespace

import pytest

import repro.core as rcore
import repro.core.hiergossip as rhier
import repro.sync as rsync
import repro.topology as rtopo
import repro.wire as rwire
import repro_torch.core as tcore
import repro_torch.core.hiergossip as thier
import repro_torch.sync as tsync
import repro_torch.topology as ttopo
import repro_torch.wire as twire

PKGS = {
    "jax": SimpleNamespace(core=rcore, hier=rhier, sync=rsync, topo=rtopo,
                           wire=rwire),
    "port": SimpleNamespace(core=tcore, hier=thier, sync=tsync, topo=ttopo,
                            wire=twire),
}


def both(fn, *args, **kwargs):
    """``fn`` run on each package; returns (jax result, port result)."""
    return fn(PKGS["jax"], *args, **kwargs), fn(PKGS["port"], *args,
                                                **kwargs)


# ---------------------------------------------------------------------------
# Pure functions
# ---------------------------------------------------------------------------

ZONES = ["eu/a", "eu/b", "us/a", "us/b", "z0", "z1", "ap/x", ""]


@pytest.mark.parametrize("a", ZONES)
def test_zone_region_and_link_class_match(a):
    for b in ZONES:
        assert ttopo.link_class(a, b) == rtopo.link_class(a, b)
    assert ttopo.zone_region(a) == rtopo.zone_region(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hrw_score_matches(seed):
    rng = random.Random(seed)
    for _ in range(500):
        member = f"w{rng.randrange(10_000)}"
        key = f"relay:z{rng.randrange(50)}" if rng.random() < 0.5 \
            else f"key{rng.randrange(1 << 30)}"
        assert ttopo.hrw_score(member, key) == rtopo.hrw_score(member, key)


@pytest.mark.parametrize("n,n_zones", [(3, 3), (7, 3), (9, 2), (12, 4)])
def test_relay_for_and_topology_helpers_match(n, n_zones):
    ids = [f"w{k}" for k in range(n)]
    rt = rtopo.Topology.zoned(ids, n_zones, profiles=rtopo.DEFAULT_PROFILES)
    tt = ttopo.Topology.zoned(ids, n_zones, profiles=ttopo.DEFAULT_PROFILES)
    assert tt.by_zone(ids) == rt.by_zone(ids)
    assert tt.zone_names(ids) == rt.zone_names(ids)
    live_sets = [ids, ids[1:], ids[::2], list(reversed(ids))]
    for z in rt.zone_names(ids) + ("z9",):
        assert tt.members(z, ids) == rt.members(z, ids)
        for live in live_sets:
            assert tt.relay(z, live) == rt.relay(z, live)
            assert ttopo.relay_for(z, live, tt.zone) \
                == rtopo.relay_for(z, live, rt.zone)
    for a in ids + ["stranger"]:
        assert tt.zone(a) == rt.zone(a)
        for b in ids:
            assert tt.link_class(a, b) == rt.link_class(a, b)
            assert tt.byte_cost(a, b) == rt.byte_cost(a, b)
    flat_r, flat_t = rtopo.Topology.flat(ids), ttopo.Topology.flat(ids)
    assert flat_t.zone_names(ids) == flat_r.zone_names(ids)


def test_link_profiles_match():
    assert set(ttopo.DEFAULT_PROFILES) == set(rtopo.DEFAULT_PROFILES)
    for cls, prof in rtopo.DEFAULT_PROFILES.items():
        assert dataclasses.asdict(ttopo.DEFAULT_PROFILES[cls]) \
            == dataclasses.asdict(prof)
    assert (ttopo.INTRA, ttopo.INTER, ttopo.WAN) \
        == (rtopo.INTRA, rtopo.INTER, rtopo.WAN)


@pytest.mark.parametrize("spec", [
    "gw0=eu/a, gw1=eu/b", "a=z0,b=z1,c=z0", " x = us/west ", None,
    {"a": "z"}, "",
])
def test_parse_zone_map_matches(spec):
    assert ttopo.parse_zone_map(spec) == rtopo.parse_zone_map(spec)


@pytest.mark.parametrize("spec", ["gw0", "a=z0,b", "=z0"])
def test_parse_zone_map_rejects_like_the_reference(spec):
    with pytest.raises(ValueError) as want:
        rtopo.parse_zone_map(spec)
    with pytest.raises(ValueError) as got:
        ttopo.parse_zone_map(spec)
    assert str(got.value) == str(want.value)


def test_topology_rejects_unknown_link_class_like_the_reference():
    with pytest.raises(ValueError, match="unknown link class"):
        ttopo.Topology({}, profiles={"submarine": ttopo.LinkProfile()})
    with pytest.raises(ValueError, match="at least one zone"):
        ttopo.Topology.zoned(["a"], 0)


def test_hierarchical_policy_names_and_validation_match():
    for pk in PKGS.values():
        topo = pk.topo.Topology.zoned(["a", "b"], 2)
        with pytest.raises(ValueError, match="inter_every"):
            pk.hier.HierarchicalGossip(topo, inter_every=0)
    names = both(lambda pk: [
        pk.core.hierarchical_policy(pk.topo.Topology.zoned(["a", "b"], 2)
                                    ).name,
        pk.hier.HierarchicalGossip(pk.topo.Topology.zoned(["a"], 1),
                                   inter_every=3).name,
        type(pk.core.hierarchical_policy(
            pk.topo.Topology.zoned(["a"], 1), base=None)).__name__])
    assert names[0] == names[1]


# ---------------------------------------------------------------------------
# Simulator runs under hierarchical gossip
# ---------------------------------------------------------------------------

def _stats(sim) -> dict:
    s = sim.stats
    return {"sent": s.sent, "delivered": s.delivered, "dropped": s.dropped,
            "duplicated": s.duplicated, "bytes_sent": s.bytes_sent,
            "by_kind": dict(s.by_kind), "bytes_by_kind": dict(s.bytes_by_kind),
            "by_class": dict(s.by_class),
            "bytes_by_class": dict(s.bytes_by_class),
            "link_cost": s.link_cost}


def _reads(nodes, keys) -> dict:
    out = {}
    for n in nodes:
        for k in keys:
            v = n.get(k)
            out[(n.id, k)] = (sorted(map(repr, v.read()))
                              if v is not None else None)
    return out


def _zoned_run(pk, n, n_zones, seed, hier, profiles, inter_every=4,
               loss=0.0):
    ids = [f"w{k}" for k in range(n)]
    topo = pk.topo.Topology.zoned(
        ids, n_zones, profiles=pk.topo.DEFAULT_PROFILES if profiles else None)
    sim = pk.core.Simulator(pk.core.NetConfig(seed=seed, loss=loss),
                            topology=topo)

    def policy():
        if hier:
            return pk.core.hierarchical_policy(topo, inter_every=inter_every)
        return pk.core.make_policy("bp+rr")
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True, policy=policy(),
        rng=random.Random(seed + k), wire=pk.wire.WireCodec()))
        for k, i in enumerate(ids)]
    for nd in nodes:
        sim.every(1.0, nd.on_periodic)
        sim.every(7.0, nd.gc_deltas)
    rng = random.Random(seed + 100)
    keys = [f"k{j}" for j in range(6)]
    for t in range(24):
        nd = rng.choice(nodes)
        nd.update(keys[t % 6], pk.core.MVRegister, "write_delta", nd.id,
                  f"v{t}")
        sim.run_for(1.0)
    deadline = sim.time + 10_000
    while sim.time < deadline and not pk.core.converged(nodes):
        sim.run_for(5.0)
    assert pk.core.converged(nodes)
    return _stats(sim), _reads(nodes, keys), sim.time


@pytest.mark.parametrize("n,n_zones,seed,hier,profiles,inter_every,loss", [
    (3, 3, 1, True, False, 4, 0.0),
    (6, 3, 2, True, True, 4, 0.0),
    (9, 3, 3, True, False, 2, 0.1),
    (8, 2, 4, True, True, 1, 0.2),
    (9, 3, 5, False, True, 4, 0.0),
])
def test_zoned_simulator_run_matches_reference(n, n_zones, seed, hier,
                                               profiles, inter_every, loss):
    want, got = both(_zoned_run, n, n_zones, seed, hier, profiles,
                     inter_every, loss)
    assert got == want
    assert want[0]["bytes_by_class"], "no frame was link-classed"


def _partition_run(pk, seed):
    ids = [f"w{k}" for k in range(6)]
    topo = pk.topo.Topology.zoned(ids, 3, profiles=pk.topo.DEFAULT_PROFILES)
    sim = pk.core.Simulator(pk.core.NetConfig(seed=seed), topology=topo)
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.hierarchical_policy(topo),
        rng=random.Random(seed + 1), wire=pk.wire.WireCodec()))
        for i in ids]
    for nd in nodes:
        sim.every(1.0, nd.on_periodic)
    t0 = sim.time
    sim.add_zone_partition(t0, t0 + 20.0, "z1")
    inside = [nd for nd in nodes if topo.zone(nd.id) == "z1"]
    outside = [nd for nd in nodes if topo.zone(nd.id) != "z1"]
    for t in range(8):
        a = inside[t % len(inside)]
        a.update(f"in{t % 3}", pk.core.MVRegister, "write_delta", a.id, t)
        b = outside[t % len(outside)]
        b.update(f"out{t % 3}", pk.core.MVRegister, "write_delta", b.id, t)
        sim.run_for(2.0)
    sim.run_until(t0 + 20.0)
    deadline = sim.time + 10_000
    while sim.time < deadline and not pk.core.converged(nodes):
        sim.run_for(5.0)
    assert pk.core.converged(nodes)
    keys = [f"{s}{j}" for s in ("in", "out") for j in range(3)]
    return _stats(sim), _reads(nodes, keys)


@pytest.mark.parametrize("seed", [9, 10])
def test_zone_partition_run_matches_reference(seed):
    want, got = both(_partition_run, seed)
    assert got == want


def _failover_run(pk, seed):
    ids = [f"w{k}" for k in range(9)]
    topo = pk.topo.Topology.zoned(ids, 3)
    sim = pk.core.Simulator(pk.core.NetConfig(seed=seed), topology=topo)
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.hierarchical_policy(topo, inter_every=4),
        rng=random.Random(seed + 1), wire=pk.wire.WireCodec()))
        for i in ids]
    for t, nd in enumerate(nodes):
        nd.update(f"pre{t % 4}", pk.core.MVRegister, "write_delta", nd.id, t)
    pk.core.run_to_convergence(sim, nodes, interval=1.0, max_time=60_000)
    old = topo.relay("z0", ids)
    by_id = {nd.id: nd for nd in nodes}
    by_id[old].alive = False
    survivors = [nd for nd in nodes if nd.id != old]
    for nd in survivors:
        nd.neighbors.remove(old)
        nd.prune_departed()
    z0 = [nd for nd in survivors if topo.zone(nd.id) == "z0"]
    for t in range(6):
        nd = z0[t % len(z0)]
        nd.update("post", pk.core.MVRegister, "write_delta", nd.id, f"p{t}")
        sim.run_for(0.5)
    pk.core.run_to_convergence(sim, survivors, interval=1.0,
                               max_time=60_000)
    assert pk.core.converged(survivors)
    new = topo.relay("z0", [i for i in ids if i != old])
    return (old, new, _stats(sim),
            _reads(survivors, ["post"] + [f"pre{j}" for j in range(4)]))


def test_relay_failover_run_matches_reference():
    want, got = both(_failover_run, 11)
    assert got == want
    assert want[0] != want[1]


def _sharded_hier_run(pk, seed):
    ids = [f"w{k}" for k in range(6)]
    topo = pk.topo.Topology.zoned(ids, 3)
    own = pk.sync.KeyOwnership(ids, replication=3, topology=topo)
    sim = pk.core.Simulator(pk.core.NetConfig(seed=seed), topology=topo)
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.Compose(pk.core.make_policy("bp+rr"),
                               pk.sync.ShardByKey(own),
                               pk.hier.HierarchicalGossip(topo)),
        rng=random.Random(seed + 1), ownership=own,
        wire=pk.wire.WireCodec())) for i in ids]
    by_id = {nd.id: nd for nd in nodes}
    rng = random.Random(seed + 2)
    keys = [f"k{j}" for j in range(6)]
    for t in range(24):
        key = keys[t % 6]
        nd = by_id[rng.choice(own.owners(key))]
        nd.update(key, pk.core.MVRegister, "write_delta", nd.id, f"v{t}")
        if rng.random() < 0.5:
            sim.run_for(0.4)
    for nd in nodes:
        sim.every(1.0, nd.on_periodic)
        sim.every(7.0, nd.gc_deltas)

    def settled():
        for k in keys:
            vals = [by_id[w].get(k, pk.core.MVRegister).read()
                    for w in own.owners(k)]
            if any(v != vals[0] for v in vals[1:]):
                return False
        return True

    deadline = sim.time + 10_000
    while sim.time < deadline and not settled():
        sim.run_for(5.0)
    assert settled()
    owners = {k: own.owners(k) for k in keys}
    return owners, _stats(sim), _reads(nodes, keys)


@pytest.mark.parametrize("seed", [13, 14])
def test_hierarchical_with_shard_by_key_matches_reference(seed):
    want, got = both(_sharded_hier_run, seed)
    assert got == want
