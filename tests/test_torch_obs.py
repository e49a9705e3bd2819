"""The port's observability layer (``repro_torch.obs``) against the JAX
package's, on the same recorded inputs. All comparisons are exact:

* the registry renders the same Prometheus text and the same JSON
  snapshot for the same families, observations and absorbed stats
  objects (``repro_net_*``, ``repro_kernel_*``, ``repro_crdt_*``,
  ``repro_replica_*``, ``repro_ack_*``, ``repro_reap_*``), and refuses
  the same declarations;
* the tracer keeps, samples and sinks the same events; a traced
  simulator run (frames on the wire, causal MVRegister bodies) emits the
  same event stream in both packages, and the analyzer (redundancy,
  convergence, anomalies, semantic trace, report) reads the same
  numbers off any trace;
* ``trace_kernel_launches`` sees the port's ``kernels.ops.record_launch``
  (the wrappers' launches, op name and staged bytes);
* the scrape sidecar serves both views over loopback sockets, and a
  traced socket cluster scrapes and analyzes clean.
"""

import asyncio
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.lifecycle as rlife
import repro.net.stats as rnstats
import repro.obs as robs
import repro.sync as rsync
import repro.wire as rwire
import repro_torch.core as tcore
import repro_torch.lifecycle as tlife
import repro_torch.net.stats as tnstats
import repro_torch.obs as tobs
import repro_torch.sync as tsync
import repro_torch.wire as twire

PKGS = {
    "jax": SimpleNamespace(core=rcore, life=rlife, nstats=rnstats, obs=robs,
                           sync=rsync, wire=rwire),
    "port": SimpleNamespace(core=tcore, life=tlife, nstats=tnstats, obs=tobs,
                            sync=tsync, wire=twire),
}


def both(fn, *args, **kwargs):
    return fn(PKGS["jax"], *args, **kwargs), fn(PKGS["port"], *args,
                                                **kwargs)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _families(pk):
    reg = pk.obs.Registry()
    c = reg.counter("frames_total", "frames", ("node",))
    c.labels("a").inc(3)
    c.labels(node="b").inc()
    reg.gauge("depth", "buffered entries").set(4.5)
    h = reg.histogram("lag_seconds", "lag", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    hl = reg.histogram("size_bytes", "sizes", ("kind",))
    for v in (10, 1e3, 1e6):
        hl.labels("delta").observe(v)
    g = reg.gauge("live", "fn", ("node",))
    g.labels("x").set_function(lambda: 7)
    reg.gauge("weird").set(float("inf"))
    reg.gauge("neg").set(-2.5)
    return reg, [h.approx_quantile(q) for q in (0.1, 0.5, 0.9, 1.0)]


def _link_stats(pk):
    stats = pk.nstats.LinkStats()
    stats.record("delta", 100, link_class="intra")
    stats.record("digest", 40, link_class="wan", byte_cost=10.0)
    stats.record_recv("delta", 80, link_class="intra")
    stats.queue_drops += 2
    stats.chunks_sent += 3
    clock = [100.0]
    reg = pk.obs.Registry()
    reg.absorb_link_stats(stats, node="gw0", clock=lambda: clock[0])
    first = reg.render_prometheus()
    stats.record("delta", 50, link_class="inter")
    clock[0] += 10.0
    return reg, first


def _net_stats(pk):
    sim = pk.core.Simulator(pk.core.NetConfig(loss=0.2, dup=0.1, seed=4))
    ids = ["a", "b", "c"]
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.make_policy("bp+rr+digest-sync:2"),
        rng=random.Random(3), wire=pk.wire.WireCodec())) for i in ids]
    for k, n in enumerate(nodes):
        n.update(f"k{k}", pk.core.MVRegister, "write_delta", n.id, k)
    pk.core.run_to_convergence(sim, nodes, interval=1.0)
    reg = pk.obs.Registry()
    reg.absorb_net_stats(sim.stats, node="sim")
    for n in nodes:
        pk.obs.ReplicaProbes(reg, n)
    return reg, None


class _Counters:
    launches, h2d_bytes, d2h_bytes = 12, 4096, 64


def _kernel_and_crdt(pk):
    reg = pk.obs.Registry()
    reg.absorb_kernel_counters(_Counters(), node="n0")
    m = pk.sync.Metrics("r1")
    m.observe("lat", 2.0)
    m.observe("lat", 4.0)
    m.observe("tokens", 100.0, weight=3)
    reg.absorb_crdt_metrics(m, node="r1")
    child = pk.obs.marker_lag_histogram(reg, node="gw0")
    child.observe(0.2)
    pk.obs.marker_lag_histogram(reg, node="gw0").observe(0.3)
    return reg, None


@pytest.mark.parametrize("recipe", [_families, _link_stats, _net_stats,
                                    _kernel_and_crdt])
def test_registry_text_and_snapshot_match(recipe):
    (rreg, rextra), (treg, textra) = both(recipe)
    assert treg.render_prometheus() == rreg.render_prometheus()
    assert treg.render_json() == rreg.render_json()
    assert json.loads(treg.render_json()) == json.loads(rreg.render_json())
    assert textra == rextra
    parsed = tobs.parse_prometheus(treg.render_prometheus())
    assert parsed == robs.parse_prometheus(rreg.render_prometheus())


@pytest.mark.parametrize("declare", [
    lambda reg: reg.gauge("x_total"),
    lambda reg: reg.counter("x_total", "x", ("node", "peer")),
    lambda reg: reg.counter("bad name"),
    lambda reg: reg.histogram("h", "h", ("le",)),
    lambda reg: reg.counter("x_total", "x", ("node",)).labels("a").inc(-1),
])
def test_registry_rejects_like_the_reference(declare):
    msgs = []
    for pk in PKGS.values():
        reg = pk.obs.Registry()
        reg.counter("x_total", "x", ("node",))
        with pytest.raises(ValueError) as e:
            declare(reg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sync_metrics_is_a_live_shim():
    import repro_torch.sync.metrics as legacy
    from repro_torch.obs import registry as home
    assert legacy.Metrics is home.Metrics
    assert legacy.MetricsState is home.MetricsState
    assert legacy.MetricRecord is home.MetricRecord


def _metrics_lattice(pk):
    a, b = pk.sync.Metrics("r0"), pk.sync.Metrics("r1")
    d1 = a.observe("loss", 2.0)
    d2 = a.observe("loss", 4.0)
    d3 = b.observe("loss", 6.0)
    old = a.observe("tokens", 100.0, weight=1)
    new = a.observe("tokens", 100.0, weight=1)
    S = pk.sync.MetricsState.bottom()
    merged = S.join(d3).join(d2).join(d2).join(d1).join(d3).join(new) \
        .join(old)
    return [(merged.count(k), merged.total(k), merged.mean(k),
             merged.minimum(k), merged.maximum(k))
            for k in ("loss", "tokens")]


def test_replicated_metrics_match_reference():
    want, got = both(_metrics_lattice)
    assert got == want


# ---------------------------------------------------------------------------
# Tracer and analyzer
# ---------------------------------------------------------------------------

def _tracer_mechanics(pk, path):
    t = [0.0]
    with pk.obs.Tracer(node="a", clock=lambda: t[0], capacity=4,
                       sink=path) as tr:
        for i in range(6):
            t[0] = float(i)
            tr.emit("write", keys=[f"k{i}"], tag=i)
    sampled = pk.obs.Tracer(node="a", sample=0.5, seed=7,
                            clock=lambda: 0.0)
    for i in range(200):
        sampled.emit("write", keys=["k"], tag=i)
    a = pk.obs.Tracer(node="a", clock=lambda: 1.0)
    b = pk.obs.Tracer(node="b", clock=lambda: 0.5)
    a.emit("write", keys=["x"], tag=0)
    a.emit("ack", src="b", tag=1)
    b.emit("write", keys=["y"], tag=0)
    return (tr.events(), pk.obs.load_trace(path), sampled.events(),
            sampled.dropped, sampled.counts(), pk.obs.merge_events(a, b),
            sorted(pk.obs.EVENT_KINDS))


def test_tracer_mechanics_match_reference(tmp_path):
    want = _tracer_mechanics(PKGS["jax"], str(tmp_path / "r.jsonl"))
    got = _tracer_mechanics(PKGS["port"], str(tmp_path / "t.jsonl"))
    assert got == want
    with pytest.raises(ValueError, match="unknown trace event kind"):
        tobs.Tracer(node="a").emit("delta_shiip", dst="b")


def _traced_sim(pk, policy, loss, writes, ttl):
    ids = ["n0", "n1", "n2"]
    sim = pk.core.Simulator(pk.core.NetConfig(loss=loss, seed=5))
    tracers = {i: pk.obs.Tracer(node=i, clock=lambda: sim.time)
               for i in ids}
    own = pk.sync.KeyOwnership(ids, replication=3) if ttl else None
    nodes = [sim.add_node(pk.core.StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=pk.core.make_policy(policy), rng=random.Random(11),
        tracer=tracers[i], wire=pk.wire.WireCodec(), ownership=own,
        ttl=ttl)) for i in ids]
    reapers = []
    if ttl:
        for n in nodes:
            reapers.append(pk.life.ReaperProtocol(n, own, grace=0.5,
                                                  retry=1.0))
            sim.every(1.0, n.on_periodic)
    for w in range(writes):
        nodes[w % 3].update(f"k{w}", pk.core.MVRegister, "write_delta",
                            ids[w % 3], f"v{w}")
        sim.run_for(0.5)
    if ttl:
        sim.run_for(60.0)
    else:
        pk.core.run_to_convergence(sim, nodes, interval=1.0)
    for n in nodes:
        n.gc_deltas()
    trs = list(tracers.values())
    events = pk.obs.merge_events(*trs)
    rep = pk.obs.report(trs, expect_converged=None if ttl else ids)
    reg = pk.obs.Registry()
    for n in nodes:
        pk.obs.ReplicaProbes(reg, n)
    return (events, rep, pk.obs.semantic_trace(trs),
            pk.obs.redundancy(events), pk.obs.convergence(events),
            pk.obs.anomalies(events), reg.render_prometheus())


@pytest.mark.parametrize("policy,loss,writes,ttl", [
    ("bp+rr", 0.2, 6, None),
    ("bp+rr+digest-sync:2", 0.2, 6, None),
    ("digest-sync", 0.0, 4, None),
    ("every:2", 0.3, 5, None),
    ("bp+rr", 0.0, 3, 2.0),
])
def test_traced_sim_run_matches_reference(policy, loss, writes, ttl):
    want, got = both(_traced_sim, policy, loss, writes, ttl)
    assert got == want
    kinds = {e["kind"] for e in want[0]}
    assert {"write", "delta_join"} <= kinds
    if ttl:
        assert {"reap_propose", "reap_ack", "reap_commit"} <= kinds
    assert want[1]["anomaly_list"] == []


def _ev(kind, node, t, **f):
    return {"t": t, "seq": f.pop("seq", 0), "node": node, "kind": kind,
            **f}


SYNTHETIC = [
    [_ev("delta_ship", "a", 0.0, dst="b", bytes=100, keys=["k"],
         full=False, tag=1),
     _ev("delta_join", "b", 0.1, src="a", via="delta", bytes=100,
         keys=["k"], joined=1),
     _ev("delta_ship", "a", 0.2, dst="b", bytes=100, keys=["k"],
         full=False, tag=1),
     _ev("delta_join", "b", 0.3, src="a", via="delta", bytes=100, keys=[],
         joined=0)],
    [_ev("write", "a", 1.0, keys=["k"], tag=0, round=3),
     _ev("delta_ship", "a", 1.5, dst="b", bytes=10, keys=["k"], full=False,
         tag=1, round=4),
     _ev("delta_join", "b", 2.0, src="a", via="delta", bytes=10,
         keys=["k"], joined=1, round=1),
     _ev("delta_ship", "a", 2.5, dst="c", bytes=10, keys=["k"], full=False,
         tag=1, round=5),
     _ev("delta_join", "c", 4.0, src="a", via="delta", bytes=10,
         keys=["k"], joined=1, round=1)],
    [_ev("ack", "a", 0.5, src="b", tag=3, stale=False),
     _ev("delta_ship", "a", 1.0, dst="c", bytes=10, keys=["k"], full=False,
         tag=2),
     _ev("ack", "a", 1.5, src="c", tag=9, stale=False)],
    [_ev("write", "a", 0.0, keys=["k"], tag=0),
     _ev("delta_ship", "a", 0.1, dst="b", bytes=10, keys=["k"], full=False,
         tag=1),
     _ev("delta_ship", "b", 0.2, dst="a", bytes=10, keys=["k"], full=False,
         tag=1)],
    [_ev("write", "a", 0.0, keys=["k"], tag=0),
     _ev("delta_ship", "b", 0.2, dst="a", bytes=10, keys=["k"], full=False,
         tag=1, keys_truncated=True)],
    [_ev("write", "a", 7.0, keys=["k"], tag=0),
     _ev("delta_join", "b", 93.0, src="c", via="digest-resp", bytes=999,
         keys=["k"], joined=1),
     _ev("delta_join", "b", 94.0, src="a", via="delta", bytes=5, keys=[],
         joined=0)],
]


def _text(x) -> str:
    """A result as sorted JSON: NaN ratios (no ship) compare equal."""
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("trace", SYNTHETIC)
def test_analyzer_reads_the_same_numbers(trace):
    for fn in ("redundancy", "convergence", "anomalies", "semantic_trace"):
        assert _text(getattr(tobs, fn)(trace)) \
            == _text(getattr(robs, fn)(trace)), fn
    assert _text(tobs.report(trace, expect_converged=["a", "b"])) \
        == _text(robs.report(trace, expect_converged=["a", "b"]))


def _ack_lag(pk):
    ids = ["a", "b", "c"]
    sim = pk.core.Simulator(pk.core.NetConfig(seed=3))
    nodes = [sim.add_node(pk.core.Replica(
        i, pk.core.AWORSet.bottom(), [j for j in ids if j != i],
        causal=True, policy=pk.core.make_policy("bp+rr"),
        rng=random.Random(1))) for i in ids]
    reg = pk.obs.Registry()
    probe = pk.obs.AckLagProbe(reg, nodes[0], clock=lambda: sim.time)
    for k in range(3):
        nodes[0].operation(lambda X, k=k: X.add_delta("a", f"x{k}"))
        probe.note_write()
    before = probe.poll()
    pk.core.run_to_convergence(sim, nodes, interval=1.0)
    return before, probe.poll(), reg.render_prometheus()


def test_ack_lag_probe_matches_reference():
    want, got = both(_ack_lag)
    assert got == want
    assert want[:2] == (0, 3)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def test_trace_kernel_launches_sees_the_ports_record_launch():
    from repro_torch.kernels import ops

    assert not hasattr(ops.counters, "reset")
    tr = tobs.Tracer(node="kern")
    reg = tobs.Registry()
    reg.absorb_kernel_counters(node="kern")
    before = reg.snapshot()["repro_kernel_launches_total"]["kern"]
    snap = ops.counters.snapshot()
    uninstall = tobs.trace_kernel_launches(tr)
    try:
        x = np.zeros((2, 256), np.float32)
        ops.chunk_digest(x)                  # a numpy operand is staged
        ops.record_launch("probe_op")
        a = torch.zeros((3, 8))
        av = torch.ones(3, dtype=torch.int32)
        ops.delta_join(a, av, a + 1, av + 1)
    finally:
        uninstall()
    evs = [e for e in tr.events() if e["kind"] == "kernel_launch"]
    assert [e["op"] for e in evs] == ["chunk_digest", "probe_op",
                                      "delta_join"]
    assert evs[0]["h2d_bytes"] == x.nbytes
    assert evs[1]["h2d_bytes"] == evs[2]["h2d_bytes"] == 0
    assert ops.counters.since(snap)["launches"] == len(evs)
    after = reg.snapshot()["repro_kernel_launches_total"]["kern"]
    assert after - before == len(evs)
    ops.record_launch("after_uninstall")     # hook removed: no emit
    assert len(tr.events()) == len(evs)


# ---------------------------------------------------------------------------
# Scrape surface and a traced socket cluster
# ---------------------------------------------------------------------------

def test_metrics_server_serves_both_views_over_sockets():
    reg = tobs.Registry()
    reg.counter("hits_total", "hits").inc(5)
    reg.gauge("depth", "d").set(2.0)

    async def scenario():
        server = tobs.MetricsServer(reg)
        addr = await server.start()
        try:
            text = await asyncio.to_thread(tobs.scrape, addr)
            js = await asyncio.to_thread(tobs.scrape_json, addr)
            with pytest.raises(RuntimeError, match="404"):
                await asyncio.to_thread(tobs.scrape, addr, "/nope")
            return text, js
        finally:
            await server.stop()

    text, js = asyncio.run(scenario())
    assert text == reg.render_prometheus()
    assert tobs.parse_prometheus(text)["hits_total"][""] == 5.0
    assert js == {"hits_total": 5.0, "depth": 2.0}


def test_traced_socket_cluster_scrape_and_analyze():
    from repro_torch.core import MVRegister
    from repro_torch.net import start_cluster, stop_cluster, wait_converged

    tracers = {}

    def tf(node_id):
        tracers[node_id] = tobs.Tracer(node=node_id)
        return tracers[node_id]

    async def scenario():
        nodes = await start_cluster(3, transport="udp", tick=0.03,
                                    seed=61, tracer_factory=tf)
        try:
            addrs = []
            for n in nodes:
                n.export_metrics()
                addrs.append(await n.serve_metrics())
            for k, n in enumerate(nodes):
                n.update(f"s{k}", MVRegister, "write_delta", n.id, "done")
            await wait_converged(nodes, timeout=30.0)
            await asyncio.sleep(0.2)
            texts = [await asyncio.to_thread(tobs.scrape, a) for a in addrs]
            return [n.id for n in nodes], texts
        finally:
            await stop_cluster(nodes)

    ids, texts = asyncio.run(scenario())
    for nid, text in zip(ids, texts):
        parsed = tobs.parse_prometheus(text)
        assert parsed["repro_net_frames_sent_total"][f'node="{nid}"'] > 0
        assert f'node="{nid}"' in parsed["repro_net_bytes_sent_per_second"]
        assert f'node="{nid}"' in parsed["repro_replica_delta_buffer_depth"]
        assert f'node="{nid}"' in parsed["repro_kernel_launches_total"]
        assert parsed["repro_ack_lag_seconds_count"][f'node="{nid}"'] >= 1
    rep = tobs.report(list(tracers.values()), expect_converged=ids)
    assert rep["anomaly_list"] == []
    assert rep["unconverged_keys"] == {}
    assert rep["redundancy"]["ratio"] >= 1.0
