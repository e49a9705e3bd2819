"""Seeded schedules run once in the JAX package and once in the port:

* three basic-mode, device-resident StoreReplicas shipping tensor
  stores through ``WireCodec(to_device=True)`` over a lossy network: the
  converged stores must be equal as numpy;
* three causal replicas gossiping an ORMap session table (request →
  MVRegister status) over a lossy network: the converged tables must be
  equal by ``digest._canon``;
* the per-dot reconnect of a large ORMap under digest-sync (the chip
  smoke's, at 200 keys x 50 dots and at its full 2,000 x 500): equal pull
  bytes, which at full size are the figures ``chip_smoke.py`` holds the
  card's run to.

The simulator's byte accounting must be identical wherever the frames
are (tensor and dot-column bodies are byte-identical, so every message
costs the same). A single-object Replica ships its bare ORMap as an
opaque pickle, which names each package's module: those frames differ in
length by design, and only the message counts are held equal there."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.digest as rdigest
import repro.core.propagation as rprop
import repro.core.sim as rsim
import repro.core.tensor_lattice as rtl
import repro.kernels.resident as rres
import repro.wire.frames as rframes
import repro_torch.core.antientropy as tae
import repro_torch.core.digest as tdigest
import repro_torch.core.propagation as tprop
import repro_torch.core.sim as tsim
import repro_torch.core.tensor_lattice as ttl
import repro_torch.kernels.resident as tres
import repro_torch.wire.frames as tframes
from repro_torch.dtypes import to_numpy

CHUNK = 32
IDS = ("a", "b", "c")


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def canonical(store):
    out = {}
    for key, val in store.entries:
        for name, ct in val.chunks:
            if ct.is_sparse:
                ct = ct.to_dense()
            out[(key, name)] = (_np(ct.values).tobytes(),
                                _np(ct.versions).tobytes())
    return out


def run(port: bool, seed: int, policy: str):
    prop, sim_mod = (tprop, tsim) if port else (rprop, rsim)
    kw = {"device": "cpu"} if port else {}
    wire = (tframes.WireCodec(to_device=True, device="cpu") if port
            else rframes.WireCodec(to_device=True))
    Chunked = ttl.ChunkedTensor if port else rtl.ChunkedTensor
    TS = ttl.TensorState if port else rtl.TensorState
    sim = sim_mod.Simulator(sim_mod.NetConfig(loss=0.15, dup=0.1,
                                              seed=seed))
    reps = [sim.add_node(prop.StoreReplica(
        i, [j for j in IDS if j != i], causal=False, wire=wire,
        resident=True, policy=prop.make_policy(policy), **kw))
        for i in IDS]
    rng = np.random.default_rng(seed)
    for k in range(6):
        vals = rng.normal(size=(4 + k, CHUNK)).astype(np.float32)
        vers = ((np.arange(4 + k) + 1) * 4 + 1).astype(np.int32)
        if port:
            vals, vers = torch.from_numpy(vals), torch.from_numpy(vers)
        reps[k % 3].put(f"k{k}", TS.of({"w": Chunked(vals, vers)},
                                       lamport=1))
    for rnd in range(14):
        if rnd < 6:
            # a write on a random replica: a few chunk rows of one key
            w = reps[int(rng.integers(3))]
            key = f"k{int(rng.integers(6))}"
            cur = w.get(key, TS)
            n = cur.as_dict()["w"].shape[0] if cur.chunks else 0
            if n:
                idx = np.sort(rng.choice(n, size=2, replace=False))
                new = rng.normal(size=(2, CHUNK)).astype(np.float32)
                w.put(key, cur.write_delta(IDS.index(w.id), "w", new,
                                           chunk_idx=idx))
        for r in reps:
            r.on_periodic()
        sim.run_for(2.0)
    return reps, sim.stats


@pytest.mark.parametrize("seed,policy", [(23, "all"), (5, "bp+rr"),
                                         (9, "digest-sync")])
def test_port_replicas_match_reference_schedule(seed, policy):
    treps, tstats = run(True, seed, policy)
    rreps, rstats = run(False, seed, policy)
    digest = [tdigest.store_digest(r.store) for r in treps]
    assert all(d == digest[0] for d in digest[1:])        # converged
    assert tae.converged(treps)
    for t, r in zip(treps, rreps):
        assert canonical(t.store) == canonical(r.store)
        assert rdigest.store_digest(r.store) is not None
    assert tstats.bytes_sent == rstats.bytes_sent
    assert tstats.bytes_by_kind == rstats.bytes_by_kind
    assert (tstats.sent, tstats.delivered, tstats.dropped) == (
        rstats.sent, rstats.delivered, rstats.dropped)
    for t in treps:
        assert tres.resident_of(t.store) is not None
    for r in rreps:
        assert rres.resident_of(r.store) is not None


# ---------------------------------------------------------------------------
# Causal replicas: the session table and the per-dot reconnect
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _packages(port):
    if port:
        import repro_torch.core as C
        import repro_torch.wire as W
    else:
        import repro.core as C
        import repro.wire as W
    return C, W


def sessions(port: bool, shape: str, wire: bool, seed: int,
             n_requests=6, gateways=3):
    """``serve --replicate``'s schedule: each request's owning gateway
    writes its four statuses, the network runs, then anti-entropy to
    convergence. ``shape`` "object" holds the table as one ORMap per
    Replica (as serve does); "store" as the key ``sessions`` of a causal
    StoreReplica's store."""
    C, W = _packages(port)
    codec = W.WireCodec() if wire else None
    sim = C.Simulator(C.NetConfig(loss=0.25, dup=0.1, seed=seed))
    ids = [f"gw{k}" for k in range(gateways)]
    kw = {"device": "cpu"} if port else {}
    common = dict(causal=True, policy=C.make_policy("bp+rr"), wire=codec)
    if shape == "store":
        nodes = [sim.add_node(C.StoreReplica(
            i, [j for j in ids if j != i], rng=random.Random(seed + k),
            **common, **kw)) for k, i in enumerate(ids)]
    else:
        nodes = [sim.add_node(C.Replica(
            i, C.ORMap.bottom(), [j for j in ids if j != i],
            rng=random.Random(seed + k), **common, **kw))
            for k, i in enumerate(ids)]
    for r in range(n_requests):
        gw = nodes[r % gateways]
        for status in ("queued", "prefilling", "decoding", "done"):
            if shape == "store":
                gw.update("sessions", C.ORMap, "apply_delta", gw.id,
                          f"req{r}", C.MVRegister, "write_delta", status)
            else:
                gw.operation(lambda X, r=r, s=status, gw=gw: X.apply_delta(
                    gw.id, f"req{r}", C.MVRegister, "write_delta", s))
        sim.run_for(0.5)
    C.run_to_convergence(sim, nodes, interval=1.0)
    assert C.converged(nodes)
    table = nodes[0].X if shape == "object" else nodes[0].X.get(
        "sessions", C.ORMap)
    return table, sim.stats


def _canon_table(table, port):
    if port:
        from repro_torch.core import dotcols
        from repro_torch.core.digest import _canon
    else:
        from repro.core import dotcols
        from repro.core.digest import _canon
    return _canon(dotcols.value_to_obj(table))


@pytest.mark.parametrize("shape,wire", [("store", True), ("object", False),
                                        ("object", True)])
@pytest.mark.parametrize("seed", [0, 7])
def test_causal_session_table_matches_reference(shape, wire, seed):
    ttable, tstats = sessions(True, shape, wire, seed)
    rtable, rstats = sessions(False, shape, wire, seed)
    assert _canon_table(ttable, True) == _canon_table(rtable, False)
    from repro_torch.core import MVRegister
    assert {k: ttable.get_value(k, MVRegister).read()
            for k in ttable.keys()} == {f"req{r}": frozenset({"done"})
                                        for r in range(6)}
    assert (tstats.sent, tstats.delivered, tstats.dropped) == (
        rstats.sent, rstats.delivered, rstats.dropped)
    if shape == "object" and wire:
        # bare ORMap deltas are opaque pickles naming each package's
        # module (repro_torch.core.… is 6 bytes longer than repro.core.…)
        assert tstats.bytes_by_kind["ack"] == rstats.bytes_by_kind["ack"]
        assert tstats.bytes_by_kind["delta"] > rstats.bytes_by_kind["delta"]
    else:
        assert tstats.bytes_by_kind == rstats.bytes_by_kind


def _reference_reconnect(n_keys, per_key, missing_tail, removed_head):
    """The JAX package's per-dot reconnect on the maps of
    ``benchmarks/bench_dots.py`` (its ``reconnect_rows`` at any size)."""
    from repro.core import (LatticeStore, NetConfig, Simulator,
                            StoreReplica, make_policy)
    from repro.wire import WireCodec, encode_frame, encode_value
    bench = _load("bench_dots", ROOT / "benchmarks" / "bench_dots.py")
    req_map, resp_map = bench._big_ormap(n_keys, per_key,
                                         missing_tail=missing_tail,
                                         removed_head=removed_head)
    wire = WireCodec()
    sim = Simulator(NetConfig(loss=0.0, seed=21))
    stale = sim.add_node(StoreReplica(
        "stale", ["peer"], causal=True, wire=wire,
        policy=make_policy("digest-sync"), rng=random.Random(3)))
    peer = sim.add_node(StoreReplica(
        "peer", ["stale"], causal=True, wire=wire,
        policy=make_policy("digest-sync"), rng=random.Random(3)))
    stale.X = LatticeStore.of({"map": req_map})
    peer.X = LatticeStore.of({"map": resp_map})
    stale.on_periodic()
    sim.run_for(5.0)
    return {"dots": int(resp_map.store.packed.size),
            "converged": stale.X == peer.X,
            "request_bytes": sim.stats.bytes_by_kind.get("digest", 0),
            "response_bytes": sim.stats.bytes_by_kind.get("digest-resp", 0),
            "full_state_bytes": len(encode_frame("state",
                                                 encode_value(peer.X)))}


def _port_reconnect(**size):
    from repro_torch.core.dotcols import mask_device
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    with mask_device("cpu"):
        got = smoke.reconnect(**size)
    got.pop("wall_s")
    return got, smoke


def test_reconnect_pull_bytes_match_reference():
    """The chip smoke's reconnect at 200 keys x 50 dots: converged, and
    the same digest request, response and full-state frame bytes."""
    size = {"n_keys": 200, "per_key": 50, "missing_tail": 10,
            "removed_head": 5}
    got, _ = _port_reconnect(**size)
    want = _reference_reconnect(**size)
    assert got == want and got["converged"]
    assert got["dots"] == 200 * 50 - 20 * 5


def test_full_size_reconnect_bytes_are_the_smoke_constants():
    """At the chip smoke's size (999,000 dots) both packages pull the
    bytes that ``chip_smoke.py`` holds the card's run to, within 5% of
    the one full-state frame."""
    got, smoke = _port_reconnect(**{"n_keys": 2000, "per_key": 500,
                                    "missing_tail": 10, "removed_head": 5})
    assert smoke.RECONNECT == {"n_keys": 2000, "per_key": 500,
                               "missing_tail": 10, "removed_head": 5}
    want = _reference_reconnect(**smoke.RECONNECT)
    assert got == want and got["converged"] and got["dots"] == 999_000
    assert (got["request_bytes"], got["response_bytes"],
            got["full_state_bytes"]) == (smoke.RECONNECT_REQUEST_BYTES,
                                         smoke.RECONNECT_RESPONSE_BYTES,
                                         smoke.RECONNECT_FULL_STATE_BYTES)
    assert (got["request_bytes"] + got["response_bytes"]
            <= smoke.RECONNECT_MAX_SHARE * got["full_state_bytes"])
