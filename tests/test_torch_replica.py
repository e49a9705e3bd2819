"""One seeded lossy schedule of three basic-mode, device-resident
StoreReplicas shipping through ``WireCodec(to_device=True)``, run once in
the JAX package and once in the port: the converged stores must be equal
as numpy, and the simulator's byte accounting identical (the port's
frames are byte-identical, so every message costs the same)."""

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
