"""The cases of ``tests/test_resident.py`` run against the port and the
JAX package side by side on the same numpy inputs: each case is written
once over a namespace of either package's modules, and the port must
give the same stores (compared as numpy) with the same launch and
host→device byte counts. Plus the top-k tie order of ``keep_plan``."""

from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.digest as rdigest
import repro.core.store as rstore
import repro.core.tensor_lattice as rtl
import repro.kernels.ops as rops
import repro.kernels.resident as rres
import repro.wire.codec as rcodec
import repro_torch.core.digest as tdigest
import repro_torch.core.store as tstore
import repro_torch.kernels.ops as tops
import repro_torch.kernels.resident as tres
import repro_torch.wire.codec as tcodec
from repro_torch import convert
from repro_torch.dtypes import to_numpy

CHUNK = 32
ROW_BYTES = CHUNK * 4 + 12          # f32 payload + i64 index + i32 version
NP_DTYPE = {"float32": np.float32, "float16": np.float16,
            "bfloat16": ml_dtypes.bfloat16}


def _ref_build(entries, life=()):
    out = {}
    for key, (tensors, lamport) in entries.items():
        chunks = {}
        for name, (vals, vers, sp) in tensors.items():
            chunks[name] = (rtl.ChunkedTensor(vals, vers) if sp is None
                            else rtl.sparse_chunks(sp[1], sp[0], vals, vers))
        out[key] = rtl.TensorState.of(chunks, lamport=lamport)
    return rstore.LatticeStore.of(out, dict(life))


REF = SimpleNamespace(
    name="ref", build=_ref_build, LatticeStore=rstore.LatticeStore,
    ensure=rres.ensure, resident_of=rres.resident_of, spill=rres.spill,
    ops=rops, store_digest=rdigest.store_digest,
    digest_select_store=rstore.digest_select_store,
    encode_store=rcodec.encode_store,
    decode_store=rcodec.decode_store, keep_plan=rres.keep_plan,
    StackedChunks=rstore._StackedChunks)
PORT = SimpleNamespace(
    name="port",
    build=lambda e, life=(): convert.store_from_numpy(e, life,
                                                      device="cpu"),
    LatticeStore=tstore.LatticeStore,
    ensure=lambda s: tres.ensure(s, "cpu"), resident_of=tres.resident_of,
    spill=tres.spill, ops=tops, store_digest=tdigest.store_digest,
    digest_select_store=tstore.digest_select_store,
    encode_store=tcodec.encode_store,
    decode_store=lambda b, to_device=False: tcodec.decode_store(
        b, to_device=to_device, device="cpu"),
    keep_plan=tres.keep_plan, StackedChunks=tstore._StackedChunks)


def mk_store(sizes, chunk=CHUNK, seed=0, version=1, n_tensors=1,
             dtype="float32"):
    """Plain form (``repro_torch.convert``) of test_resident's _mk_store."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(sizes):
        ts = {}
        for t in range(n_tensors):
            vals = rng.normal(size=(n, chunk)).astype(NP_DTYPE[dtype])
            vers = (rng.integers(0, 3, size=(n,)).astype(np.int32) * 2
                    + version)
            ts[f"t{t}"] = (vals, vers, None)
        out[f"k{i}"] = (ts, version)
    return out


def mk_sparse_delta(touch, n_chunks, chunk=CHUNK, seed=100, version=9,
                    n_tensors=1, dtype="float32"):
    rng = np.random.default_rng(seed)
    out = {}
    for key in touch:
        ts = {}
        for t in range(n_tensors):
            r = min(2, n_chunks)
            idx = np.sort(rng.choice(n_chunks, size=r,
                                     replace=False)).astype(np.int32)
            vals = rng.normal(size=(r, chunk)).astype(NP_DTYPE[dtype])
            vers = np.full((r,), version * 2 + 1, np.int32)
            ts[f"t{t}"] = (vals, vers, (idx, n_chunks))
        out[key] = (ts, version)
    return out


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def plain(store):
    """Dense bit patterns per (key, tensor) of either package's store."""
    out = {}
    for key, val in store.entries:
        for name, ct in val.chunks:
            if ct.is_sparse:
                ct = ct.to_dense()
            v = _np(ct.values)
            out[(key, name)] = (v.view(f"u{v.dtype.itemsize}").tobytes(),
                                _np(ct.versions).tobytes())
        out[(key, "·lamport")] = val.lamport
    out["·life"] = tuple(store.life)
    return out


def both(case, *args):
    """Run ``case(ns, *args)`` on both packages; returns (port, ref)."""
    return case(PORT, *args), case(REF, *args)


def _plain_store(ns, s):
    return ns.LatticeStore(s.entries, s.life)


# ---------------------------------------------------------------------------
# Join parity and counts
# ---------------------------------------------------------------------------

def _scatter_case(ns, sizes, dtype):
    a = ns.build(mk_store(sizes, seed=0, dtype=dtype))
    d = {}
    for i, k in enumerate(f"k{j}" for j in range(0, len(sizes), 2)):
        d.update(mk_sparse_delta([k], sizes[int(k[1:])], seed=7 + i,
                                 dtype=dtype))
    d = ns.build(d)
    assert ns.ensure(a) is not None
    snap = ns.ops.counters.snapshot()
    got = a.join(d)
    counts = ns.ops.counters.since(snap)
    assert ns.resident_of(got) is not None
    loop = _plain_store(ns, a).join(d, batched=False)
    assert plain(got) == plain(loop)
    return plain(got), counts


@pytest.mark.parametrize("sizes", [[4, 4, 4, 4], [1, 3, 7, 13, 5], [8]])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_scatter_ingest_matches_reference_and_counts(sizes, dtype):
    (pg, pc), (rg, rc) = both(_scatter_case, sizes, dtype)
    assert pg == rg
    assert pc["launches"] == rc["launches"] == 1
    assert pc["h2d_bytes"] == rc["h2d_bytes"]


def _aligned_case(ns):
    a = ns.build(mk_store([3, 5, 2], seed=2, version=1, n_tensors=2))
    b = ns.build(mk_store([3, 5, 2], seed=3, version=5, n_tensors=2))
    ns.ensure(a)
    ns.ensure(b)
    snap = ns.ops.counters.snapshot()
    got = a.join(b)
    counts = ns.ops.counters.since(snap)
    assert ns.resident_of(got) is not None
    loop = _plain_store(ns, a).join(_plain_store(ns, b), batched=False)
    assert plain(got) == plain(loop)
    return plain(got), counts


def test_aligned_resident_join_is_one_fused_launch():
    (pg, pc), (rg, rc) = both(_aligned_case)
    assert pg == rg
    assert pc == rc and pc["launches"] == 1 and pc["h2d_bytes"] == 0


def _chain_case(ns):
    s = ns.build(mk_store([4, 4, 4], seed=4))
    ns.ensure(s)
    counts = []
    for rnd in range(4):
        d = ns.build(mk_sparse_delta(["k1"], 4, seed=20 + rnd,
                                     version=10 + rnd))
        snap = ns.ops.counters.snapshot()
        s = s.join(d)
        counts.append(ns.ops.counters.since(snap))
        assert ns.resident_of(s) is not None
    return plain(s), counts


def test_resident_rounds_chain_without_readoption():
    (pg, pc), (rg, rc) = both(_chain_case)
    assert pg == rg
    assert [c["launches"] for c in pc] == [1] * 4
    assert [c["h2d_bytes"] for c in pc] == [c["h2d_bytes"] for c in rc]


def _size_case(ns, n_keys):
    a = ns.build(mk_store([4] * n_keys, seed=5))
    ns.ensure(a)
    d = ns.build(mk_sparse_delta(["k0", "k1"], 4, seed=30))
    snap = ns.ops.counters.snapshot()
    a.join(d)
    return ns.ops.counters.since(snap)


def test_ingest_launches_are_size_independent():
    (ps, rs), (pb, rb) = both(_size_case, 8), both(_size_case, 32)
    assert ps["launches"] == pb["launches"] == 1
    delta_bytes = 2 * 2 * (CHUNK * 4 + 4)     # 2 keys × 2 rows: vals+vers
    pad = 16 * (CHUNK * 4 + 4) + 16 * 4       # padded grid bucket + idx
    assert pb["h2d_bytes"] <= delta_bytes + pad
    assert pb["h2d_bytes"] == ps["h2d_bytes"] == rb["h2d_bytes"] \
        == rs["h2d_bytes"]


# ---------------------------------------------------------------------------
# Digest summaries, old snapshots, energy selection
# ---------------------------------------------------------------------------

def _snapshot_case(ns):
    a = ns.build(mk_store([3, 5, 2], seed=6, n_tensors=2))
    before = plain(a)
    plain_digest = ns.store_digest(_plain_store(ns, a))
    ns.ensure(a)
    d = ns.build(mk_sparse_delta(["k2"], 2, seed=31))
    s = a.join(d)
    ref = _plain_store(ns, a).join(d, batched=False)
    assert ns.store_digest(s) == ns.store_digest(ref)
    assert ns.store_digest(a) == plain_digest     # old digest unchanged
    assert plain(a) == before                     # old values unchanged
    return plain(s)


def test_old_snapshot_digest_and_values_survive_ingest():
    port, ref = both(_snapshot_case)
    assert port == ref


def _keep_case(ns, budget_rows):
    a = ns.build(mk_store([6, 6, 6], seed=7, n_tensors=2))
    host = ns.digest_select_store(_plain_store(ns, a),
                                  budget_rows * ROW_BYTES)
    ns.ensure(a)
    snap = ns.ops.counters.snapshot()
    dev = ns.digest_select_store(a, budget_rows * ROW_BYTES)
    counts = ns.ops.counters.since(snap)
    assert plain(dev) == plain(host)
    return plain(dev), counts["launches"]


@pytest.mark.parametrize("budget_rows", [1, 10, 35])
def test_keep_plan_matches_host_selection_and_reference(budget_rows):
    (pg, pl), (rg, rl) = both(_keep_case, budget_rows)
    assert pg == rg and pl == rl == 1


def _tie_case(ns):
    """Rows of equal energy at many positions: the kept set depends only
    on the tie order (lower row first)."""
    rng = np.random.default_rng(8)
    row = rng.normal(size=(CHUNK,)).astype(np.float32)
    entries = {}
    for i in range(3):
        vals = np.tile(row, (5, 1))
        vals[2] *= 2                          # one distinct high row
        vers = np.arange(1, 6, dtype=np.int32)
        entries[f"k{i}"] = ({"t0": (vals, vers, None),
                             "t1": (vals.copy(), vers.copy(), None)}, 1)
    a = ns.build(entries)
    cache = ns.ensure(a)
    plans = [ns.keep_plan(cache, k * ROW_BYTES) for k in (1, 4, 7, 13)]
    host = [ns.digest_select_store(_plain_store(ns, a), k * ROW_BYTES)
            for k in (1, 4, 7, 13)]
    return plans, [plain(h) for h in host]


def test_keep_plan_tie_order_matches_reference():
    (pp, ph), (rp, rh) = both(_tie_case)
    assert pp == rp
    assert ph == rh


def _covers_case(ns):
    a = ns.build(mk_store([2, 2], seed=8))
    ns.ensure(a)
    return ns.digest_select_store(a, 10 ** 9) is a


def test_keep_plan_none_when_budget_covers_everything():
    assert both(_covers_case) == (True, True)


# ---------------------------------------------------------------------------
# Cache lifecycle: spill, reap, handoff, layout drift, sparse adoption
# ---------------------------------------------------------------------------

def _spill_case(ns):
    a = ns.build(mk_store([3, 4], seed=9))
    ns.ensure(a)
    snap = ns.ops.counters.snapshot()
    sc = ns.spill(a)
    d2h = ns.ops.counters.since(snap)["d2h_bytes"]
    assert isinstance(sc, ns.StackedChunks)
    assert ns.store_digest(a) == ns.store_digest(_plain_store(ns, a))
    return d2h


def test_spill_roundtrip_restores_host_cache():
    port, ref = both(_spill_case)
    assert port == ref > 0


def _tombstone_case(ns):
    a = ns.build(mk_store([3, 4, 5], seed=10))
    ns.ensure(a)
    reaped = ns.LatticeStore(
        tuple((k, v) for k, v in a.entries if k != "k0"),
        (("k0", (1, float("-inf"))),))
    got = a.join(reaped)
    ref = _plain_store(ns, a).join(reaped, batched=False)
    assert plain(got) == plain(ref)
    cache = ns.ensure(got)
    assert cache is not None and ("k0", "t0") not in cache.spans
    assert ns.store_digest(got) == ns.store_digest(ref)
    return plain(got)


def test_tombstoned_key_falls_back_then_readopts():
    port, ref = both(_tombstone_case)
    assert port == ref


def _handoff_case(ns):
    a = ns.build(mk_store([3, 4, 5], seed=11))
    ns.ensure(a)
    rest = a.restrict(["k1", "k2"])
    cache = ns.ensure(rest)
    assert set(k for k, _, _, _ in cache.layout) == {"k1", "k2"}
    assert ns.store_digest(rest) == ns.store_digest(_plain_store(ns, rest))
    return plain(rest)


def test_handoff_restriction_readopts_remaining_keys():
    port, ref = both(_handoff_case)
    assert port == ref


def _drift_case(ns):
    a = ns.build(mk_store([3, 4], seed=12))
    ns.ensure(a)
    d = mk_store([2], seed=13, version=7)
    d = ns.build({"brand-new": d["k0"]})
    got = a.join(d)
    ref = _plain_store(ns, a).join(d, batched=False)
    assert plain(got) == plain(ref)
    assert ns.ensure(got) is not None
    return plain(got)


def test_layout_drift_new_key_falls_back_to_host_paths():
    port, ref = both(_drift_case)
    assert port == ref


def _densify_case(ns):
    d = ns.build(mk_sparse_delta(["k0", "k1"], 4, seed=14))
    s = ns.LatticeStore.bottom().join(d)
    cache = ns.ensure(s)
    assert cache is not None
    assert ns.store_digest(s) == ns.store_digest(_plain_store(ns, s))
    return plain(s), cache.vers_host.tolist()


def test_adopt_densifies_sparse_receiver_state():
    port, ref = both(_densify_case)
    assert port == ref


def _memo_case(ns):
    a = ns.build(mk_store([4, 4, 4, 4], seed=20, n_tensors=2))
    b = ns.build(mk_store([4, 4, 4, 4], seed=21, version=3, n_tensors=2))
    j = a.join(b)
    budget = 6 * ROW_BYTES
    snap = ns.ops.counters.snapshot()
    ns.digest_select_store(_plain_store(ns, j), budget)
    cold = ns.ops.counters.since(snap)["launches"]
    ns.digest_select_store(j, budget)
    j2 = j.join(ns.build(mk_sparse_delta(["k1"], 4, seed=33)))
    snap = ns.ops.counters.snapshot()
    sel = ns.digest_select_store(j2, budget)
    warm = ns.ops.counters.since(snap)["launches"]
    assert plain(sel) == plain(ns.digest_select_store(
        _plain_store(ns, j2), budget))
    return cold, warm, plain(sel)


def test_digest_memo_only_recomputes_touched_tensors():
    (pc, pw, ps), (rc, rw, rs) = both(_memo_case)
    assert pc == rc >= 8 and pw == rw <= 3 and ps == rs


# ---------------------------------------------------------------------------
# Wire decode-to-device ingest
# ---------------------------------------------------------------------------

def _decode_case(ns):
    a = ns.build(mk_store([4] * 8, seed=22))
    ns.ensure(a)
    buf = ns.encode_store(ns.build(mk_sparse_delta(["k0", "k5"], 4,
                                                   seed=34)))
    ddev = ns.decode_store(buf, to_device=True)
    assert ddev.__dict__.get("_device_cols") is not None
    snap = ns.ops.counters.snapshot()
    got = a.join(ddev)
    counts = ns.ops.counters.since(snap)
    ref = _plain_store(ns, a).join(ns.decode_store(buf), batched=False)
    assert plain(got) == plain(ref)
    return plain(got), counts, bytes(buf)


def test_decode_to_device_ingest_stages_only_the_index_column():
    (pg, pc, pb), (rg, rc, rb) = both(_decode_case)
    assert pb == rb                 # identical frames in both packages
    assert pg == rg
    assert pc == rc and pc["launches"] == 1 and pc["h2d_bytes"] <= 16 * 4


# ---------------------------------------------------------------------------
# The resident round of benchmarks/bench_store.resident_round_rows
# ---------------------------------------------------------------------------

def _bench_round_cost(n_obj, n_chunks=2, chunk=128, touched=64):
    """``bench_store.resident_round_rows``' steady-state round in the
    port: scatter-ingest a 64-key sparse delta, summarize, rank under a
    256-chunk budget."""
    rng = np.random.default_rng(0)
    entries = {f"obj{i:05d}": ({"t0": (
        rng.normal(size=(n_chunks, chunk)).astype(np.float32),
        np.full(n_chunks, 1, np.int32), None)}, 0) for i in range(n_obj)}
    store = PORT.build(entries)
    rng = np.random.default_rng(2)
    delta = {}
    for key in sorted(entries)[:touched]:
        idx = np.array([rng.integers(0, n_chunks)], np.int32)
        delta[key] = ({"t0": (rng.normal(size=(1, chunk)).astype(
            np.float32), np.full(1, 5, np.int32), (idx, n_chunks))}, 0)
    delta = PORT.build(delta)
    PORT.ensure(store)
    budget = 256 * (chunk * 4 + 12)
    for _ in range(2):                  # the second round is steady state
        snap = tops.counters.snapshot()
        out = store.join(delta)
        tdigest.store_digest(out)
        tstore.digest_select_store(out, budget)
        cost = tops.counters.since(snap)
    assert tres.resident_of(out) is not None
    return cost


def test_resident_round_reproduces_bench_tier1_counts():
    """BENCH_tier1.json records 2 launches and 33,280 staged bytes per
    resident round at 10k keys (the delta's 64 rows plus their index
    column); the counts are size-independent, so the port must give the
    same at 10k keys and at twice that."""
    for n_obj in (10_000, 20_000):
        cost = _bench_round_cost(n_obj)
        assert cost["launches"] == 2 and cost["h2d_bytes"] == 33_280, cost
