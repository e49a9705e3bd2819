"""The port's TensorState, LatticeStore (each join fast path), digests and
state conversion against the JAX package on the same numpy inputs,
compared as numpy: values bit for bit, versions and lamports exactly."""

import ml_dtypes
import numpy as np
import pytest

from repro.core import digest as rdigest
from repro.core import store as rstore
from repro.core import tensor_lattice as rtl
from repro_torch import convert
from repro_torch.core import digest as tdigest
from repro_torch.core import store as tstore
from repro_torch.core import tensor_lattice as ttl

CHUNK = 32
NP_DTYPE = {"float32": np.float32, "float16": np.float16,
            "bfloat16": ml_dtypes.bfloat16}


def plain_store(sizes, seed, version=1, n_tensors=1, dtype="float32",
                sparse_keys=(), chunk=CHUNK):
    """A store in ``convert``'s plain form: ``sizes[i]`` chunk rows for
    each tensor of key ``k{i}``; keys in ``sparse_keys`` hold sparse row
    sets of two rows."""
    rng = np.random.default_rng(seed)
    entries = {}
    for i, n in enumerate(sizes):
        key = f"k{i}"
        tensors = {}
        for t in range(n_tensors):
            if key in sparse_keys:
                r = min(2, n)
                idx = np.sort(rng.choice(n, size=r, replace=False)).astype(
                    np.int32)
                vals = rng.normal(size=(r, chunk)).astype(np.float32)
                vers = np.full(r, version * 2 + 1, np.int32)
                sp = (idx, n)
            else:
                vals = rng.normal(size=(n, chunk)).astype(np.float32)
                vers = (rng.integers(0, 3, size=n).astype(np.int32) * 2
                        + version)
                vals[vers == 0] = 0
                sp = None
            tensors[f"t{t}"] = (vals.astype(NP_DTYPE[dtype]), vers, sp)
        entries[key] = (tensors, version)
    return entries


def ref_store(entries, life=()):
    """The JAX package's store for plain data (numpy-backed tensors)."""
    out = {}
    for key, (tensors, lamport) in entries.items():
        chunks = {}
        for name, (vals, vers, sp) in tensors.items():
            if vals.dtype.kind == "V":            # bf16 held as raw V2
                vals = vals.view(ml_dtypes.bfloat16)
            if sp is None:
                chunks[name] = rtl.ChunkedTensor(np.asarray(vals),
                                                 np.asarray(vers))
            else:
                chunks[name] = rtl.sparse_chunks(sp[1], sp[0], vals, vers)
        out[key] = rtl.TensorState.of(chunks, lamport=lamport)
    return rstore.LatticeStore.of(out, dict(life))


def ref_plain(store):
    """Plain data of a JAX-package store (the test's side of the bridge:
    the port never sees a reference object)."""
    entries = {}
    for key, val in store.entries:
        tensors = {}
        for name, ct in val.chunks:
            if ct.is_sparse:
                tensors[name] = (np.asarray(ct.vals), np.asarray(ct.vers),
                                 (np.asarray(ct.idx), ct.n_chunks))
            else:
                tensors[name] = (np.asarray(ct.values),
                                 np.asarray(ct.versions), None)
        entries[key] = (tensors, val.lamport)
    return entries, list(store.life)


def port_store(entries, life=()):
    return convert.store_from_numpy(entries, life, device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def canonical(plain):
    """Dense bit patterns per (key, tensor) plus lamports and life —
    representation-independent (sparse rows densified, ⊥ rows zero)."""
    entries, life = plain
    out = {}
    for key, (tensors, lamport) in entries.items():
        for name, (vals, vers, sp) in tensors.items():
            vals, vers = _bits(vals), np.asarray(vers)
            if sp is not None:
                idx, n = sp
                dv = np.zeros((n,) + vals.shape[1:], vals.dtype)
                dr = np.zeros(n, vers.dtype)
                dv[idx], dr[idx] = vals, vers
                vals, vers = dv, dr
            live = vers > 0
            out[(key, name)] = (vals[live].tobytes(), vers.tobytes())
        out[(key, "·lamport")] = lamport
    out["·life"] = tuple(sorted(life))
    return out


def assert_same(port, ref):
    assert canonical(convert.store_to_numpy(port)) == canonical(
        ref_plain(ref))


# ---------------------------------------------------------------------------
# TensorState
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensorstate_writes_and_join_match_reference(seed, dtype):
    rng = np.random.default_rng(seed)
    base = plain_store([6], seed, n_tensors=2, dtype=dtype)
    R = ref_store(base).get("k0")
    T = port_store(base).get("k0")
    full = rng.normal(size=(6 * CHUNK,)).astype(np.float32).astype(
        NP_DTYPE[dtype])
    part = rng.normal(size=(2, CHUNK)).astype(np.float32).astype(
        NP_DTYPE[dtype])
    idx = np.array([1, 4])
    new = rng.normal(size=(50,)).astype(np.float32)
    steps = [
        (R.write_delta(3, "t0", full), T.write_delta(3, "t0", full)),
        (R.write_delta(5, "t1", part, chunk_idx=idx),
         T.write_delta(5, "t1", part, chunk_idx=idx)),
        (R.write_delta(1, "fresh", new, chunk_size=CHUNK),
         T.write_delta(1, "fresh", new, chunk_size=CHUNK)),
    ]
    for rd, td in steps:
        assert_same(tstore.LatticeStore.of({"k": td}),
                    rstore.LatticeStore.of({"k": rd}))
        R, T = R.join(rd), T.join(td)
        assert_same(tstore.LatticeStore.of({"k": T}),
                    rstore.LatticeStore.of({"k": R}))
        assert td.leq(T) and rd.leq(R)
        assert T.leq(td) == R.leq(rd)
    assert T.write_full(2, "t0", full) == T.join(T.write_delta(2, "t0", full))
    assert [n for n, _ in T.decompose()[0].chunks] == ["fresh"]


@pytest.mark.parametrize("seed", [3, 4])
def test_tensorstate_mixed_density_join_leq_eq(seed):
    """Dense ⊔ sparse, sparse ⊔ sparse, and the cross-density order and
    equality, against the reference."""
    dense = plain_store([5, 5], seed)
    sparse = plain_store([5, 5], seed + 10, version=4,
                         sparse_keys=("k0", "k1"))
    Rd, Rs = ref_store(dense), ref_store(sparse)
    Td, Ts = port_store(dense), port_store(sparse)
    pairs = [(Rd, Rs, Td, Ts), (Rs, Rd, Ts, Td), (Rs, Rs, Ts, Ts)]
    for ra, rb, ta, tb in pairs:
        rj = ra.join(rb, batched=False)
        tj = ta.join(tb, batched=False)
        assert_same(tj, rj)
        for key in ("k0", "k1"):
            assert (tb.get(key).leq(ta.get(key))
                    == rb.get(key).leq(ra.get(key)))
            assert (tj.get(key) == ta.get(key)) == (rj.get(key)
                                                    == ra.get(key))


# ---------------------------------------------------------------------------
# LatticeStore join paths
# ---------------------------------------------------------------------------

def _stacked(store):
    sc = store.__dict__.get("_stacked_cache")
    return sc if isinstance(sc, tstore._StackedChunks) else None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("sizes", [[4, 4, 4], [1, 3, 7, 13, 5]])
def test_stacked_fast_join_matches_reference(dtype, sizes):
    a = plain_store(sizes, 0, n_tensors=2, dtype=dtype)
    b = plain_store(sizes, 1, version=3, n_tensors=2, dtype=dtype)
    got = port_store(a).join(port_store(b))
    assert _stacked(got) is not None            # the one-launch path ran
    assert_same(got, ref_store(a).join(ref_store(b)))
    assert got == port_store(a).join(port_store(b), batched=False)


@pytest.mark.parametrize("sparse_delta", [False, True])
def test_patched_fast_join_matches_reference(sparse_delta):
    sizes = [4, 4, 4]
    a, b = plain_store(sizes, 2), plain_store(sizes, 3, version=3)
    d = plain_store([4, 4], 4, version=9,
                    sparse_keys=("k1",) if sparse_delta else ())
    d = {"k1": d["k1"]}
    tj = port_store(a).join(port_store(b))
    rj = ref_store(a).join(ref_store(b))
    got = tj.join(port_store(d))
    assert _stacked(got) is not None and _stacked(got).layout == \
        _stacked(tj).layout
    e1, e2 = dict(tj.entries), dict(got.entries)
    assert e2["k0"] is e1["k0"] and e2["k2"] is e1["k2"]
    assert_same(got, rj.join(ref_store(d)))


def test_batched_join_groups_subset_and_mixed_keys():
    a = plain_store([3, 5, 2, 6], 5, n_tensors=2)
    d = plain_store([3, 5, 2, 6], 6, version=7, n_tensors=2,
                    sparse_keys=("k3",))
    d = {k: d[k] for k in ("k0", "k2", "k3")}
    got = port_store(a).join(port_store(d))
    assert_same(got, ref_store(a).join(ref_store(d)))
    assert got == port_store(a).join(port_store(d), batched=False)


def test_general_join_respects_tombstone_epochs():
    a = plain_store([3, 4, 5], 7)
    b = plain_store([3, 4, 5], 8, version=5)
    life_a = [("k0", (1, float("-inf")))]
    life_b = [("k1", (2, 10.0)), ("k2", (0, 5.0))]
    ra = ref_store(a, life_a)
    rb = ref_store({"k1": b["k1"], "k2": b["k2"]}, life_b)
    ta = port_store(a, life_a)
    tb = port_store({"k1": b["k1"], "k2": b["k2"]}, life_b)
    assert_same(ta.join(tb), ra.join(rb))
    assert_same(tb.join(ta), rb.join(ra))
    assert ta.join(tb) == tb.join(ta)
    assert ta.leq(ta.join(tb)) and not ta.join(tb).leq(ta)


def test_store_decompose_rejoins_to_the_store():
    t = port_store(plain_store([3, 2], 9, n_tensors=2),
                   [("k1", (1, 4.0))])
    acc = tstore.LatticeStore.bottom()
    for atom in t.decompose():
        acc = acc.join(atom)
    assert acc == t
    assert len(t.decompose()) == len(ref_store(
        plain_store([3, 2], 9, n_tensors=2),
        [("k1", (1, 4.0))]).decompose())


# ---------------------------------------------------------------------------
# Digests and selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget_rows", [1, 5, 12, 1000])
def test_digest_select_store_matches_reference(budget_rows):
    p = plain_store([6, 6, 6], 10, n_tensors=2)
    per_row = CHUNK * 4 + 12
    got = tstore.digest_select_store(port_store(p), budget_rows * per_row)
    want = rstore.digest_select_store(ref_store(p), budget_rows * per_row)
    assert_same(got, want)


def test_store_digest_and_digest_diff_match_reference():
    p = plain_store([4, 6, 3], 11, n_tensors=2)
    q = plain_store([4, 6, 3], 12, version=3, n_tensors=2,
                    sparse_keys=("k2",))
    life = [("k1", (1, 7.0))]
    T, R = port_store(p, life), ref_store(p, life)
    tq, rq = port_store(q), ref_store(q)
    td, rd = tdigest.store_digest(tq), rdigest.store_digest(rq)
    assert set(td.tensors) == set(rd.tensors)
    for k in td.tensors:
        np.testing.assert_array_equal(td.tensors[k], rd.tensors[k])
    assert td.life == rd.life
    assert_same(tdigest.digest_diff(T, td), rdigest.digest_diff(R, rd))
    # join equivalence: requester ⊔ diff == requester ⊔ responder
    assert tq.join(tdigest.digest_diff(T, td)) == tq.join(T)


def test_digest_of_joined_stacked_store_matches_plain():
    p, q = plain_store([3, 5], 13), plain_store([3, 5], 14, version=3)
    j = port_store(p).join(port_store(q))
    assert _stacked(j) is not None
    plain = tstore.LatticeStore(j.entries, j.life)
    assert tdigest.store_digest(j) == tdigest.store_digest(plain)


# ---------------------------------------------------------------------------
# Carrying state across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_store_numpy_round_trips(dtype):
    p = plain_store([3, 4, 2], 15, n_tensors=2, dtype=dtype,
                    sparse_keys=("k1",))
    life = [("k2", (1, 3.5))]
    t = port_store(p, life)
    back = convert.store_to_numpy(t)
    assert canonical(back) == canonical((p, life))
    assert port_store(*back) == t
    # reference → plain → port → plain → reference
    r = ref_store(p, life)
    t2 = port_store(*ref_plain(r))
    assert canonical(convert.store_to_numpy(t2)) == canonical(ref_plain(r))
    r2 = ref_store(*convert.store_to_numpy(t2))
    assert r2 == r


def test_pack_and_unpack_delta_match_reference():
    p = plain_store([5], 16, n_tensors=2)
    R, T = ref_store(p).get("k0"), port_store(p).get("k0")
    known = {"t0": np.asarray(p["k0"][0]["t0"][1]) - 1}
    rp, tp = rtl.pack_delta(R, known), ttl.pack_delta(T, known)
    assert rp["lamport"] == tp["lamport"] and set(rp["tensors"]) == set(
        tp["tensors"])
    for name, (ri, rv, rr, rs) in rp["tensors"].items():
        ti, tv, tr, ts = tp["tensors"][name]
        np.testing.assert_array_equal(ti, ri)
        np.testing.assert_array_equal(tv, rv)
        np.testing.assert_array_equal(tr, rr)
        assert tuple(ts) == tuple(rs)
    for sparse in (True, False):
        back = ttl.unpack_delta(tp, sparse=sparse)
        assert back.leq(T) and all(ct.is_sparse == sparse
                                   for _, ct in back.chunks)
        ref_back = rtl.unpack_delta(rp, sparse=sparse)
        assert_same(tstore.LatticeStore.of({"k": back}),
                    rstore.LatticeStore.of({"k": ref_back}))
