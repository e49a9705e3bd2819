"""The port's kernel wrappers and plain versions against the JAX package:
its jnp oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy inputs. Joins, versions and max|x| are
held bit-exact; Σx² to rtol 1e-4 (summation order differs). Plus the
join's lattice laws, the pad-row and old-snapshot contracts of the
scatter ingest, and dispatch that raises instead of falling back. The
CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import delta_join as dj

SUMSQ_RTOL = 1e-4
DTYPES = ["float32", "bfloat16", "float16"]
NP_DTYPE = {"float32": np.float32, "float16": np.float16,
            "bfloat16": ml_dtypes.bfloat16}


def _vals(rng, n, chunk, dtype):
    """Values made once in numpy, in the working dtype (both packages
    then hold identical bits)."""
    return rng.normal(size=(n, chunk)).astype(np.float32).astype(
        NP_DTYPE[dtype])


def _t(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}")


def _operands(n, chunk, dtype, seed, tie_share=0.2):
    """(a_vals, a_vers, b_vals, b_vers) numpy; tied versions carry equal
    values (the lattice's precondition)."""
    rng = np.random.default_rng(seed)
    av, bv = _vals(rng, n, chunk, dtype), _vals(rng, n, chunk, dtype)
    avr = rng.integers(0, 50, size=n).astype(np.int32)
    bvr = rng.integers(0, 50, size=n).astype(np.int32)
    tie = rng.random(n) < tie_share
    bvr[tie] = avr[tie]
    bv[tie] = av[tie]
    return av, avr, bv, bvr


SHAPES = [(8, 128), (13, 128), (100, 256), (1, 64)]


# ---------------------------------------------------------------------------
# Plain versions and CPU wrappers vs the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,chunk", SHAPES)
def test_delta_join_matches_reference_oracle_and_pallas(dtype, n, chunk):
    av, avr, bv, bvr = _operands(n, chunk, dtype, seed=n)
    ov, over = ops.delta_join(_t(av), _t(avr), _t(bv), _t(bvr))
    rv, rvr = jref.delta_join_ref(jnp.asarray(av), jnp.asarray(avr),
                                  jnp.asarray(bv), jnp.asarray(bvr))
    pv, pvr = jops.delta_join(jnp.asarray(av), jnp.asarray(avr),
                              jnp.asarray(bv), jnp.asarray(bvr),
                              block_n=8, interpret=True)
    for want_v, want_r in ((rv, rvr), (pv, pvr)):
        np.testing.assert_array_equal(_bits(ov), _bits(want_v))
        np.testing.assert_array_equal(over.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,chunk", SHAPES)
def test_chunk_digest_matches_reference_oracle_and_pallas(dtype, n, chunk):
    x = _vals(np.random.default_rng(n + 1), n, chunk, dtype)
    ma, ss = ops.chunk_digest(_t(x))
    for rma, rss in (jref.chunk_digest_ref(jnp.asarray(x)),
                     jops.chunk_digest(jnp.asarray(x), block_n=8,
                                       interpret=True)):
        np.testing.assert_array_equal(ma.numpy(), np.asarray(rma))
        np.testing.assert_allclose(ss.numpy(), np.asarray(rss),
                                   rtol=SUMSQ_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,chunk", SHAPES)
def test_fused_join_digest_matches_reference_oracle_and_pallas(dtype, n,
                                                               chunk):
    av, avr, bv, bvr = _operands(n, chunk, dtype, seed=2 * n)
    got = ops.fused_join_digest(_t(av), _t(avr), _t(bv), _t(bvr))
    args = [jnp.asarray(a) for a in (av, avr, bv, bvr)]
    for want in (jref.fused_join_digest_ref(*args),
                 jops.fused_join_digest(*args, block_n=8, interpret=True)):
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=SUMSQ_RTOL)


def _scatter_operands(n, chunk, dtype, r, pad, seed):
    """Resident columns + ``r`` unique delta rows + ``pad`` ⊥ pad rows
    that all target one free row (the resident ingest's convention)."""
    rng = np.random.default_rng(seed)
    vals = _vals(rng, n, chunk, dtype)
    vers = rng.integers(1, 20, size=n).astype(np.int32)
    ma, ss = (np.asarray(c) for c in jref.chunk_digest_ref(
        jnp.asarray(vals)))
    idx = np.sort(rng.choice(n - 1, size=r, replace=False)).astype(np.int32)
    free = int(np.setdiff1d(np.arange(n), idx)[0])
    d_vals = _vals(rng, r, chunk, dtype)
    d_vers = rng.integers(0, 40, size=r).astype(np.int32)
    idx = np.concatenate([idx, np.full(pad, free, np.int32)])
    d_vals = np.concatenate([d_vals, np.zeros((pad, chunk), d_vals.dtype)])
    d_vers = np.concatenate([d_vers, np.zeros(pad, np.int32)])
    return vals, vers, ma, ss, idx, d_vals, d_vers


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,r,pad", [(16, 3, 5), (40, 8, 0), (9, 1, 7)])
def test_scatter_join_matches_reference_with_pad_rows(dtype, n, r, pad):
    operands = _scatter_operands(n, 128, dtype, r, pad, seed=n + r)
    vals, vers, ma, ss, idx, d_vals, d_vers = operands
    got = ops.scatter_join(_t(vals), _t(vers), _t(ma), _t(ss), idx,
                           d_vals, d_vers)
    jargs = [jnp.asarray(a) for a in operands]
    for want in (jref.scatter_join_ref(*jargs),
                 jops.scatter_join(*jargs, interpret=True)):
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=SUMSQ_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_join_leaves_old_snapshot_values_intact(dtype):
    operands = _scatter_operands(24, 64, dtype, 6, 2, seed=5)
    vals, vers, ma, ss, idx, d_vals, d_vers = operands
    cols = [_t(c) for c in (vals, vers, ma, ss)]
    before = [c.clone() for c in cols]
    out = ops.scatter_join(*cols, idx, d_vals, d_vers)
    for old, kept, new in zip(cols, before, out):
        np.testing.assert_array_equal(_bits(old), _bits(kept))
        assert new.data_ptr() != old.data_ptr()
    # rows no delta row targets are carried over unchanged
    untouched = np.setdiff1d(np.arange(24), idx)
    np.testing.assert_array_equal(_bits(out[0])[untouched],
                                  _bits(vals)[untouched])


def test_scatter_join_empty_is_a_no_op_without_launch():
    vals, vers, ma, ss, *_ = _scatter_operands(8, 32, "float32", 1, 0, 0)
    cols = [_t(c) for c in (vals, vers, ma, ss)]
    snap = ops.counters.snapshot()
    out = ops.scatter_join(*cols, np.zeros(0, np.int32),
                           np.zeros((0, 32), np.float32),
                           np.zeros(0, np.int32))
    assert all(o is c for o, c in zip(out, cols))
    assert ops.counters.since(snap)["launches"] == 0


@pytest.mark.parametrize("sizes,chunks,dtypes", [
    ([4, 4, 4], [128] * 3, ["float32"] * 3),
    ([1, 3, 7, 13, 5], [128] * 5, ["float32"] * 5),
    ([4, 6, 4, 10], [128, 256, 128, 128],
     ["float32", "float32", "bfloat16", "float32"]),
])
def test_batched_delta_join_groups_like_reference(sizes, chunks, dtypes):
    segs, jsegs = [], []
    for i, (n, c, dt) in enumerate(zip(sizes, chunks, dtypes)):
        av, avr, bv, bvr = _operands(n, c, dt, seed=40 + i)
        segs.append(tuple(_t(a) for a in (av, avr, bv, bvr)))
        jsegs.append(tuple(jnp.asarray(a) for a in (av, avr, bv, bvr)))
    groups = len(set(zip(chunks, dtypes)))
    snap = ops.counters.snapshot()
    outs = ops.batched_delta_join(segs)
    assert ops.counters.since(snap)["launches"] == groups
    refs = jops.batched_delta_join(jsegs, block_n=8, interpret=True)
    for (ov, over), (rv, rvr) in zip(outs, refs):
        np.testing.assert_array_equal(_bits(ov), _bits(rv))
        np.testing.assert_array_equal(over.numpy(), np.asarray(rvr))


# ---------------------------------------------------------------------------
# The join is a join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_delta_join_satisfies_lattice_laws(seed):
    rng = np.random.default_rng(seed)
    n, chunk = 64, 128
    # equal versions ⇒ equal values: derive each row from its version
    vers = rng.integers(0, 6, size=(3, n)).astype(np.int32)
    vals = vers[..., None].astype(np.float32) * np.ones((1, 1, chunk),
                                                        np.float32)
    a, b, c = [(_t(vals[i]), _t(vers[i])) for i in range(3)]

    def J(x, y):
        return ops.delta_join(x[0], x[1], y[0], y[1])

    def eq(x, y):
        return torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])

    assert eq(J(a, a), a)                      # idempotent
    assert eq(J(a, b), J(b, a))                # commutative
    assert eq(J(J(a, b), c), J(a, J(b, c)))    # associative


# ---------------------------------------------------------------------------
# Dispatch: checks, and no fallback from the kernel route
# ---------------------------------------------------------------------------

def test_card_route_without_library_raises_instead_of_falling_back(
        monkeypatch, tmp_path):
    """A tensor routed to the kernel (the device check stubbed to say
    "on the card") whose library cannot be built raises; the plain
    version is never consulted."""
    monkeypatch.setattr(dj, "on_card", lambda t: True)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_used(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    for name in ("delta_join_ref", "fused_join_digest_ref",
                 "chunk_digest_ref", "scatter_join_ref"):
        monkeypatch.setattr(ref, name, plain_used)
    av, avr, bv, bvr = (_t(a) for a in _operands(4, 32, "float32", 0))
    before = dict(dj.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.delta_join(av, avr, bv, bvr)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.fused_join_digest(av, avr, bv, bvr)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.chunk_digest(av)
    ma = torch.zeros(4)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.scatter_join(av, avr, ma, ma.clone(), np.array([1], np.int32),
                         np.ones((1, 32), np.float32),
                         np.array([7], np.int32))
    assert dj.launches == before


def test_wrappers_reject_malformed_operands():
    av, avr, bv, bvr = (_t(a) for a in _operands(4, 32, "float32", 1))
    with pytest.raises(TypeError):
        dj.delta_join(av, avr.long(), bv, bvr.long())
    with pytest.raises(ValueError):
        dj.delta_join(av, avr, bv[:3], bvr[:3])
    with pytest.raises(ValueError):
        dj.chunk_digest(av.reshape(-1))
    ma = torch.zeros(4)
    with pytest.raises(IndexError):
        ops.scatter_join(av, avr, ma, ma.clone(), np.array([4], np.int32),
                         np.ones((1, 32), np.float32),
                         np.array([7], np.int32))


def test_counters_stage_numpy_and_host_tensors_only():
    c = ops.KernelCounters()
    host = torch.zeros(10)
    c.count_h2d(np.zeros(4, np.float32), host, device="cpu")
    assert c.h2d_bytes == 16                   # CPU launch: numpy only
    c.count_h2d(host, device="cuda")
    assert c.h2d_bytes == 56                   # a host tensor bound off-host
    snap = c.snapshot()
    c.count_d2h(host)
    assert c.since(snap) == {"launches": 0, "h2d_bytes": 0, "d2h_bytes": 40}


def test_launch_hook_sees_each_named_launch_and_its_staging():
    seen = []
    ops.set_launch_hook(lambda name, h2d: seen.append((name, h2d)))
    try:
        av, avr, bv, bvr = _operands(4, 32, "float32", 3)
        ops.delta_join(_t(av), _t(avr), _t(bv), _t(bvr))
        ops.scatter_join(_t(av), _t(avr), torch.zeros(4), torch.zeros(4),
                         np.array([2], np.int32), bv[:1], bvr[:1])
    finally:
        ops.set_launch_hook(None)
    assert seen == [("delta_join", 0),
                    ("scatter_join", 4 + bv[:1].nbytes + 4)]
