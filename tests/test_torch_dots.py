"""Causal contexts, dot stores and the columnar causal join of the port
(``repro_torch.core.dots`` / ``dotcols``) against the JAX package's, on
the same inputs made from seeds. Everything here is exact: contexts,
masks, joins and digest responses are held equal, bit for bit where they
are columns.

The containment mask is held four ways: the port's numpy path, its torch
path run on the CPU, the JAX package's numpy path and
``CausalContext.contains`` dot by dot."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import crdts as rcrdts
from repro.core import dotcols as rdc
from repro.core import dots as rdots
from repro.core.digest import _canon as rcanon
from repro_torch import convert
from repro_torch.core import crdts as tcrdts
from repro_torch.core import dotcols as tdc
from repro_torch.core import dots as tdots
from repro_torch.core.digest import _canon as tcanon
from repro_torch.core.digest import _causal_diff_obj

ROOT = Path(__file__).resolve().parents[1]
SEEDS = list(range(8))
SEQ_BITS = 48


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _random_dots(rng, n_rids=4, n=60, top=40):
    """Dots over ``n_rids`` replicas with gaps (so clouds form)."""
    return [(f"r{int(rng.integers(n_rids))}", int(rng.integers(1, top)))
            for _ in range(n)]


def _ctx_pair(rng, **kw):
    dots = _random_dots(rng, **kw)
    return (tdots.CausalContext.from_dots(dots),
            rdots.CausalContext.from_dots(dots), dots)


def _same_ctx(t, r):
    assert t.vv == r.vv and t.cloud == r.cloud


# ---------------------------------------------------------------------------
# Causal contexts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_causal_context_compression_matches_reference(seed):
    """§7.2 compression: the port and the JAX package compress the same
    dots to the same (vv, cloud), which covers exactly those dots, and
    agree on join, leq, max_for, next_dot and the contiguous-append fast
    path of ``add_dots``."""
    rng = np.random.default_rng(seed)
    ta, ra, dots = _ctx_pair(rng)
    tb, rb, _ = _ctx_pair(rng)
    _same_ctx(ta, ra)
    assert ta.dots() == frozenset(dots)
    _same_ctx(ta.join(tb), ra.join(rb))
    assert ta.leq(tb) == ra.leq(rb) and ta.leq(ta.join(tb))
    for i in ("r0", "r1", "r2", "r3", "r9"):
        assert ta.max_for(i) == ra.max_for(i)
        assert ta.next_dot(i) == ra.next_dot(i)
    # per-op appends: each replica adds its own next dots
    appends = tuple((i, ta.max_for(i) + k) for i in ("r0", "r5")
                    for k in (1, 2))
    _same_ctx(ta.add_dots(appends), ra.add_dots(appends))
    _same_ctx(ta.add_dots(appends),
              tdots._normalize(dict(ta.vv), set(ta.cloud) | set(appends)))


@pytest.mark.parametrize("seed", SEEDS)
def test_causal_context_join_is_a_lattice_join(seed):
    rng = np.random.default_rng(100 + seed)
    a, b, c = (_ctx_pair(rng)[0] for _ in range(3))
    assert a.join(a) == a
    assert a.join(b) == b.join(a)
    assert a.join(b).join(c) == a.join(b.join(c))
    assert a.leq(b) == (a.join(b) == b)
    assert a.join(b).dots() == a.dots() | b.dots()


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_columnar_context_matches_object_context(seed):
    rng = np.random.default_rng(200 + seed)
    ta, ra, _ = _ctx_pair(rng)
    tb, _, _ = _ctx_pair(rng)
    cols = tdc.CausalContextCols.from_obj(ta)
    rcols = rdc.CausalContextCols.from_obj(ra)
    assert cols.rids == rcols.rids
    np.testing.assert_array_equal(cols.vvcol, rcols.vvcol)
    np.testing.assert_array_equal(cols.cloudcol, rcols.cloudcol)
    assert cols == ta and cols.to_obj() == ta and hash(cols) == hash(ta)
    assert cols.join(tb) == ta.join(tb)
    assert cols.leq(tb) == ta.leq(tb)
    for d in _random_dots(rng, n=40):
        assert cols.contains(d) == ta.contains(d)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normalize_cols_matches_reference(seed):
    rng = np.random.default_rng(300 + seed)
    vv = rng.integers(0, 20, 5).astype(np.int64)
    rid = rng.integers(0, 5, 200).astype(np.int64)
    cloud = (rid << SEQ_BITS) | rng.integers(1, 60, 200).astype(np.int64)
    got = tdc._normalize_cols(vv, cloud)
    want = rdc._normalize_cols(vv, cloud)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The containment mask
# ---------------------------------------------------------------------------

def _mask_case(case, seed=0):
    """(rids, vv, sorted cloud, dots) in one rid space."""
    rng = np.random.default_rng(seed)
    if case == "top-rid":
        # the last index a packed dot can carry (rid index < 2^15)
        n_rids = 1 << 15
        hot = np.array([0, 1, n_rids - 2, n_rids - 1], np.int64)
    else:
        n_rids = 5
        hot = np.arange(n_rids, dtype=np.int64)
    base = (1 << SEQ_BITS) - 64 if case == "seq-near-2^48" else 0
    vv = np.zeros(n_rids, np.int64)
    vv[hot] = base + rng.integers(0, 30, hot.size)
    rid = hot[rng.integers(0, hot.size, 400)]
    seq = base + rng.integers(1, 62, 400)
    if case == "above-every-vv":
        seq = vv[rid] + 1 + rng.integers(0, 20, 400)
    dots = (rid << SEQ_BITS) | seq.astype(np.int64)
    cloud = np.zeros(0, np.int64)
    if case != "empty-cloud":
        pick = dots[rng.integers(0, dots.size, 60)]
        cloud = np.unique(pick[(pick & int(tdc.SEQ_MASK)) > vv[pick >>
                                                                SEQ_BITS]])
    rids = tuple(f"r{j:05d}" for j in range(n_rids))
    return rids, vv, cloud, dots


MASK_CASES = ["random", "empty-cloud", "above-every-vv", "top-rid",
              "seq-near-2^48"]


@pytest.mark.parametrize("case", MASK_CASES)
def test_missing_mask_four_ways(case):
    rids, vv, cloud, dots = _mask_case(case)
    want = rdc.missing_mask(vv, cloud, dots, backend="numpy")
    np.testing.assert_array_equal(
        tdc.missing_mask(vv, cloud, dots, backend="numpy"), want)
    with tdc.mask_device("cpu"):
        np.testing.assert_array_equal(
            tdc.missing_mask(vv, cloud, dots, backend="torch"), want)
    # dot by dot through the object context (only the rids that hold dots)
    ctx = rdots.CausalContext(
        vv=tuple(sorted((rids[j], int(n)) for j, n in enumerate(vv) if n)),
        cloud=frozenset((rids[int(d) >> SEQ_BITS],
                         int(d & int(tdc.SEQ_MASK))) for d in cloud))
    contained = [ctx.contains((rids[int(d) >> SEQ_BITS],
                               int(d & int(tdc.SEQ_MASK)))) for d in dots]
    np.testing.assert_array_equal(want, ~np.array(contained))
    if case == "above-every-vv":
        assert want.sum() == dots.size - np.isin(dots, cloud).sum()
    if case != "empty-cloud":
        assert cloud.size and not want[np.isin(dots, cloud)].any()


def test_missing_mask_dispatch():
    """Auto-dispatch: numpy below ``_DEVICE_MIN_ROWS`` rows and wherever
    the scope says CPU; at the threshold the default scope is the card,
    which raises where there is none instead of falling back. An empty
    column and an unknown backend are handled."""
    rng = np.random.default_rng(7)
    n = tdc._DEVICE_MIN_ROWS
    vv = np.array([n // 2, n // 3], np.int64)
    dots = np.sort((rng.integers(0, 2, n).astype(np.int64) << SEQ_BITS)
                   | rng.integers(1, n, n).astype(np.int64))
    cloud = np.unique(dots[-50:])
    want = rdc.missing_mask(vv, cloud, dots, backend="numpy")
    before = dict(tdc.launches)
    np.testing.assert_array_equal(tdc.missing_mask(vv, cloud, dots[:-1]),
                                  want[:-1])          # below: numpy
    with tdc.mask_device("cpu"):
        np.testing.assert_array_equal(tdc.missing_mask(vv, cloud, dots),
                                      want)
    assert tdc.launches == before                     # no card launch
    assert tdc.missing_mask(vv, cloud, dots[:0]).shape == (0,)
    with pytest.raises(ValueError):
        tdc.missing_mask(vv, cloud, dots, backend="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdc.missing_mask(vv, cloud, dots)


# ---------------------------------------------------------------------------
# Columnar causal joins
# ---------------------------------------------------------------------------

def _mut_set(C, v, rid, rng):
    if rng.random() < 0.72 or not v.elements():
        return v.join(v.add_delta(rid, rng.randrange(20)))
    return v.join(v.rmv_delta(rid, rng.choice(sorted(v.elements()))))


def _mut_map(C, m, rid, rng):
    k = "k%d" % rng.randrange(8)
    roll = rng.random()
    if roll < 0.45:
        return m.join(m.apply_delta(rid, k, C.AWORSet, "add_delta",
                                    rng.randrange(9)))
    if roll < 0.8:
        return m.join(m.apply_delta(rid, k, C.MVRegister, "write_delta",
                                    rng.randrange(9)))
    return m.join(m.rmv_delta(rid, k))


def _mut_flag(C, f, rid, rng):
    return f.join(f.enable_delta(rid) if rng.random() < 0.6
                  else f.disable_delta(rid))


MUTATORS = {"AWORSet": _mut_set, "ORMap": _mut_map, "EWFlag": _mut_flag}


def _replica_states(C, typ, seed, n_reps=3, steps=40):
    """Causally consistent replica states: each replica mints its own
    rid's dots and now and then joins another's state."""
    rng = random.Random(seed)
    mutate = MUTATORS[typ]
    states = [getattr(C, typ).bottom() for _ in range(n_reps)]
    for _ in range(steps):
        i = rng.randrange(n_reps)
        if rng.random() < 0.2:
            states[i] = states[i].join(states[rng.randrange(n_reps)])
        else:
            states[i] = mutate(C, states[i], f"r{i}", rng)
    return states


def _canon_obj(canon, dc, value):
    return canon(dc.value_to_obj(value))


@pytest.mark.parametrize("typ", sorted(MUTATORS))
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_columnar_join_equals_object_join_and_reference(typ, seed):
    t = _replica_states(tcrdts, typ, seed)
    r = _replica_states(rcrdts, typ, seed)
    for (ta, tb), (ra, rb) in zip([(t[0], t[1]), (t[1], t[2])],
                                  [(r[0], r[1]), (r[1], r[2])]):
        assert tcanon(ta) == rcanon(ra)
        want = ta.join(tb)                               # object path
        got = tdc.value_to_cols(ta).join(tdc.value_to_cols(tb))
        assert got == want and want == got
        rgot = rdc.value_to_cols(ra).join(rdc.value_to_cols(rb))
        assert _canon_obj(tcanon, tdc, got) == _canon_obj(rcanon, rdc, rgot)
        # mixed representations dispatch to the columnar join
        mixed = type(ta)(*tdots.causal_join(tdc.value_to_cols(ta).store,
                                            tdc.value_to_cols(ta).ctx,
                                            tb.store, tb.ctx))
        assert mixed == want


def test_nested_ormap_stays_on_the_object_path():
    inner = tcrdts.ORMap().apply_delta("a", "x", tcrdts.MVRegister,
                                       "write_delta", 1)
    m = tcrdts.ORMap(tdots.DotMap.of({"outer": inner.store}), inner.ctx)
    assert tdc.value_to_cols(m) is None
    assert m.join(m) == m


def _join_inputs_both(per_rid):
    ref = _load("bench_dots", ROOT / "benchmarks" / "bench_dots.py")
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    return smoke.join_inputs(per_rid), ref._join_inputs(per_rid)


def test_million_dot_join_bit_identical_to_reference():
    """The chip smoke's 1,062,500-dot join inputs (250,000 dots a replica
    over 4 replicas), built in the port through ``convert``, join to the
    same columns as the JAX package's ``causal_join_cols`` on its own
    inputs from ``benchmarks/bench_dots.py``."""
    (sa, ca, sb, cb), (rsa, rca, rsb, rcb) = _join_inputs_both(250_000)
    for t, r in ((sa, rsa), (sb, rsb)):
        assert t.rids == r.rids and np.array_equal(t.packed, r.packed)
    assert sa.packed.size + sb.packed.size == 1_062_500
    with tdc.mask_device("cpu"):
        ts, tc = tdc.causal_join_cols(sa, ca, sb, cb)
    rs, rc = rdc.causal_join_cols(rsa, rca, rsb, rcb)
    assert ts.rids == rs.rids and tc.rids == rc.rids
    np.testing.assert_array_equal(ts.packed, rs.packed)
    np.testing.assert_array_equal(tc.vvcol, rc.vvcol)
    np.testing.assert_array_equal(tc.cloudcol, rc.cloudcol)
    assert ts.packed.dtype == np.int64 and tc.vvcol.dtype == np.int64


def test_small_join_equals_the_frozenset_oracle():
    (sa, ca, sb, cb), _ = _join_inputs_both(2_000)
    got = tdc.causal_join_cols(sa, ca, sb, cb)
    so, co = tdots.causal_join(sa.to_obj(), ca.to_obj(), sb.to_obj(),
                               cb.to_obj())
    assert got[0].to_obj() == so and got[1].to_obj() == co


# ---------------------------------------------------------------------------
# Per-dot digest responses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("typ", sorted(MUTATORS))
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_causal_diff_cols_matches_oracle_and_reference(typ, seed):
    """For a requester / responder pair: the port's columnar response
    equals its set-based oracle and the JAX package's response, joining
    it at the requester gives the responder's full-state join, and it
    ships no dot the requester's context holds."""
    t = _replica_states(tcrdts, typ, seed + 50)
    r = _replica_states(rcrdts, typ, seed + 50)
    for (req, resp), (rreq, rresp) in (((t[0], t[1]), (r[0], r[1])),
                                       ((t[2], t[0]), (r[2], r[0]))):
        g = tdc.causal_digest_of(req)
        rg = rdc.causal_digest_of(rreq)
        assert g.rids == rg.rids and np.array_equal(g.dotcol, rg.dotcol)
        got = tdc.causal_diff_cols(resp, g)
        oracle = _causal_diff_obj(resp, g)
        want = rdc.causal_diff_cols(rresp, rg)
        if oracle is None:
            assert got is None and want is None
            assert req.join(resp) == req
            continue
        assert got == oracle
        assert _canon_obj(tcanon, tdc, got) == _canon_obj(rcanon, rdc, want)
        assert req.join(got) == req.join(resp)
        assert not any(req.ctx.contains(d) for d in got.store.all_dots())


def test_dotstore_from_numpy_builds_each_shape():
    rids = ("a", "b")
    dots = np.array([1, 2, (1 << SEQ_BITS) | 1], np.int64)
    s, c = convert.dotstore_from_numpy(rids, dots, [2, 1])
    assert s == tdots.DotSet(frozenset({("a", 1), ("a", 2), ("b", 1)}))
    assert c == tdots.CausalContext.from_vv({"a": 2, "b": 1})
    f, _ = convert.dotstore_from_numpy(rids, dots, [2, 1],
                                       vals=[("x", 1), "y", 3])
    assert f.as_dict() == {("a", 1): ("x", 1), ("a", 2): "y", ("b", 1): 3}
    m, _ = convert.dotstore_from_numpy(
        rids, dots, [2, 1], cloud=[(1 << SEQ_BITS) | 3], vals=[1, 2, 3],
        keys=("k", "q"), offsets=[0, 2, 3])
    rm = rdc.DotMapCols(rids, ("k", "q"), bytes([rdc.SHAPE_FUN]) * 2,
                        np.array([0, 2, 3]), dots,
                        np.array([1, 2, 3], object))
    assert tcanon(m.to_obj()) == rcanon(rm.to_obj())
