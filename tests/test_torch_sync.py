"""Slice D of the port against the JAX package on the same inputs: the
additive dot store (``DotSumStore`` laws and sums, ``IntervalSum``),
``TopKCompressor`` on inputs with ties (indices, values and residuals
exact — ties go to the lower index, as ``lax.top_k`` breaks them), the
``topk`` frame byte for byte, and the delta-sync pod runs of
``tests/test_sync.py`` and ``tests/test_elastic_training.py`` (lossy
3-pod training, top-k payloads, a crash and recovery, a scale-up): the
same message counts and bytes by kind, the same dots merged, outer
parameters equal to rtol 1e-6 (f32 sums in the same order)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NetConfig as JNetConfig
from repro.core import Simulator as JSimulator
from repro.core import converged as jconverged
from repro.core import run_to_convergence as jrun_to_convergence
from repro.core.tensor_lattice import DotSumStore as JDotSumStore
from repro.core.tensor_lattice import IntervalSum as JIntervalSum
from repro.sync import DeltaSyncPod as JDeltaSyncPod
from repro.sync import TopKCompressor as JTopKCompressor
from repro.sync.compression import dense_nbytes as jdense_nbytes
from repro.sync.compression import sparse_nbytes as jsparse_nbytes
from repro.sync.compression import topk_frame as jtopk_frame
from repro.sync.compression import topk_unframe as jtopk_unframe
from repro_torch import tree as tu
from repro_torch.core import (NetConfig, Simulator, converged,
                              run_to_convergence)
from repro_torch.core.tensor_lattice import DotSumStore, IntervalSum
from repro_torch.dtypes import to_numpy
from repro_torch.sync import (DeltaSyncPod, OuterParams, TopKCompressor,
                              topk_frame, topk_unframe)
from repro_torch.sync.compression import dense_nbytes, sparse_nbytes
from repro_torch.sync.localsgd import CompressedAggregator

RTOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "deep": [{"b": rng.normal(size=(5,)).astype(np.float32)}],
            "s": np.float32(rng.normal())}


def _tt(tree):
    return tu.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# DotSumStore / IntervalSum
# ---------------------------------------------------------------------------

def _stores():
    a = DotSumStore.bottom().contribute_full("p0", _tt(_tree(0)))
    a = a.contribute_full("p0", _tt(_tree(1)))
    b = DotSumStore.bottom().contribute_full("p1", _tt(_tree(2)))
    c = b.join(DotSumStore.bottom().contribute_full("p2", _tt(_tree(3))))
    return a, b, c


def test_dot_sum_store_is_a_join_semilattice():
    a, b, c = _stores()
    assert a.join(b) == b.join(a)
    assert a.join(b).join(c) == a.join(b.join(c))
    assert a.join(a) == a
    assert a.leq(a.join(b)) and b.leq(a.join(b)) and not a.leq(b)
    assert DotSumStore.bottom().leq(a)
    merged = a.join(c)
    atoms = merged.decompose()
    assert len(atoms) == 4
    acc = DotSumStore.bottom()
    for atom in reversed(atoms):
        acc = acc.join(atom)
    assert acc == merged
    assert merged.version_vector() == {"p0": 2, "p1": 1, "p2": 1}
    # a re-delivered dot is absorbed once (unique dots)
    assert merged.join(a).join(a) == merged
    assert len(merged.join(a).dots) == 4
    d = a.contribute_delta("p0", _tt(_tree(9)))
    assert d.dots[0][0] == ("p0", 3)
    assert DotSumStore.bottom().total() is None


def test_dot_sum_totals_match_jax():
    trees = [_tree(s) for s in range(4)]
    producers = ["p0", "p1", "p0", "p2"]
    jt, tt = JDotSumStore.bottom(), DotSumStore.bottom()
    for p, t in zip(producers, trees):
        jt = jt.join(jt.contribute_delta(p, _jt(t)))
        tt = tt.join(tt.contribute_delta(p, _tt(t)))
    assert [d for d, _ in jt.dots] == [d for d, _ in tt.dots]
    got, want = tt.total(), jt.total()
    for g, w in zip(tu.leaves(got), jax.tree_util.tree_leaves(want)):
        assert to_numpy(g).tobytes() == np.asarray(w).tobytes()


def test_interval_sum_matches_the_dot_store_and_jax():
    trees = [_tree(s) for s in range(5)]
    ref = DotSumStore.bottom()
    agg, jagg = IntervalSum(), JIntervalSum()
    for t in trees[:3]:
        ref = ref.join(ref.contribute_delta("p0", _tt(t)))
    assert not agg.apply_interval("p0", 2, [_tt(trees[1])])    # gap
    for a, conv in ((agg, _tt), (jagg, _jt)):
        assert a.apply_interval("p0", 1, [conv(trees[0]), conv(trees[1])])
        assert a.apply_interval("p0", 1, [conv(trees[0])])     # duplicate
        assert a.apply_interval("p0", 2, [conv(trees[1]), conv(trees[2])])
    assert agg.prefix == jagg.prefix == {"p0": 3}
    assert agg.matches(ref)
    for g, w in zip(tu.leaves(agg.sum), jax.tree_util.tree_leaves(jagg.sum)):
        assert to_numpy(g).tobytes() == np.asarray(w).tobytes()
    outer = CompressedAggregator(_tt(trees[4]), num_pods=3)
    assert outer.apply("p0", 1, [_tt(trees[0])])
    want = OuterParams(_tt(trees[4]), 1 / 3).materialize(
        DotSumStore.bottom().contribute_full("p0", _tt(trees[0])))
    for g, w in zip(tu.leaves(outer.params()), tu.leaves(want)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Top-k compression and frames
# ---------------------------------------------------------------------------

def _tied_update(seed):
    """Magnitudes drawn from a handful of values: most of the top-k
    boundary is ties."""
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(-3, 4, size=(6, 7)).astype(np.float32),
            "h": {"k": np.repeat(rng.normal(size=8).astype(np.float32), 4)},
            "s": np.float32(2.0)}


@pytest.mark.parametrize("rate", [0.25, 0.1])
def test_topk_compressor_matches_jax_with_ties(rate):
    jc, tc = JTopKCompressor(rate), TopKCompressor(rate)
    for rnd in range(3):
        u = _tied_update(rnd)
        js, ts = jc.compress(_jt(u)), tc.compress(_tt(u))
        jl = jax.tree_util.tree_leaves(
            js, is_leaf=lambda t: isinstance(t, dict) and "idx" in t)
        tl = tu.leaves(ts, is_leaf=lambda t: isinstance(t, dict)
                       and "idx" in t)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            assert t["idx"].dtype == torch.int32
            assert np.array_equal(np.asarray(j["idx"]), to_numpy(t["idx"]))
            assert np.asarray(j["vals"]).tobytes() == \
                to_numpy(t["vals"]).tobytes()
            assert tuple(j["shape"]) == t["shape"]
        for j, t in zip(jax.tree_util.tree_leaves(jc.residual),
                        tu.leaves(tc.residual)):
            assert np.asarray(j).tobytes() == to_numpy(t).tobytes()
        dense = TopKCompressor.decompress(ts)
        for j, t in zip(jax.tree_util.tree_leaves(
                JTopKCompressor.decompress(js)), tu.leaves(dense)):
            assert np.asarray(j).tobytes() == to_numpy(t).tobytes()
        assert sparse_nbytes(ts) == jsparse_nbytes(js)
        assert dense_nbytes(_tt(u)) == jdense_nbytes(_jt(u))


def test_topk_keeps_the_lower_index_on_ties():
    comp = TopKCompressor(rate=0.25)               # keep 2 of 8
    x = torch.tensor([1.0, -3.0, 3.0, 0.5, -3.0, 2.0, 3.0, 0.0])
    s = comp.compress({"g": x})
    assert s["g"]["idx"].tolist() == [1, 2]
    assert s["g"]["vals"].tolist() == [-3.0, 3.0]


def test_topk_frames_are_byte_identical_and_cross_decode():
    jc, tc = JTopKCompressor(0.2), TopKCompressor(0.2)
    u = _tied_update(5)
    js, ts = jc.compress(_jt(u)), tc.compress(_tt(u))
    jf, tf = jtopk_frame(js), topk_frame(ts)
    assert bytes(tf) == bytes(jf)
    back = topk_unframe(jf)              # the JAX package's frame, no jax
    for j, t in zip(jax.tree_util.tree_leaves(
            jtopk_unframe(tf), is_leaf=lambda t: isinstance(t, dict)
            and "idx" in t),
            tu.leaves(back, is_leaf=lambda t: isinstance(t, dict)
                      and "idx" in t)):
        assert np.array_equal(j["idx"], t["idx"])
        assert np.asarray(j["vals"]).tobytes() == t["vals"].tobytes()
        assert tuple(j["shape"]) == t["shape"]
    dense = TopKCompressor.decompress(back)
    assert set(dense) == {"g", "h", "s"} and dense["s"].shape == ()


# ---------------------------------------------------------------------------
# Delta-sync pods (tests/test_sync.py, tests/test_elastic_training.py)
# ---------------------------------------------------------------------------

class _Jax:
    Sim, Net, Pod, Comp = JSimulator, JNetConfig, JDeltaSyncPod, \
        JTopKCompressor
    converged = staticmethod(jconverged)
    run = staticmethod(jrun_to_convergence)

    @staticmethod
    def zeros(shape):
        return jnp.zeros(shape, jnp.float32)

    @staticmethod
    def toward(params, target):
        return jax.tree_util.tree_map(lambda p, t: p + 0.5 * (t - p),
                                      params, target)

    @staticmethod
    def full(shape, v):
        return jnp.full(shape, v, jnp.float32)

    leaves = staticmethod(jax.tree_util.tree_leaves)


class _Torch:
    Sim, Net, Pod, Comp = Simulator, NetConfig, DeltaSyncPod, TopKCompressor
    converged = staticmethod(converged)
    run = staticmethod(run_to_convergence)

    @staticmethod
    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32)

    @staticmethod
    def toward(params, target):
        return tu.tree_map(lambda p, t: p + 0.5 * (t - p), params, target)

    @staticmethod
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32)

    leaves = staticmethod(tu.leaves)


def _mk_pods(P, sim, n_pods, seed=None, compressor_rate=None, ghost=False):
    """``tests/test_sync.py``'s pods (``seed`` given: params w and b, rng
    from the seed and the pod id) or ``tests/test_elastic_training.py``'s
    (w only, rng 7 + k)."""
    ids = [f"pod{k}" for k in range(n_pods)]
    with_bias = seed is not None

    def init():
        t = {"w": P.zeros((4,))}
        if with_bias:
            t["b"] = P.zeros(())
        return t

    def local_update(params, round_idx, pod_id):
        k = int(pod_id[3:])
        target = {"w": P.full((4,), float(k + 1))}
        if with_bias:
            target["b"] = P.full((), float(k))
        return P.toward(params, target)

    pods = []
    for n, i in enumerate(ids):
        comp = P.Comp(compressor_rate) if compressor_rate else None
        rng = (random.Random(seed + hash(i) % 100) if with_bias
               else random.Random(7 + n))
        pods.append(sim.add_node(P.Pod(
            i, [j for j in ids if j != i], init(), local_update,
            num_pods=n_pods, compressor=comp, rng=rng, ghost_check=ghost)))
    return pods


def _outcome(P, sim, pods):
    return {"stats": (sim.stats.sent, sim.stats.delivered,
                      sim.stats.dropped, sim.stats.duplicated,
                      dict(sim.stats.by_kind),
                      dict(sim.stats.bytes_by_kind)),
            "dots": [sorted(d for d, _ in p.X.dots) for p in pods],
            "rounds": [p.round_idx for p in pods],
            "params": [[np.asarray(to_numpy(x), np.float32)
                        for x in P.leaves(p.params())] for p in pods]}


def _lossy_run(P):
    sim = P.Sim(P.Net(loss=0.3, dup=0.1, seed=42))
    pods = _mk_pods(P, sim, 3, seed=42, ghost=True)
    for _ in range(4):
        for p in pods:
            p.do_round()
        sim.run_for(3.0)
    P.run(sim, pods, interval=1.0, max_time=20_000)
    assert P.converged(pods)
    assert all(not n.ghost_failures for n in pods)
    return _outcome(P, sim, pods)


def _topk_run(P):
    sim = P.Sim(P.Net(loss=0.2, dup=0.1, seed=7))
    pods = _mk_pods(P, sim, 3, seed=7, compressor_rate=0.5)
    for _ in range(3):
        for p in pods:
            p.do_round()
        sim.run_for(3.0)
    P.run(sim, pods, interval=1.0, max_time=20_000)
    return _outcome(P, sim, pods)


def _crash_run(P):
    sim = P.Sim(P.Net(loss=0.25, dup=0.1, seed=3))
    pods = _mk_pods(P, sim, 3)
    for p in pods:
        p.do_round()
    sim.run_for(3.0)
    sim.crash("pod2", downtime=20.0)
    for _ in range(1, 3):
        for p in pods:
            if p.alive:
                p.do_round()
        sim.run_for(3.0)
    assert [p.round_idx for p in pods] == [3, 3, 1]
    sim.run_until(sim.time + 25.0)
    assert pods[2].alive and pods[2].D == {}
    for p in pods:
        p.do_round()
    P.run(sim, pods, interval=1.0, max_time=30_000)
    assert P.converged(pods)
    assert {d[0] for d, _ in pods[0].X.dots} == {"pod0", "pod1", "pod2"}
    return _outcome(P, sim, pods)


def _scale_up_run(P):
    sim = P.Sim(P.Net(loss=0.2, seed=11))
    pods = _mk_pods(P, sim, 2)
    for _ in range(2):
        for p in pods:
            p.do_round()
        sim.run_for(3.0)
    newcomer = P.Pod("pod2", ["pod0", "pod1"], {"w": P.zeros((4,))},
                     pods[0].local_update_fn, num_pods=2,
                     rng=random.Random(42))
    sim.add_node(newcomer)
    for p in pods:
        p.neighbors.append("pod2")
    P.run(sim, pods + [newcomer], interval=1.0, max_time=30_000)
    assert newcomer.X == pods[0].X
    return _outcome(P, sim, pods + [newcomer])


RUNS = {"lossy": _lossy_run, "topk": _topk_run, "crash": _crash_run,
        "scale-up": _scale_up_run}


@pytest.mark.parametrize("name", list(RUNS))
def test_delta_sync_pod_runs_match_jax(name):
    want = RUNS[name](_Jax)
    got = RUNS[name](_Torch)
    assert got["stats"] == want["stats"]
    assert got["dots"] == want["dots"]
    assert got["rounds"] == want["rounds"]
    for g_pod, w_pod in zip(got["params"], want["params"]):
        for g, w in zip(g_pod, w_pod):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
    for pod in got["params"][1:]:      # every pod holds the same params
        for a, b in zip(got["params"][0], pod):
            np.testing.assert_array_equal(a, b)
