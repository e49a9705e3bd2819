"""The port's delta-interval checkpoint store against the JAX package's.

The six behaviours of ``tests/test_checkpoint.py`` (snapshot round trip,
snapshot ⊔ delta log, contiguous log, crash leaves a consistent prefix,
idempotent restore, GC keeps restorability) run against both packages.
Then a model + optimizer state (f32 or bf16 params, f32 moments and
master, the int32 step) checkpointed by either package restores in the
other with the same names, dtypes and arrays; the files' members are byte
for byte the same; leaf names are ``jax.tree_util.keystr`` paths;
versions are int64 on disk, narrowed to int32 with a range check.
Everything is exact (bits and bytes)."""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import DeltaCheckpointStore as JStore
from repro.checkpoint import pytree_from_state as jpytree_from_state
from repro.checkpoint import state_from_pytree as jstate_from_pytree
from repro.configs import get_config as jget_config
from repro.models import init_model as jinit_model
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro_torch import tree as tu
from repro_torch.checkpoint import (DeltaCheckpointStore, pytree_from_state,
                                    pytree_spec, state_from_pytree)
from repro_torch.convert import params_from_numpy
from repro_torch.dtypes import to_numpy
from repro_torch.kernels import delta_join as dj


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer0": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                   "b": rng.normal(size=(8,)).astype(np.float32)},
        "emb": rng.normal(size=(16, 4)).astype(np.float32),
    }


class _Jax:
    Store = JStore
    state_from_pytree = staticmethod(jstate_from_pytree)
    pytree_from_state = staticmethod(jpytree_from_state)

    @staticmethod
    def tree(t):
        return t

    @staticmethod
    def restore(store):
        return store.restore()

    @staticmethod
    def host(x):
        return np.asarray(x)


class _Torch:
    Store = DeltaCheckpointStore
    state_from_pytree = staticmethod(state_from_pytree)
    pytree_from_state = staticmethod(pytree_from_state)

    @staticmethod
    def tree(t):
        return tu.tree_map(torch.from_numpy, t)

    @staticmethod
    def restore(store):
        return store.restore(device="cpu")

    @staticmethod
    def host(x):
        return to_numpy(x)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Jax if request.param == "jax" else _Torch


def test_snapshot_restore_roundtrip(tmp_path, pkg):
    store = pkg.Store(str(tmp_path))
    state, spec = pkg.state_from_pytree(pkg.tree(_params()), chunk_size=16,
                                        rank=0)
    store.save_snapshot(state, seq=0)
    restored, seq = pkg.restore(store)
    assert seq == 0
    assert restored == state
    back = pkg.pytree_from_state(restored, spec)
    assert np.array_equal(pkg.host(back["layer0"]["w"]),
                          _params()["layer0"]["w"])
    assert np.array_equal(pkg.host(back["emb"]), _params()["emb"])


def test_delta_log_restore(tmp_path, pkg):
    store = pkg.Store(str(tmp_path))
    state, spec = pkg.state_from_pytree(pkg.tree(_params()), chunk_size=16,
                                        rank=0)
    store.save_snapshot(state, seq=0)
    for k in range(1, 4):
        new_emb = np.full((16, 4), float(k), np.float32)
        delta = state.write_delta(0, "['emb']", new_emb)
        state = state.join(delta)
        store.append_delta(delta, seq=k)
    restored, seq = pkg.restore(store)
    assert seq == 3
    assert restored == state
    back = pkg.pytree_from_state(restored, spec)
    assert np.array_equal(pkg.host(back["emb"]), np.full((16, 4), 3.0,
                                                         np.float32))


def test_delta_log_must_be_contiguous(tmp_path, pkg):
    store = pkg.Store(str(tmp_path))
    state, _ = pkg.state_from_pytree(pkg.tree(_params()), chunk_size=16,
                                     rank=0)
    store.save_snapshot(state, seq=0)
    delta = state.write_delta(0, "['emb']", np.ones((16, 4), np.float32))
    with pytest.raises(AssertionError):
        store.append_delta(delta, seq=5)  # gap


def test_crash_leaves_consistent_prefix(tmp_path, pkg):
    store = pkg.Store(str(tmp_path))
    state, _ = pkg.state_from_pytree(pkg.tree(_params()), chunk_size=16,
                                     rank=0)
    store.save_snapshot(state, seq=0)
    d1 = state.write_delta(0, "['emb']", np.ones((16, 4), np.float32))
    store.append_delta(d1, seq=1)
    with open(os.path.join(str(tmp_path), "junk.tmp"), "wb") as f:
        f.write(b"partial garbage")
    restored, seq = pkg.restore(store)
    assert seq == 1
    assert restored == state.join(d1)


def test_restore_is_idempotent(tmp_path, pkg):
    store = pkg.Store(str(tmp_path))
    state, _ = pkg.state_from_pytree(pkg.tree(_params()), chunk_size=16,
                                     rank=0)
    store.save_snapshot(state, seq=0)
    d1 = state.write_delta(0, "['emb']", np.ones((16, 4), np.float32))
    store.append_delta(d1, seq=1)
    r1, _ = pkg.restore(store)
    r2, _ = pkg.restore(store)
    assert r1 == r2
    live = state.join(d1)
    assert live.join(r1) == live


def test_gc_keeps_restorability(tmp_path, pkg):
    store = pkg.Store(str(tmp_path))
    state, _ = pkg.state_from_pytree(pkg.tree(_params()), chunk_size=16,
                                     rank=0)
    store.save_snapshot(state, seq=0)
    for k in range(1, 4):
        delta = state.write_delta(0, "['emb']",
                                  np.full((16, 4), float(k), np.float32))
        state = state.join(delta)
        store.append_delta(delta, seq=k)
    store.save_snapshot(state, seq=4)
    store.gc(keep_snapshots=1)
    files = os.listdir(str(tmp_path))
    assert not any(f.startswith("delta-") for f in files)
    assert sum(f.startswith("snapshot-") for f in files) == 1
    restored, _ = pkg.restore(store)
    assert restored == state


# ---------------------------------------------------------------------------
# Across the packages: a model + optimizer state
# ---------------------------------------------------------------------------

CHUNK = 64


def _train_state(seed, dtype):
    """A REDUCED qwen1.5 parameter tree in ``dtype`` and its optimizer
    state (f32 m, v, master; int32 step), as JAX and as port trees."""
    jcfg = jget_config("qwen1.5-0.5b", reduced=True)
    jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(seed))
    jparams = jax.tree_util.tree_map(lambda x: x.astype(dtype), jparams)
    jopt = jinit_opt_state(jparams)
    rng = np.random.default_rng(seed)
    jopt["m"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32),
        jopt["m"])
    jopt["step"] = jnp.asarray(seed + 3, jnp.int32)
    jtree = {"params": jparams, "opt": jopt}
    ttree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                              device="cpu")
    return jtree, ttree


def _write_both(tmp_path, dtype, n_ckpts):
    """The same checkpoints (a snapshot, then full-state deltas) by each
    package into its own directory."""
    trees = [_train_state(s, dtype) for s in range(1, n_ckpts + 1)]
    jstore = JStore(str(tmp_path / "jax"))
    tstore = DeltaCheckpointStore(str(tmp_path / "torch"))
    for seq, (jtree, ttree) in enumerate(trees):
        js, _ = jstate_from_pytree(jtree, CHUNK, rank=0, lamport=4 * seq + 4)
        ts, _ = state_from_pytree(ttree, CHUNK, rank=0, lamport=4 * seq + 4)
        for store, st in ((jstore, js), (tstore, ts)):
            if seq == 0:
                store.save_snapshot(st, seq=0)
            else:
                store.append_delta(st, seq=seq)
    return jstore, tstore, trees[-1]


# f32 params with two deltas (``launch.train``'s REDUCED state), and bf16 params
# in one snapshot: the JAX package's restore cannot join bf16 columns read
# back from disk (they load as 2-byte voids, which its jitted join
# refuses), so bf16 deltas are held port to port only
LAYOUTS = {"f32+2 deltas": (jnp.float32, 3), "bf16 snapshot": (jnp.bfloat16,
                                                               1)}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoint_files_hold_the_same_members_byte_for_byte(tmp_path,
                                                              layout):
    jstore, tstore, _ = _write_both(tmp_path, *LAYOUTS[layout])
    names = sorted(os.listdir(jstore.dir))
    assert names == sorted(os.listdir(tstore.dir))
    for name in names:
        if name.endswith(".npz"):
            j, t = (_members(os.path.join(d, name))
                    for d in (jstore.dir, tstore.dir))
            assert list(j) == list(t)
            for member in j:
                assert j[member] == t[member], member
        else:
            with open(os.path.join(jstore.dir, name)) as f, \
                    open(os.path.join(tstore.dir, name)) as g:
                assert f.read() == g.read()


def _restored_equal(tstate, jstate):
    tcols, jcols = tstate.as_dict(), jstate.as_dict()
    assert list(tcols) == list(jcols)
    for name in jcols:
        jv = np.asarray(jcols[name].values)
        tv = to_numpy(tcols[name].values)
        assert jv.dtype.itemsize == tv.dtype.itemsize
        assert jv.tobytes() == tv.tobytes(), name
        assert tcols[name].versions.dtype == torch.int32
        assert np.array_equal(np.asarray(jcols[name].versions),
                              to_numpy(tcols[name].versions))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_checkpoint_restores_in_the_other_package(tmp_path, writer,
                                                    layout):
    dtype, n_ckpts = LAYOUTS[layout]
    jstore, tstore, (jtree, ttree) = _write_both(tmp_path, dtype, n_ckpts)
    src = jstore.dir if writer == "jax" else tstore.dir
    before = dj.launches["delta_join"]
    tstate, tseq = DeltaCheckpointStore(src).restore(device="cpu")
    assert dj.launches["delta_join"] == before     # the CPU: plain joins
    jstate, jseq = JStore(src).restore()
    assert tseq == jseq == n_ckpts - 1
    assert tstate.lamport == jstate.lamport == 4 * n_ckpts
    _restored_equal(tstate, jstate)
    # the restored columns rebuild the latest trees leaf for leaf
    back = pytree_from_state(tstate, pytree_spec(ttree))
    for got, want in zip(tu.leaves(back), tu.leaves(ttree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == n_ckpts + 3


def test_bf16_deltas_restore_port_to_port(tmp_path):
    _, tstore, (_, ttree) = _write_both(tmp_path, jnp.bfloat16, 3)
    tstate, seq = tstore.restore(device="cpu")
    assert seq == 2
    back = pytree_from_state(tstate, pytree_spec(ttree))
    for got, want in zip(tu.leaves(back), tu.leaves(ttree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert back["params"]["embed"]["tok"].dtype == torch.bfloat16


def test_leaf_names_are_keystr_paths():
    jtree, ttree = _train_state(0, jnp.bfloat16)
    js, _ = jstate_from_pytree(jtree, CHUNK, rank=3, lamport=9)
    ts, spec = state_from_pytree(ttree, CHUNK, rank=3, lamport=9)
    assert [n for n, _ in ts.chunks] == [n for n, _ in js.chunks]
    assert "['opt']['m']['groups'][0][0]['mix']['wq']" in spec["leaves"]
    assert spec["leaves"]["['opt']['step']"] == ((), "int32")
    assert spec["leaves"]["['params']['embed']['tok']"][1] == "bfloat16"
    step = ts.as_dict()["['opt']['step']"]
    assert tuple(step.values.shape) == (1, CHUNK)     # 0-d leaf, one row
    assert int(step.versions[0]) == (9 << 10) | 3


def test_versions_are_int64_on_disk_and_range_checked(tmp_path):
    _, ttree = _train_state(0, jnp.bfloat16)
    store = DeltaCheckpointStore(str(tmp_path))
    ts, _ = state_from_pytree(ttree, CHUNK, rank=0, lamport=2)
    store.save_snapshot(ts, seq=0)
    path = os.path.join(store.dir, "snapshot-00000000.npz")
    with np.load(path) as z:
        arrs = dict(z)
    assert all(arrs[k].dtype == np.int64 for k in arrs if k.startswith("s::"))
    assert arrs["v::['params']['embed']['tok']"].dtype.kind == "V"
    key = "s::['opt']['step']"
    arrs[key] = np.full_like(arrs[key], 1 << 40)
    np.savez(path, **arrs)
    with pytest.raises(ValueError, match="int32"):
        store.restore(device="cpu")
