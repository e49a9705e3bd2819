"""The port's attention against the JAX package on the same numpy inputs,
all in f32 at rtol = atol = 2e-5 (the bar of the JAX package's own flash
tests): the plain kernel versions (``ref.attention_ref`` / ``decode_ref``)
against the JAX oracles and against the Pallas kernels in interpret mode;
the model's ``_mha_core`` / ``_mha_chunked`` against the JAX ones across
windows, blocks, softcap and query scale; and ``attend_full`` (with its
cache) followed by four ``attend_decode`` steps, caches compared too. The
CUDA kernels are held against these plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models.config import LayerSpec, ModelConfig

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _qkv(b, h, kv, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32))


def _cache(b, kv, C, hd, filled, seed=0, empty_rows=()):
    """A ring cache with ``filled`` tokens written (slot = t % C); rows in
    ``empty_rows`` hold no valid slot."""
    rng = np.random.default_rng(seed)
    k = np.zeros((b, kv, C, hd), np.float32)
    v = np.zeros((b, kv, C, hd), np.float32)
    pos = np.full((b, C), -1, np.int32)
    for t in range(filled):
        slot = t % C
        k[:, :, slot] = rng.normal(size=(b, kv, hd))
        v[:, :, slot] = rng.normal(size=(b, kv, hd))
        pos[:, slot] = t
    for r in empty_rows:
        pos[r] = -1
    return k, v, pos


# ---------------------------------------------------------------------------
# Plain kernel versions vs the JAX oracles and Pallas kernels
# ---------------------------------------------------------------------------

FWD_SHAPES = [
    (1, 4, 4, 256, 64, 128),     # MHA
    (2, 8, 2, 256, 64, 128),     # GQA 4:1
    (1, 4, 1, 512, 128, 128),    # MQA
    (1, 2, 2, 128, 32, 64),      # small blocks
]
FWD_OPTIONS = [{}, {"window": 48}, {"softcap": 30.0}, {"scale": 0.0825}]


@pytest.mark.parametrize("opts", FWD_OPTIONS, ids=lambda o: str(o) or "plain")
@pytest.mark.parametrize("b,h,kv,s,hd,block", FWD_SHAPES)
def test_attention_ref_matches_jax_oracle_and_pallas(b, h, kv, s, hd, block,
                                                     opts):
    q, k, v = _qkv(b, h, kv, s, s, hd, seed=s + h)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **opts)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, jref.attention_ref(jq, jk, jv, **opts))
    _close(got, jops.flash_attention(jq, jk, jv, block_q=block,
                                     block_k=block, interpret=True, **opts))


@pytest.mark.parametrize("sq,sk", [(100, 100), (1000 // 8, 1000 // 8),
                                   (37, 64)])
def test_attention_ref_ragged_lengths(sq, sk):
    """Lengths that no block divides (the CUDA kernels mask the tails;
    their plain version needs no blocks at all)."""
    q, k, v = _qkv(2, 6, 2, sq, sk, 16, seed=sq)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), window=40, softcap=20.0)
    _close(got, jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=40, softcap=20.0))


DECODE_CASES = [
    # b, h, kv, C, hd, filled, window, block_k, empty rows
    (2, 4, 4, 256, 64, 256, None, 128, ()),   # full cache
    (2, 8, 2, 256, 64, 100, None, 128, ()),   # empty slots (pos = -1)
    (1, 4, 1, 512, 128, 300, None, 128, ()),
    (1, 4, 2, 128, 64, 300, 128, 64, ()),     # wrapped ring with a window
    (2, 4, 2, 128, 64, 77, 16, 64, (1,)),     # one row with no valid slot
]


@pytest.mark.parametrize("b,h,kv,C,hd,filled,window,bk,empty", DECODE_CASES)
@pytest.mark.parametrize("opts", [{}, {"softcap": 30.0, "scale": 0.0825}],
                         ids=["plain", "softcap+scale"])
def test_decode_ref_matches_jax_oracle_and_pallas(b, h, kv, C, hd, filled,
                                                  window, bk, empty, opts):
    k, v, kpos = _cache(b, kv, C, hd, filled, seed=C + filled,
                        empty_rows=empty)
    q = np.random.default_rng(1).normal(size=(b, h, 1, hd)).astype(
        np.float32)
    qpos = np.full((b, 1), filled, np.int32)
    got = ref.decode_ref(*map(torch.from_numpy, (q, k, v, qpos, kpos)),
                         window=window, **opts)
    jargs = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    _close(got, jref.decode_ref(*jargs, window=window, **opts))
    _close(got, jops.flash_decode(*jargs, window=window, block_k=bk,
                                  interpret=True, **opts))
    for r in empty:
        assert not got[r].any()          # no valid slot: exactly zero


def test_decode_empty_cache_rows_are_zero():
    k, v, kpos = _cache(1, 2, 128, 64, 0)
    q = np.ones((1, 2, 1, 64), np.float32)
    got = ref.decode_ref(*map(torch.from_numpy, (q, k, v)),
                         torch.zeros((1, 1), dtype=torch.int32),
                         torch.from_numpy(kpos))
    assert not got.any()


def test_ops_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers return the plain versions' results,
    are counted by ``ops.counters`` and launch no kernel."""
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=5)
    kc, vc, kpos = _cache(1, 2, 64, 32, 40, seed=6)
    t = torch.from_numpy
    snap, before = ops.counters.snapshot(), dict(fa.launches)
    got = ops.flash_attention(t(q), t(k), t(v), window=16, softcap=5.0)
    dec = ops.flash_decode(t(q[:, :, :1]), t(kc), t(vc),
                           torch.full((1, 1), 40, dtype=torch.int32),
                           t(kpos), window=16)
    assert ops.counters.since(snap)["launches"] == 2
    assert fa.launches == before
    assert torch.equal(got, ref.attention_ref(t(q), t(k), t(v), window=16,
                                              softcap=5.0))
    assert torch.equal(dec, ref.decode_ref(
        t(q[:, :, :1]), t(kc), t(vc), torch.full((1, 1), 40,
                                                 dtype=torch.int32),
        t(kpos), window=16))


@pytest.mark.parametrize("bad, err", [
    (dict(window=0), ValueError), (dict(softcap=0.0), ValueError),
])
def test_wrappers_refuse_bad_options(bad, err):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 16))
    with pytest.raises(err):
        fa.flash_attention(q, k, v, **bad)


def test_wrappers_refuse_bad_shapes_and_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 6, 4, 8, 8, 16))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.half(), v)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_decode(q[:, :, :1], k, v, torch.zeros((1, 1)),
                        torch.zeros((1, 8), dtype=torch.int32))


# ---------------------------------------------------------------------------
# The model's attention cores vs the JAX package's
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    """The same small config in both packages (``_cfg`` of the JAX
    package's test_chunked_attention.py)."""
    base = dict(name="t", family="dense", n_layers=1, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _heads(b, s, t, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, H, hd)).astype(np.float32),
            rng.normal(size=(b, t, KV, hd)).astype(np.float32),
            rng.normal(size=(b, t, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 48, 128])
@pytest.mark.parametrize("block", [32, 64, 256])
def test_mha_core_and_chunked_match_jax(window, block):
    jcfg, cfg = _cfgs(attn_block=block)
    b, s = 2, 256
    q, k, v = _heads(b, s, s, 4, 2, 16, seed=0)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, pos, pos)]
    want_core = jattn._mha_core(jcfg, *j, window)
    want_chunked = jattn._mha_chunked(jcfg, *j, window, block)
    _close(attn._mha_core(cfg, *t, window), want_core)
    _close(attn._mha_chunked(cfg, *t, window, block), want_chunked)
    _close(attn._mha_chunked(cfg, *t, window, block), want_core)


@pytest.mark.parametrize("s,block", [(128, 64), (100, 64)],
                         ids=["tiled", "indivisible-falls-back"])
def test_mha_chunked_softcap_query_scale_match_jax(s, block):
    jcfg, cfg = _cfgs(attn_softcap=30.0, query_scale=0.125,
                      attn_block=block)
    q, k, v = _heads(1, s, s, 4, 2, 16, seed=s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (1, s))
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, pos, pos)]
    _close(attn._mha_chunked(cfg, *t, None, block),
           jattn._mha_chunked(jcfg, *j, None, block))
    _close(attn._mha_core(cfg, *t, None), jattn._mha_core(jcfg, *j, None))


# ---------------------------------------------------------------------------
# attend_full (with its cache), then attend_decode steps
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_cache(got, want):
    for name in ("k", "v"):
        _close(got[name], want[name])
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    assert int(got["idx"]) == int(want["idx"])


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("window,capacity", [(None, 20), (6, 6)],
                         ids=["full-cache", "sliding-ring"])
def test_attend_full_then_decode_match_jax(impl, window, capacity):
    """Prefill 16 tokens (with QKV bias, softcap and an 8-wide block),
    emitting a cache, then four decode steps; for the sliding layer the
    ring (6 slots) is smaller than the prompt, so prefill wraps it."""
    kw = dict(attn_impl=impl, attn_block=8, qkv_bias=True,
              attn_softcap=30.0)
    jcfg, cfg = _cfgs(**kw)
    jspec, spec = JLayerSpec(window=window), LayerSpec(window=window)
    jp, _ = jattn.init_attention(jcfg, jax.random.PRNGKey(3), jnp.float32)
    jp = {**jp, **{n: jax.random.normal(jax.random.PRNGKey(i), a.shape)
                   for i, (n, a) in enumerate(jp.items()) if n[0] == "b"}}
    p = params_from_numpy(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(7)
    b, s = 2, 16
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jy, jc = jattn.attend_full(jp, jcfg, jspec, jnp.asarray(x),
                               jnp.asarray(pos), make_cache=capacity)
    y, c = attn.attend_full(p, cfg, spec, torch.from_numpy(x),
                            torch.from_numpy(np.ascontiguousarray(pos)),
                            make_cache=capacity)
    _close(y, jy)
    _check_cache(c, jc)
    # the port's cache carried over from the JAX one gives the same steps
    c2 = caches_from_numpy(_np_tree(jc), device="cpu")
    for step in range(4):
        xs = rng.normal(size=(b, 1, 64)).astype(np.float32)
        ps = np.full((b, 1), s + step, np.int32)
        jy, jc = jattn.attend_decode(jp, jcfg, jspec, jnp.asarray(xs),
                                     jnp.asarray(ps), jc)
        for cache in (c, c2):
            y, cache = attn.attend_decode(p, cfg, spec, torch.from_numpy(xs),
                                          torch.from_numpy(ps), cache)
            _close(y, jy)
            _check_cache(cache, jc)


def test_cache_append_writes_in_place():
    c = attn.init_kv_cache(1, 4, 1, 2, torch.float32, "cpu")
    k = torch.arange(12, dtype=torch.float32).reshape(1, 6, 1, 2)
    pos = torch.arange(6, dtype=torch.int32)[None]
    out = attn.cache_append(c, k, -k, pos)
    assert out is c and int(c["idx"]) == 6
    # six tokens through four slots: the last four land, token t in t % 4
    assert c["pos"].tolist() == [[4, 5, 2, 3]]
    assert torch.equal(c["k"][0, 0, 0], k[0, 4, 0])


def test_config_copies_agree():
    """The port's ModelConfig is field for field the JAX package's."""
    jfields = [(f.name, f.default) for f in dataclasses.fields(JModelConfig)]
    fields = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert fields == jfields
    assert ModelConfig(name="x", family="dense", n_layers=4, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=8, vocab=9
                       ).param_counts() == JModelConfig(
        name="x", family="dense", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=8, vocab=9).param_counts()
