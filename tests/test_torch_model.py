"""The port's model stack against the JAX package: the JAX ``init_model``
parameters carried over with ``convert.params_from_numpy``, the same
prompt through both ``prefill``s (last-position logits and every cache)
and then 8 greedy ``decode_step``s (logits, tokens, cache positions), in
f32 at rtol = atol = 1e-4, for both attention paths — REDUCED qwen1.5 and
qwen2, a one-layer config with a sliding window (whose ring is smaller
than the prompt), a softcap and a query scale, and the REDUCED gemma2,
stablelm, mixtral (MoE), deepseek-v2 (MLA + MoE), mamba2 (SSM) and
jamba (SSM + attention + MoE). Plus: the port's naive and chunked paths
agree, every id's config is the JAX package's, its own ``init_model``
lays parameters out leaf for leaf as the JAX package does, MoE's
``moe_impl="local"`` without a mesh is the global path (as in the JAX
package), and the layers the served configs do not
reach (layer norm, GeGLU/GELU, partial rotary, scaled embeddings, an
untied softcapped head, sinusoidal positions) match."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_caches as jinit_caches
from repro.models import init_model as jinit_model
from repro.models import layers as jlayers
from repro.models import prefill as jprefill
from repro.models import rope as jrope
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import (caches_max_len, decode_step, forward,
                                init_caches, init_model, layers, prefill,
                                rope)
from repro_torch.models.config import LayerSpec, ModelConfig

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, STEPS = 2, 16, 8


def _windowed(cls, spec_cls):
    return cls(name="t-swa", family="dense", n_layers=1, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
               layout=(spec_cls(window=12),), qkv_bias=True,
               attn_softcap=30.0, query_scale=0.125, dtype="float32")


def _reduced(arch):
    return lambda: (jget_config(arch, reduced=True),
                    get_config(arch, reduced=True))


CONFIGS = {
    "qwen1.5-reduced": _reduced("qwen1.5-0.5b"),
    "qwen2-reduced": _reduced("qwen2-1.5b"),
    "window+softcap": lambda: (_windowed(JModelConfig, JLayerSpec),
                               _windowed(ModelConfig, LayerSpec)),
    # the token-input ids of the later families
    "gemma2-reduced": _reduced("gemma2-27b"),
    "stablelm-reduced": _reduced("stablelm-1.6b"),
    "mixtral-reduced": _reduced("mixtral-8x22b"),
    "deepseek-v2-reduced": _reduced("deepseek-v2-236b"),
    "mamba2-reduced": _reduced("mamba2-130m"),
    "jamba-reduced": _reduced("jamba-v0.1-52b"),
}
MOE_IDS = ("mixtral-8x22b", "deepseek-v2-236b", "jamba-v0.1-52b")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed):
    """The JAX parameters of a case (they do not depend on the attention
    path), made once."""
    return jinit_model(CONFIGS[name]()[0], jax.random.PRNGKey(seed))[0]


def _setup(name, impl, seed=0):
    jcfg, cfg = CONFIGS[name]()
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, attn_block=8)
    cfg = dataclasses.replace(cfg, attn_impl=impl, attn_block=8)
    jparams = _jax_params(name, seed)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    return jcfg, cfg, jparams, params, tok


def _check_caches(got, want):
    """KV caches ({k, v, pos, idx}), MLA latent caches ({ckv, krope,
    pos, idx}) and SSM caches ({ssm, conv, idx}): values to TOL,
    positions and write counters exactly."""
    got, want = tree_to_numpy(got), _np_tree(want)
    for g_group, w_group in zip(got, want, strict=True):
        for g, w in zip(g_group, w_group, strict=True):
            assert sorted(g) == sorted(w)
            exact = {"pos", "idx"} & set(g)
            for name in sorted(set(g) - exact):
                np.testing.assert_allclose(g[name], w[name], **TOL)
            for name in sorted(exact):
                np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_greedy_decode_match_jax(name, impl):
    jcfg, cfg, jparams, params, tok = _setup(name, impl)
    max_len = PROMPT + STEPS + 1
    jlogits, jcaches = jax.jit(lambda p, x: jprefill(
        jcfg, p, x, max_len=max_len))(jparams, {"tokens": jnp.asarray(tok)})
    jstep = jax.jit(lambda p, t, pos, c: jdecode_step(jcfg, p, t, pos, c))
    logits, caches = prefill(cfg, params, {"tokens": torch.from_numpy(tok)},
                             max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _check_caches(caches, jcaches)
    assert caches_max_len(caches) == caches_max_len(_np_tree(jcaches))

    jt = jnp.argmax(jlogits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    t = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    for k in range(STEPS):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        jpos = jnp.full((B, 1), PROMPT + k, jnp.int32)
        pos = torch.full((B, 1), PROMPT + k, dtype=torch.int32)
        jlogits, jcaches = jstep(jparams, jt, jpos, jcaches)
        logits, caches = decode_step(cfg, params, t, pos, caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        jt = jnp.argmax(jlogits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        t = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    _check_caches(caches, jcaches)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_naive_and_chunked_agree(name):
    _, cfg, _, params, tok = _setup(name, "naive", seed=1)
    out = {}
    for impl in ("naive", "chunked"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        logits, caches = prefill(c, params, {"tokens": torch.from_numpy(tok)},
                                 max_len=PROMPT + 2)
        t = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        step, _ = decode_step(c, params, t,
                              torch.full((B, 1), PROMPT, dtype=torch.int32),
                              caches)
        out[impl] = (logits, step)
    for a, b in zip(out["naive"], out["chunked"]):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-1.5b"])
def test_init_model_and_caches_lay_out_like_jax(arch):
    """Same tree, shapes and dtypes as the JAX package, for the port's own
    random parameters (REDUCED, and the bf16 of the full configs' dtype)
    and for empty caches."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                                   dtype=dtype)
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype=dtype)
        want = jax.eval_shape(lambda: jinit_model(
            jcfg, jax.random.PRNGKey(0))[0])
        got = tree_to_numpy(init_model(cfg, 0, device="cpu"))
        wl, wdef = jax.tree_util.tree_flatten(want)
        gl, gdef = jax.tree_util.tree_flatten(got)
        assert gdef == wdef
        for g, w in zip(gl, wl):
            assert g.shape == w.shape
            assert g.dtype.itemsize == np.dtype(w.dtype).itemsize
        jc = _np_tree(jinit_caches(jcfg, None, 3, 40))
        c = tree_to_numpy(init_caches(cfg, init_model(cfg, 0, device="cpu"),
                                      3, 40))
        assert jax.tree_util.tree_structure(c) == \
            jax.tree_util.tree_structure(jc)
        for g, w in zip(jax.tree_util.tree_leaves(c),
                        jax.tree_util.tree_leaves(jc)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.view(f"u{g.dtype.itemsize}"),
                                          w.view(f"u{w.dtype.itemsize}"))


def test_init_model_is_seeded():
    cfg = get_config("qwen2-1.5b", reduced=True)
    a, b, c = (tree_to_numpy(init_model(cfg, s, device="cpu"))
               for s in (3, 3, 4))
    la, lb, lc = (jax.tree_util.tree_leaves(t) for t in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not np.array_equal(la[0], lc[0])


@pytest.mark.parametrize("arch", MOE_IDS)
def test_local_moe_without_a_mesh_is_the_global_path(arch):
    """``moe_impl="local"`` with no mesh installed runs the global
    dispatch, as the JAX package's ``apply_moe`` does: ``forward`` of
    each MoE id at REDUCED size equals the global path's bit for bit and
    the JAX package's local-without-mesh forward to 1e-5."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               moe_impl="local")
    cfg = get_config(arch, reduced=True)
    jparams = jinit_model(jcfg, jax.random.PRNGKey(0))[0]
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)) \
        .astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok)}
    local, aux_l = forward(dataclasses.replace(cfg, moe_impl="local"),
                           params, batch)
    glob, aux_g = forward(cfg, params, batch)
    assert torch.equal(local, glob) and torch.equal(aux_l, aux_g)
    from repro.models import forward as jforward
    want, jaux = jforward(jcfg, jparams, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(local.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_l), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_jax_packages(arch, reduced):
    got = dataclasses.asdict(get_config(arch, reduced=reduced))
    want = dataclasses.asdict(jget_config(arch, reduced=reduced))
    assert got == want


# ---------------------------------------------------------------------------
# Layers the served configs do not reach (other families use them)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(kind, dtype):
    """f32 statistics, output in the compute dtype (bf16 compared in f32
    after both round once more than f32 would)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jlayers.apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jx, kind), np.float32)
    tx = params_from_numpy(np.asarray(jx), device="cpu")
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            tx, kind).float().numpy()
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    """gelu is the tanh approximation, as ``jax.nn.gelu``'s default."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", reduced=True),
                               act=act)
    jp, _ = jlayers.init_mlp(jcfg, jax.random.PRNGKey(1), 48, 96,
                             jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 3, 48)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), act)
    got = layers.apply_mlp(params_from_numpy(_np_tree(jp), device="cpu"),
                           torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_rope_matches_jax(pct):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, pct)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                          pct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_head_and_positions_match_jax():
    """Scaled embeddings, an untied head with a final softcap, and
    sinusoidal positions."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", reduced=True),
                               scale_embed=True, tie_embeddings=False,
                               final_softcap=3.0)
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              scale_embed=True, tie_embeddings=False,
                              final_softcap=3.0)
    jp, _ = jlayers.init_embedding(jcfg, jax.random.PRNGKey(2), jnp.float32)
    p = params_from_numpy(_np_tree(jp), device="cpu")
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9))
    jx = jlayers.embed_tokens(jp, jcfg, jnp.asarray(tok))
    x = layers.embed_tokens(p, cfg, torch.from_numpy(tok))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(layers.lm_logits(p, cfg, x).numpy(),
                               np.asarray(jlayers.lm_logits(jp, jcfg, jx)),
                               **TOL)
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        layers.sinusoidal_positions(torch.from_numpy(pos), 48).numpy(),
        np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), 48)),
        **TOL)
