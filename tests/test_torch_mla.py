"""The port's MLA (``models/mla.py``) against the JAX package's, on the
same numpy inputs in f32 with deepseek-v2's REDUCED dims:

* ``mla_full`` in naive and chunked form (tiles that divide the
  sequence, and a length that does not, which falls back to the naive
  form), output and emitted latent cache to rtol = atol = 1e-5;
* the weight-absorbed ``mla_decode`` step by step against a 6-slot ring
  cache that wraps (each step's output and the whole cache, positions
  and write counter exactly), also to 1e-5;
* the deepseek-v2-236b architecture at REDUCED size (a dense MLA layer,
  then an MoE one: forward, aux, ``train_loss`` and gradients, the
  chunked path, prefill then decode at every position, layout:
  ``torch_family_checks``), and caches carried over from the JAX
  package decode as the port's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_batch
from repro.models import init_model as jinit_model
from repro.models import mla as jmla
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.models import decode_step, mla, prefill
from torch_family_checks import (STEP_TOL, check_chunked_forward,
                                 check_forward_and_gradients, check_layout,
                                 check_prefill_then_decode, cfgs, close,
                                 np_tree, torch_batch)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-236b"
# the JAX references, jitted (cfg, spec and the cache capacity static)
jmla_full = jax.jit(jmla.mla_full, static_argnums=(1, 2, 5))
jmla_decode = jax.jit(jmla.mla_decode, static_argnums=(1, 2))


def _setup(impl, block=8, seed=0):
    jcfg, cfg = (dataclasses.replace(c, attn_impl=impl, attn_block=block)
                 for c in (jget_config(ARCH, reduced=True),
                           get_config(ARCH, reduced=True)))
    jp, _ = jmla.init_mla(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(np_tree(jp), device="cpu")


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def _check_cache(got, want):
    for k in ("ckv", "krope"):
        close(got[k], want[k], k, TOL)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))


@pytest.mark.parametrize("impl,block,s", [("naive", 8, 16),
                                          ("chunked", 8, 16),
                                          ("chunked", 4, 12),
                                          ("chunked", 8, 12)],
                         ids=["naive", "chunked", "chunked-3x3",
                              "chunked-falls-back"])
def test_mla_full_matches_jax(impl, block, s):
    jcfg, cfg, jp, p = _setup(impl, block)
    x, pos = _x(cfg, 2, s, 1), _pos(2, s)
    want, jc = jmla_full(jp, jcfg, None, jnp.asarray(x), jnp.asarray(pos),
                         s + 4)
    got, c = mla.mla_full(p, cfg, None, torch.from_numpy(x),
                          torch.from_numpy(pos), make_cache=s + 4)
    close(got, want, "mla_full", TOL)
    _check_cache(c, jc)


def test_mla_chunked_equals_naive():
    _, cfg, _, p = _setup("naive", seed=2)
    x, pos = torch.from_numpy(_x(cfg, 2, 16, 3)), torch.from_numpy(
        _pos(2, 16))
    a, _ = mla.mla_full(p, cfg, None, x, pos)
    b, _ = mla.mla_full(p, dataclasses.replace(cfg, attn_impl="chunked",
                                               attn_block=4), None, x, pos)
    close(b, a.numpy(), "chunked vs naive", TOL)


def test_mla_decode_over_a_wrapping_ring_matches_jax():
    """A 4-token prefill into a 6-slot ring, then 7 decode steps: from
    the third step on each write evicts the oldest token."""
    jcfg, cfg, jp, p = _setup("naive", seed=4)
    b, s0, C = 2, 4, 6
    x, pos = _x(cfg, b, s0, 5), _pos(b, s0)
    _, jc = jmla_full(jp, jcfg, None, jnp.asarray(x), jnp.asarray(pos), C)
    _, c = mla.mla_full(p, cfg, None, torch.from_numpy(x),
                        torch.from_numpy(pos), make_cache=C)
    for i in range(s0, s0 + 7):
        xs, ps = _x(cfg, b, 1, 10 + i), _pos(b, 1, i)
        want, jc = jmla_decode(jp, jcfg, None, jnp.asarray(xs),
                               jnp.asarray(ps), jc)
        ckv = c["ckv"]
        got, c = mla.mla_decode(p, cfg, None, torch.from_numpy(xs),
                                torch.from_numpy(ps), c)
        assert c["ckv"] is ckv                        # written in place
        close(got, want, f"mla_decode at {i}", TOL)
        _check_cache(c, jc)
    assert int(c["idx"]) == s0 + 7 > C
    assert sorted(c["pos"][0].tolist()) == list(range(s0 + 7 - C, s0 + 7))


def test_init_mla_cache_matches_jax():
    jcfg, cfg, _, _ = _setup("naive")
    want = jmla.init_mla_cache(3, 9, jcfg.mla, jnp.float32)
    got = mla.init_mla_cache(3, 9, cfg.mla, torch.float32, "cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# deepseek-v2-236b at REDUCED size
# ---------------------------------------------------------------------------

def test_deepseek_forward_loss_and_gradients_match_jax():
    check_forward_and_gradients(ARCH)


def test_deepseek_chunked_forward_matches_jax():
    check_chunked_forward(ARCH)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_deepseek_prefill_then_decode_every_position_match_jax(impl):
    check_prefill_then_decode(ARCH, impl)


def test_deepseek_init_model_and_caches_lay_out_like_jax():
    check_layout(ARCH)


def test_decode_continues_from_carried_caches():
    """The JAX package's prefill caches, carried over with
    ``caches_from_numpy``, decode as the ones the port's prefill built."""
    jcfg, cfg = cfgs(ARCH)
    jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(7))
    params = params_from_numpy(np_tree(jparams), device="cpu")
    batch = np_tree(smoke_batch(jcfg, b=2, s=12, seed=8, train=False))
    prompt = {"tokens": batch["tokens"][:, :11]}
    _, jcaches = jprefill(jcfg, jparams, prompt, max_len=12)
    _, caches = prefill(cfg, params, torch_batch(prompt), max_len=12)
    carried = caches_from_numpy(np_tree(jcaches), device="cpu")
    x = torch.from_numpy(np.array(batch["tokens"][:, 11:12]))
    pos = torch.full((2, 1), 11, dtype=torch.int32)
    a, _ = decode_step(cfg, params, x, pos, carried)
    b, _ = decode_step(cfg, params, x, pos, caches)
    close(a, b.numpy(), "decode logits", STEP_TOL)
