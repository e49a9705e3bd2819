"""The port's Mamba-2 SSD mixer (``models/ssm.py``) against the JAX
package's, on the same numpy inputs in f32 with the REDUCED SSM dims of
mamba2-130m and jamba-v0.1-52b, and with ``n_groups=2`` (both published
configs have one group, which would hide a tiled where a repeated head
mapping belongs):

* ``init_ssm``'s layout and dtypes (the decay parameters and the norm
  scale f32 in every compute dtype), and empty caches bit for bit;
* ``_causal_conv_full`` and ``_segsum`` (its ``-inf`` upper triangle
  exactly) to rtol = atol = 1e-5;
* ``ssm_full`` at a length below one chunk and at 1, 2 and 3 chunks,
  without and with the cache it emits, output and cache to 1e-5;
* ``ssm_decode`` for 6 steps after a prefill, each step's output and the
  final cache to rtol = atol = 1e-4 (the write counter exactly), with
  the cache's tensors written in place (the decoder stack hands each
  layer views of its group's stacked caches);
* a length that is not a multiple of the chunk raises.

The decay parameters, the conv bias and the norm scale are drawn away
from their initial zeros and ones, so that no term of the recurrence is
trivially 0 or 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import ssm
from torch_family_checks import STEP_TOL, TOL, close, np_tree

ARCHS = ["mamba2-130m", "jamba-v0.1-52b"]
B = 2
# the JAX references, jitted (cfg and make_cache static)
jssm_full = jax.jit(jssm.ssm_full, static_argnums=(1, 3))
jssm_decode = jax.jit(jssm.ssm_decode, static_argnums=(1,))


def _cfgs(arch, groups=1):
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                            reduced=True)
    return tuple(dataclasses.replace(
        c, ssm=dataclasses.replace(c.ssm, n_groups=groups))
        for c in (jcfg, cfg))


def _params(jcfg, seed=0):
    """The JAX ``init_ssm`` parameters with the decay terms, the conv
    bias and the norm scale drawn away from 0 and 1; as numpy, JAX and
    the port's tensors."""
    jp, _ = jssm.init_ssm(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    npp = np_tree(jp)
    rng = np.random.default_rng(seed + 100)
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        npp[name] = (npp[name] + 0.3 * rng.normal(size=npp[name].shape)
                     ).astype(np.float32)
    npp["norm"]["scale"] = (1.0 + 0.2 * rng.normal(
        size=npp["norm"]["scale"].shape)).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, npp),
            params_from_numpy(npp, device="cpu"))


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _close_cache(got, want, tol):
    got, want = tree_to_numpy(got), np_tree(want)
    assert sorted(got) == sorted(want) == ["conv", "idx", "ssm"]
    for name in ("ssm", "conv"):
        assert got[name].shape == want[name].shape, name
        close(got[name], want[name], f"cache {name}", tol)
    assert got["idx"].dtype == want["idx"].dtype == np.int32
    np.testing.assert_array_equal(got["idx"], want["idx"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_lays_out_like_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.eval_shape(lambda: jssm.init_ssm(
        jcfg, jax.random.PRNGKey(0), jdt)[0])
    got = ssm.init_ssm(cfg, torch.Generator().manual_seed(0), tdt)
    assert sorted(got) == sorted(want)
    f32 = {"A_log", "D", "dt_bias"}
    for name, w in want.items():
        g = got[name]["scale"] if name == "norm" else got[name]
        w = w["scale"] if name == "norm" else w
        assert tuple(g.shape) == w.shape, name
        want_dtype = torch.float32 if name in f32 | {"norm"} else tdt
        assert g.dtype == want_dtype, name
        assert np.dtype(w.dtype).itemsize == g.element_size(), name
    # the deterministic leaves are the JAX package's values
    jp, _ = jssm.init_ssm(jcfg, jax.random.PRNGKey(0), jdt)
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        close(got[name].float(), np.asarray(jp[name], np.float32), name, TOL)
    jc = np_tree(jssm.init_ssm_cache(jcfg, 3, jdt))
    c = tree_to_numpy(ssm.init_ssm_cache(cfg, 3, tdt, "cpu"))
    assert sorted(c) == sorted(jc)
    for name in jc:
        assert c[name].shape == jc[name].shape, name
        np.testing.assert_array_equal(
            c[name].view(f"u{c[name].dtype.itemsize}"),
            jc[name].view(f"u{jc[name].dtype.itemsize}"))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_causal_conv_matches_jax(arch, groups):
    jcfg, cfg = _cfgs(arch, groups)
    jp, p = _params(jcfg, seed=1)
    _, _, _, conv_dim = ssm._dims(cfg)
    xbc = np.random.default_rng(2).normal(
        size=(B, 11, conv_dim)).astype(np.float32)
    want = jssm._causal_conv_full(jp, jnp.asarray(xbc))
    got = ssm._causal_conv_full(p, torch.from_numpy(xbc))
    close(got, want, "conv", TOL)


@pytest.mark.parametrize("Q", [1, 5, 8])
def test_segsum_matches_jax_and_masks_with_minus_inf(Q):
    la = -np.abs(np.random.default_rng(Q).normal(
        size=(2, 3, Q))).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(la)))
    got = ssm._segsum(torch.from_numpy(la)).numpy()
    upper = np.triu(np.ones((Q, Q), bool), k=1)
    assert np.isneginf(got[..., upper]).all()
    assert np.isfinite(got[..., ~upper]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[..., ~upper], want[..., ~upper], **TOL)
    np.testing.assert_array_equal(np.diagonal(got, axis1=-2, axis2=-1), 0)


@pytest.mark.parametrize("make_cache", [False, True])
@pytest.mark.parametrize("slen", [4, 8, 16, 24],
                         ids=["below-a-chunk", "1-chunk", "2-chunks",
                              "3-chunks"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_full_matches_jax(arch, groups, slen, make_cache):
    jcfg, cfg = _cfgs(arch, groups)
    jp, p = _params(jcfg, seed=slen)
    x = _x(cfg, slen, seed=slen + 1)
    want, jcache = jssm_full(jp, jcfg, jnp.asarray(x), make_cache)
    got, cache = ssm.ssm_full(p, cfg, torch.from_numpy(x),
                              make_cache=make_cache)
    close(got, want, "ssm_full", TOL)
    if make_cache:
        _close_cache(cache, jcache, TOL)
        assert int(cache["idx"]) == slen
    else:
        assert cache is None and jcache is None


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_after_prefill_matches_jax_in_place(arch, groups):
    """Prefill 8 positions, then 6 decode steps; the port's cache lives
    in one stacked tensor per leaf (a group of 2 layers, the step's
    layer is row 1), and every step writes into that row in place."""
    jcfg, cfg = _cfgs(arch, groups)
    jp, p = _params(jcfg, seed=7)
    x = _x(cfg, 8 + 6, seed=8)
    _, jcache = jssm_full(jp, jcfg, jnp.asarray(x[:, :8]), True)
    _, made = ssm.ssm_full(p, cfg, torch.from_numpy(x[:, :8]),
                           make_cache=True)
    stacked = {k: torch.stack([torch.zeros_like(v), v])
               for k, v in made.items()}
    cache = {k: v[1] for k, v in stacked.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for i in range(8, 14):
        want, jcache = jssm_decode(jp, jcfg, jnp.asarray(x[:, i:i + 1]),
                                   jcache)
        got, out_cache = ssm.ssm_decode(p, cfg, torch.from_numpy(
            x[:, i:i + 1]), cache)
        assert out_cache is cache
        close(got, want, f"decode step {i}", STEP_TOL)
        assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close_cache({k: v[1] for k, v in stacked.items()}, jcache, STEP_TOL)
    assert int(stacked["idx"][1]) == 14
    for v in stacked.values():            # the other layer's row untouched
        assert not v[0].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_chunked_form(arch):
    """The recurrence and the chunked form are one function: prefill of
    one chunk plus decode steps gives ``ssm_full``'s outputs over the
    whole (chunk-aligned) sequence, in the port alone."""
    _, cfg = _cfgs(arch)
    _, p = _params(_cfgs(arch)[0], seed=3)
    x = torch.from_numpy(_x(cfg, 16, seed=4))
    full, _ = ssm.ssm_full(p, cfg, x)
    _, cache = ssm.ssm_full(p, cfg, x[:, :8], make_cache=True)
    for i in range(8, 16):
        y, cache = ssm.ssm_decode(p, cfg, x[:, i:i + 1], cache)
        torch.testing.assert_close(y[:, 0], full[:, i], **STEP_TOL)


@pytest.mark.parametrize("slen", [12, 20])
def test_misaligned_length_raises(slen):
    _, cfg = _cfgs("mamba2-130m")
    _, p = _params(_cfgs("mamba2-130m")[0])
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssm_full(p, cfg, torch.from_numpy(_x(cfg, slen, seed=0)))
