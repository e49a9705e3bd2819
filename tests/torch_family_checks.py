"""Model-level checks of one architecture of the port against the JAX
package, at REDUCED size in f32, shared by ``test_torch_families.py``
(the dense and SSM configs), ``test_torch_moe.py`` (mixtral) and
``test_torch_mla.py`` (deepseek). Each runs on the JAX ``init_model``
parameters carried over with ``convert.params_from_numpy`` and the JAX
package's ``smoke_batch`` inputs:

* :func:`check_forward_and_gradients` — ``forward`` logits and the MoE
  aux loss, ``train_loss`` and every gradient leaf (naive attention; the
  port under remat, the JAX reference without: remat changes no value),
  to rtol 1e-5 / atol 1e-5 (f32 reductions in another order);
* :func:`check_chunked_forward` — the chunked attention path's logits and
  aux to the same tolerance;
* :func:`check_prefill_then_decode` — a prefill of the first half of a
  24-position sequence (for an SSM config, that half rounded down to its
  SSD chunk, whose prefill takes chunk-aligned lengths, as the JAX
  package's own smoke test splits), then one decode step at every later
  position on the sequence's own inputs, logits to rtol = atol = 1e-4 at
  each step and every cache leaf at the end (float leaves to the same
  tolerance, positions and write counters exactly);
* :func:`check_layout` — the port's own ``init_model`` lays parameters
  and empty caches out leaf for leaf as the JAX package does.

Each JAX reference is jitted once (its compile is most of its cost)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_batch
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_model as jinit_model
from repro.models import prefill as jprefill
from repro.models import train_loss as jtrain_loss
from repro_torch import tree as tu
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import (decode_step, forward, init_caches,
                                init_model, prefill, train_loss)

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
B, SEQ = 2, 24


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cfgs(arch, impl="naive"):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               attn_impl=impl, attn_block=8)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              attn_impl=impl, attn_block=8)
    return jcfg, cfg


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, what, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _seq(cfg):
    return cfg.prefix_len + 8 if cfg.input_mode == "tokens+prefix" else SEQ


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    """The JAX package's parameters (they do not depend on the attention
    path), made once per architecture and seed."""
    return jinit_model(jget_config(arch, reduced=True),
                       jax.random.PRNGKey(seed))[0]


def _setup(arch, impl, seed):
    jcfg, cfg = cfgs(arch, impl)
    jparams = _jax_params(arch, seed)
    params = params_from_numpy(np_tree(jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _check_aux(cfg, aux, jaux):
    close(aux, jaux, "aux")
    if cfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0


def check_forward_and_gradients(arch):
    jcfg, cfg, jparams, params = _setup(arch, "naive", 3)
    batch = smoke_batch(jcfg, b=B, s=_seq(jcfg), seed=4)

    def loss_and_fwd(p, b):
        return (jtrain_loss(jcfg, p, b, remat=False),
                jforward(jcfg, p, b, remat=False))

    (jloss, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        loss_and_fwd, has_aux=True))(jparams, batch)
    tb = torch_batch(np_tree(batch))
    logits, aux = forward(cfg, params, tb)
    close(logits, jlogits, "logits")
    _check_aux(cfg, aux, jaux)
    flat, treedef = tu.flatten(params)
    leaves = [p.requires_grad_(True) for p in flat]
    loss = train_loss(cfg, treedef.unflatten(leaves), tb)
    close(loss, jloss, "loss")
    # musicgen's token table is unused (embeds in, an untied head out)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for (path, p), g, w in zip(tu.flatten_with_path(params)[0], grads,
                               want):
        g = torch.zeros_like(p) if g is None else g
        assert tuple(g.shape) == w.shape, path
        close(g, w, f"gradient {path}")


def check_chunked_forward(arch):
    jcfg, cfg, jparams, params = _setup(arch, "chunked", 3)
    batch = smoke_batch(jcfg, b=B, s=_seq(jcfg), seed=4)
    jlogits, jaux = jax.jit(lambda p, b: jforward(jcfg, p, b, remat=False))(
        jparams, batch)
    with torch.no_grad():
        logits, aux = forward(cfg, params, torch_batch(np_tree(batch)))
    close(logits, jlogits, "logits")
    _check_aux(cfg, aux, jaux)


def prefill_split(cfg):
    split = SEQ // 2
    if cfg.ssm is not None:
        split = (split // cfg.ssm.chunk) * cfg.ssm.chunk or cfg.ssm.chunk
    return split


def _prompt(batch, split):
    key = "embeds" if "embeds" in batch else "tokens"
    return {key: batch[key][:, :split]}


def _step_input(batch, i):
    key = "embeds" if "embeds" in batch else "tokens"
    return np.array(batch[key][:, i:i + 1])


def check_prefill_then_decode(arch, impl):
    jcfg, cfg, jparams, params = _setup(arch, impl, 3)
    batch = np_tree(smoke_batch(jcfg, b=B, s=SEQ, seed=6, train=False))
    split = prefill_split(cfg)
    jlogits, jcaches = jax.jit(lambda p, x: jprefill(
        jcfg, p, x, max_len=SEQ))(jparams, _prompt(batch, split))
    with torch.no_grad():
        logits, caches = prefill(cfg, params,
                                 torch_batch(_prompt(batch, split)),
                                 max_len=SEQ)
    close(logits, jlogits, "prefill logits", STEP_TOL)
    jstep = jax.jit(lambda p, t, pos, c: jdecode_step(jcfg, p, t, pos, c))
    for i in range(split, SEQ):
        x = _step_input(batch, i)
        jlogits, jcaches = jstep(jparams, x, jnp.full((B, 1), i, jnp.int32),
                                 jcaches)
        with torch.no_grad():
            logits, caches = decode_step(
                cfg, params, torch.from_numpy(x),
                torch.full((B, 1), i, dtype=torch.int32), caches)
        close(logits, jlogits, f"decode logits at {i}", STEP_TOL)
    got = tu.flatten_with_path(tree_to_numpy(caches))[0]
    want = jax.tree_util.tree_leaves(np_tree(jcaches))
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert g.shape == w.shape, path
        if g.dtype.kind == "f":
            close(g, w, f"cache {path}", STEP_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def check_layout(arch):
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                                   dtype=dtype)
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype=dtype)
        want = jax.eval_shape(lambda: jinit_model(
            jcfg, jax.random.PRNGKey(0))[0])
        params = init_model(cfg, 0, device="cpu")
        wl, wdef = jax.tree_util.tree_flatten(want)
        gl, gdef = jax.tree_util.tree_flatten(tree_to_numpy(params))
        assert gdef == wdef
        for g, w in zip(gl, wl):
            assert g.shape == w.shape
            assert g.dtype.itemsize == np.dtype(w.dtype).itemsize
        jc = np_tree(jinit_caches(jcfg, None, 3, 40))
        c = tree_to_numpy(init_caches(cfg, params, 3, 40))
        assert jax.tree_util.tree_structure(c) == \
            jax.tree_util.tree_structure(jc)
        for g, w in zip(jax.tree_util.tree_leaves(c),
                        jax.tree_util.tree_leaves(jc)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.view(f"u{g.dtype.itemsize}"),
                                          w.view(f"u{w.dtype.itemsize}"))
