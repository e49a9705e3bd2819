"""The port's MoE (``models/moe.py``, the global path) against the JAX
package's, on the same numpy inputs in f32:

* routing: the expert ids bit for bit (also with forced router ties,
  which both break to the lower expert), the gates to rtol 1e-6 and the
  aux loss to rtol 1e-5;
* dispatch: the capacity and the ``[experts, capacity]`` table bit for
  bit, for capacities from "every pair fits" down to 1 slot per expert,
  and so the same dropped pairs;
* ``_combine_tokens`` and ``apply_moe`` (mixtral's SwiGLU experts;
  deepseek's routed and shared experts; a capacity that drops) to
  rtol 1e-5 / atol 1e-6;
* the mixtral-8x22b architecture at REDUCED size (forward, aux,
  ``train_loss`` and gradients, the chunked path, prefill then decode at
  every position, layout: ``torch_family_checks``);
* ``moe_impl="local"`` without a mesh is the global path, as in the JAX
  package (the per-shard path itself: ``test_torch_mesh.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from torch_family_checks import (check_chunked_forward,
                                 check_forward_and_gradients, check_layout,
                                 check_prefill_then_decode, np_tree)

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ["mixtral-8x22b", "deepseek-v2-236b"]


def _cfgs(arch):
    return jget_config(arch, reduced=True), get_config(arch, reduced=True)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.d_model)).astype(np.float32)


def _router(cfg, seed):
    return (np.random.default_rng(seed).normal(
        size=(cfg.d_model, cfg.moe.num_experts)) / 8).astype(np.float32)


def _route_both(jcfg, cfg, router, xf):
    jg, je, ja = jmoe._route(jnp.asarray(router), jcfg, jnp.asarray(xf))
    g, e, a = moe._route(torch.from_numpy(router), cfg, torch.from_numpy(xf))
    return (np.asarray(jg), np.asarray(je), float(ja)), (g.numpy(),
                                                         e.numpy(), float(a))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [1, 2, 37, 256])
def test_route_matches_jax(arch, n):
    jcfg, cfg = _cfgs(arch)
    (jg, je, ja), (g, e, a) = _route_both(jcfg, cfg, _router(cfg, n),
                                          _tokens(cfg, n, n + 1))
    np.testing.assert_array_equal(e, je)
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a, ja, rtol=1e-5)


def test_router_ties_break_to_the_lower_expert():
    """Duplicated router columns tie exactly, and zero tokens tie every
    expert: both packages pick the lower index first."""
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    router = _router(cfg, 0)
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    router[:, 1] = router[:, 6]
    xf = _tokens(cfg, 64, 1)
    xf[::4] = 0.0
    (jg, je, _), (g, e, _) = _route_both(jcfg, cfg, router, xf)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(e[0], [0, 1])     # all tie at x = 0
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-7)
    probs = torch.softmax(torch.from_numpy(xf @ router), -1).numpy()
    top = np.take_along_axis(probs, e, 1)
    assert (top[:, 0] == top[:, 1]).sum() > 16     # ties were exercised


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [2, 16, 100, 2000])
def test_capacity_matches_jax(arch, n):
    jcfg, cfg = _cfgs(arch)
    full = get_config(arch)
    for c, m in ((cfg, jcfg.moe), (full, jget_config(arch).moe)):
        want = max(1, int(math.ceil(n * m.top_k / m.num_experts
                                    * m.capacity_factor)))
        assert moe.moe_capacity(c, n) == want
    assert moe.moe_capacity(full, 2) == 1       # decode at b = 2


@pytest.mark.parametrize("capacity", [1, 2, 3, 8, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_table_is_bit_exact(capacity, seed):
    rng = np.random.default_rng(seed)
    E, N, K = 8, 20, 2
    ids = np.stack([rng.choice(E, K, replace=False) for _ in range(N)])
    ids = ids.astype(np.int32)
    jt, jm = jmoe._dispatch_table(jnp.asarray(ids), E, capacity)
    t, m = moe._dispatch_table(torch.from_numpy(ids).long(), E, capacity)
    assert m == jm == N * K
    assert t.dtype == torch.int32 and tuple(t.shape) == (E, capacity)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    kept = (t.numpy() < m).sum()
    per_expert = np.bincount(ids.reshape(-1), minlength=E)
    assert kept == np.minimum(per_expert, capacity).sum()


def test_combine_matches_jax():
    rng = np.random.default_rng(4)
    E, C, N, K, d = 4, 5, 9, 2, 12
    ids = np.stack([rng.choice(E, K, replace=False) for _ in range(N)])
    table, _ = jmoe._dispatch_table(jnp.asarray(ids, jnp.int32), E, C)
    y_e = rng.normal(size=(E, C, d)).astype(np.float32)
    gates = rng.uniform(size=(N, K)).astype(np.float32)
    want = jmoe._combine_tokens(jnp.asarray(y_e), jnp.asarray(gates),
                                table, N, K)
    got = moe._combine_tokens(torch.from_numpy(y_e), torch.from_numpy(gates),
                              torch.from_numpy(np.array(table)), N, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _moe_params(arch, seed):
    jcfg, cfg = _cfgs(arch)
    jp, _ = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(np_tree(jp), device="cpu")


@pytest.mark.parametrize("capacity", [None, 1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, capacity):
    """Routed experts (and deepseek's shared ones), at the config's
    capacity and at capacities that drop pairs; the drop count is the
    JAX table's."""
    jcfg, cfg, jp, p = _moe_params(arch, 1)
    x = np.random.default_rng(2).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32)
    want, jaux = jax.jit(jmoe.apply_moe, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(x), capacity)
    with moe.tap_routing() as tap:
        got, aux = moe.apply_moe(p, cfg, torch.from_numpy(x), capacity)
    drops = tap.drops
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _, ids, _ = jmoe._route(jp["router"], jcfg, jnp.asarray(x).reshape(
        18, -1))
    np.testing.assert_array_equal(tap.expert_ids[0].numpy(), np.asarray(ids))
    cap = capacity or moe.moe_capacity(cfg, 18)
    table, m = jmoe._dispatch_table(ids, jcfg.moe.num_experts, cap)
    assert [int(d) for d in drops] == [m - int((np.asarray(table)
                                                < m).sum())]
    if capacity == 1:
        assert int(drops[0]) > 0


def test_shared_experts_match_jax():
    jcfg, cfg, jp, p = _moe_params("deepseek-v2-236b", 3)
    xf = np.random.default_rng(5).normal(
        size=(7, cfg.d_model)).astype(np.float32)
    want = jmoe._shared_experts(jp, jcfg, jnp.asarray(xf))
    got = moe._shared_experts(p, cfg, torch.from_numpy(xf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert p["shared"]["wi"].shape == (cfg.d_model, 2 * cfg.moe.shared_d_ff)


def test_routing_is_tapped_only_inside_the_block():
    _, cfg, _, p = _moe_params("mixtral-8x22b", 0)
    x = torch.zeros((1, 3, cfg.d_model))
    moe.apply_moe(p, cfg, x)
    with moe.tap_routing() as tap:
        moe.apply_moe(p, cfg, x, capacity=1)
        moe.apply_moe(p, cfg, x)
    assert [int(d) for d in tap.drops] == [6 - 2, 0]
    assert [e.tolist() for e in tap.expert_ids] == [[[0, 1]] * 3] * 2
    assert moe._tap is None


def test_forced_routing_replays_the_given_experts():
    """Forcing a call onto its own recorded routing changes nothing;
    forcing it onto other experts routes there, gated by its own
    probabilities at those experts."""
    jcfg, cfg, jp, p = _moe_params("deepseek-v2-236b", 6)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 5, cfg.d_model)).astype(np.float32))
    with moe.tap_routing() as tap:
        y, _ = moe.apply_moe(p, cfg, x)
    with moe.tap_routing(forced=tap.expert_ids) as again:
        y2, _ = moe.apply_moe(p, cfg, x)
    assert torch.equal(y, y2)
    assert torch.equal(again.expert_ids[0], tap.expert_ids[0])
    other = (tap.expert_ids[0] + 1) % cfg.moe.num_experts
    with moe.tap_routing(forced=[other]) as moved:
        y3, _ = moe.apply_moe(p, cfg, x)
    assert torch.equal(moved.expert_ids[0], other)
    probs = torch.softmax(x.reshape(5, -1) @ p["router"], -1)
    g = torch.gather(probs, 1, other)
    g = g / g.sum(-1, keepdim=True)
    table, _ = moe._dispatch_table(other, cfg.moe.num_experts,
                                   moe.moe_capacity(cfg, 5))
    want = moe._combine_tokens(moe._expert_ffn(p, cfg, moe._gather_tokens(
        x.reshape(5, -1), table, 2)), g, table, 5, 2) + moe._shared_experts(
        p, cfg, x.reshape(5, -1))
    torch.testing.assert_close(y3.reshape(5, -1), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_dispatch_without_a_mesh_is_the_global_path(arch):
    """``apply_moe`` with ``moe_impl="local"`` and no mesh installed
    falls back to the global dispatch, as the JAX package's does: the
    same output, aux and routing as the global path, and the JAX
    package's local-without-mesh result to rtol 1e-5 / atol 1e-6; the
    local path's fallback counter does not move (it counts only the
    reference's two fallbacks under a mesh)."""
    jcfg, cfg, jp, p = _moe_params(arch, 0)
    x = np.random.default_rng(3).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32)
    before = dict(moe.local_fallbacks)
    with moe.tap_routing() as tap_l:
        y_l, aux_l = moe.apply_moe(
            p, dataclasses.replace(cfg, moe_impl="local"),
            torch.from_numpy(x))
    with moe.tap_routing() as tap_g:
        y_g, aux_g = moe.apply_moe(p, cfg, torch.from_numpy(x))
    assert moe.local_fallbacks == before
    assert torch.equal(y_l, y_g) and torch.equal(aux_l, aux_g)
    assert torch.equal(tap_l.expert_ids[0], tap_g.expert_ids[0])
    want, jaux = jmoe.apply_moe(jp, dataclasses.replace(
        jcfg, moe_impl="local"), jnp.asarray(x))
    np.testing.assert_allclose(y_l.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux_l), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# mixtral-8x22b at REDUCED size
# ---------------------------------------------------------------------------

def test_mixtral_forward_loss_and_gradients_match_jax():
    check_forward_and_gradients("mixtral-8x22b")


def test_mixtral_chunked_forward_matches_jax():
    check_chunked_forward("mixtral-8x22b")


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_mixtral_prefill_then_decode_every_position_match_jax(impl):
    check_prefill_then_decode("mixtral-8x22b", impl)


def test_mixtral_init_model_and_caches_lay_out_like_jax():
    check_layout("mixtral-8x22b")
