"""The port on a 2×4 ("data", "model") CPU mesh: eight ``gloo`` ranks in
their own processes (``torch_mesh_worker.py``, rendezvous through a file
of the test's own directory), held to the JAX package and to the
unsharded port:

* the local (per-shard) MoE equals the JAX package's global MoE on the
  same numpy inputs, with ``tests/test_moe_local.py``'s setup, in both
  regimes (E=8 expert-parallel, E=3 tensor-parallel), at rtol = atol =
  2e-4, the aux within that test's 0.4, with no fallback to the global
  path; the gradients of the output and the aux equal the port's global
  path's to 2e-4 (its aux over the same token groups, equal to 1e-6);
* a REDUCED dense forward and one train step on ``DTensor`` parameters
  equal the unsharded port to 1e-5 in f32, with the heads replicated
  (qwen2's 6 heads on 4 ranks, recorded as a fallback) and, with the
  vocab, split over "model"; and a step of 2 microbatches with an
  uneven ``loss_mask``;
* REDUCED qwen1.5-0.5b, deepseek-v2 (MLA, local MoE) and jamba (SSD,
  attention, local MoE) served on the mesh (prefill, then decode over
  caches laid out there) give the unsharded run's tokens, and its
  logits to 1e-5;
* ``hint`` gives the placements of the reference's ``hint``, read from
  ``jax.jit(lambda x: hint(x, axes))(x).sharding.spec`` on a forced
  8-device mesh in a subprocess.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import ModelConfig, MoESpec
from repro.models.moe import apply_moe, init_moe

from torch_mesh_worker import HINT_CASES

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
TIMEOUT = 600

JAX_HINTS = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from repro.models.hints import activation_rules, default_rules, hint
    cases = json.loads(sys.argv[1])
    # Auto axes: with_sharding_constraint's (this JAX makes Explicit
    # axes by default)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = []
    with mesh, activation_rules(mesh, default_rules(False)):
        for shape, axes in cases:
            x = jnp.zeros(shape)
            spec = jax.jit(lambda x: hint(x, tuple(axes)))(x).sharding.spec
            spec = list(spec) + [None] * (len(shape) - len(spec))
            out.append([list(s) if isinstance(s, tuple) else s
                        for s in spec])
    print(json.dumps(out))
""")


def _jax_moe(ep):
    """tests/test_moe_local.py's inputs and the JAX global MoE on them."""
    E = 8 if ep else 3
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=0, vocab=17,
                      moe=MoESpec(num_experts=E, top_k=2, expert_d_ff=64,
                                  num_shared_experts=1, shared_d_ff=32,
                                  capacity_factor=float(E)),
                      dtype="float32", moe_impl="global")
    p, _ = init_moe(cfg, jax.random.PRNGKey(0), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32), jnp.float32)
    y, aux = apply_moe(p, cfg, x)
    tag = "ep" if ep else "tp"
    out = {f"{tag}_x": np.asarray(x), f"{tag}_y": np.asarray(y),
           f"{tag}_aux": np.asarray(aux)}
    for k, v in p.items():
        if k == "shared":
            out.update({f"{tag}_p_shared_{kk}": np.asarray(vv)
                        for kk, vv in v.items()})
        else:
            out[f"{tag}_p_{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "moe.npz", **_jax_moe(True), **_jax_moe(False))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    jax_hints = subprocess.Popen(
        [sys.executable, "-c", JAX_HINTS, json.dumps(HINT_CASES)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(r), str(WORLD), f"file://{d}/pg", str(d)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in ranks]
        jout = jax_hints.communicate(timeout=TIMEOUT)
    finally:
        for p in ranks + [jax_hints]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(ranks, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    assert jax_hints.returncode == 0, jout[1][-3000:]
    result = json.loads((d / "result.json").read_text())
    result["jax_hint"] = json.loads(jout[0].strip().splitlines()[-1])
    return result


@pytest.mark.parametrize("regime", ["moe-ep", "moe-tp"])
def test_local_moe_on_the_mesh_matches_jax_global(rehearsal, regime):
    r = rehearsal[regime]
    assert r["close"], r
    assert r["grad_err"] <= 2e-4, r
    assert abs(r["aux"] - r["aux_ref"]) < 0.4, r
    assert r["aux_groups_err"] <= 1e-6, r
    assert r["fallbacks"] == {"tokens": 0, "expert_width": 0}


@pytest.mark.parametrize("case", ["dense-replicated-heads",
                                  "dense-split-heads"])
def test_dense_forward_and_train_step_on_dtensors(rehearsal, case):
    r = rehearsal[case]
    for k in ("logits_err", "loss_err", "grad_norm_err", "param_err",
              "moment_err"):
        assert r[k] <= 1e-5, (k, r)
    assert r["placements_kept"]
    assert r["backward_on_another_thread"]
    heads = [f for f in r["fallbacks"] if "heads" in f]
    if case == "dense-replicated-heads":
        assert heads == ["attn heads(6, 2): not divisible by heads=4 — "
                         "replicated"]
    else:
        assert heads == []


def test_microbatched_train_step_on_dtensors(rehearsal):
    r = rehearsal["dense-microbatches"]
    for k in ("loss_err", "grad_norm_err", "param_err", "moment_err"):
        assert r[k] <= 1e-5, (k, r)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_served_families_on_the_mesh_match_the_unsharded_run(rehearsal,
                                                              arch):
    r = rehearsal["served"][arch]
    assert r["tokens_equal"], r
    assert r["logits_err"] <= 1e-5, r


def test_hint_placements_match_jax(rehearsal):
    assert rehearsal["hint"] == rehearsal["jax_hint"]
