"""The port's dry-run (``launch/dryrun.py``): each step traced on ``meta``
tensors as one rank of a ``"fake"`` process group, in a subprocess (the
group is process state):

* ``run_cell`` on a 2×4 mesh for the JAX integration test's five
  arch × step pairs (``tests/test_dryrun_integration.py``) plus mixtral
  train with ``moe_impl="local"``, at REDUCED size: per-chip parameter,
  optimizer, cache and batch bytes equal the sums over leaves of the
  local shards that the reference's specs imply; flops × chips at least
  the unsharded step's count and ``useful_frac`` ≤ 1;
* on a 1×1 mesh the traced flops equal ``FlopCounterMode``'s count of
  the unsharded step;
* a [256, 4096] × [4096, 11008] bf16 product sharded over a fake 16×16
  mesh counts exactly total / 256 flops a chip and one all-gather of
  size · 15/16 bytes;
* ``--attn-impl chunked`` on ``meta`` raises (no plain fallback);
* the CLI's production cell (qwen2-1.5b ``train_4k`` on 16×16) writes an
  artifact with the JAX ``run_cell``'s keys that ``launch.report``
  renders, and qwen1.5-0.5b ``train_4k`` on 16×16 traces.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.dist import shardings as jsh
from repro.launch.dryrun import abstract_model

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 600

PAIRS = [("qwen2-1.5b", "train", None), ("gemma2-27b", "prefill", None),
         ("mamba2-130m", "train", None), ("jamba-v0.1-52b", "decode", None),
         ("deepseek-v2-236b", "decode", None),
         ("mixtral-8x22b", "train", "local")]

SMALL_MESH = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.launch.dryrun import run_cell

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {}
    for arch, step, moe in json.loads(sys.argv[1]):
        cfg = get_config(arch, reduced=True)
        seq = cfg.ssm.chunk * 2 if cfg.ssm is not None else 32
        if cfg.input_mode == "tokens+prefix":
            seq = max(seq, cfg.prefix_len + 16)
        case = ShapeCase("t", seq, 8, step)
        res = run_cell(arch, "t", False, mesh=mesh, case=case, reduced=True,
                       overrides={"moe_impl": moe} if moe else None)
        out[f"{arch}-{step}"] = {"seq": seq, **res}
    try:
        run_cell("qwen2-1.5b", "t", False, mesh=mesh,
                 case=ShapeCase("t", 32, 8, "prefill"), reduced=True,
                 overrides={"attn_impl": "chunked"})
        out["chunked"] = "ran"
    except ValueError as e:
        out["chunked"] = str(e)
    dist.destroy_process_group()
    print(json.dumps(out))
""")

ONE_BY_ONE = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCase, input_specs
    from repro_torch.dist import make_rules
    from repro_torch.launch.dryrun import (_trace_step, abstract_model,
                                           abstract_opt_state)
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (TrainConfig, make_prefill_fn,
                                     make_train_step)

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    out = {}
    for arch, step in json.loads(sys.argv[1]):
        cfg = get_config(arch, reduced=True)
        case = ShapeCase("t", 32, 4, step)
        traced = _trace_step(cfg, case, mesh, False, make_rules(mesh))
        params, _ = abstract_model(cfg)
        batch = input_specs(cfg, case)
        with FlopCounterMode(display=False) as fc:
            if step == "train":
                make_train_step(cfg, TrainConfig(optimizer=AdamWConfig()))(
                    params, abstract_opt_state(params), batch)
            else:
                with torch.no_grad():
                    make_prefill_fn(cfg, max_len=32)(params, batch)
        out[f"{arch}-{step}"] = [traced["flops"], fc.get_total_flops()]
    dist.destroy_process_group()
    print(json.dumps(out))
""")

PRODUCT = textwrap.dedent("""
    import json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import StepCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    a = distribute_tensor(torch.empty(256, 4096, dtype=torch.bfloat16,
                                      device="meta"), mesh,
                          [Shard(0), Shard(1)])
    b = distribute_tensor(torch.empty(4096, 11008, dtype=torch.bfloat16,
                                      device="meta"), mesh,
                          [Replicate(), Shard(1)])
    with StepCounter() as c:
        y = a @ b
    print(json.dumps({"flops": c.flops, "collectives": c.collectives,
                      "out": list(y.to_local().shape)}))
    dist.destroy_process_group()
""")


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", script, *args], env=env,
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small_mesh():
    return _run(SMALL_MESH, json.dumps(PAIRS))


class _Mesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _local_bytes(sds_tree, spec_tree, sizes):
    """Bytes of one rank's shards of a tree laid out by reference specs."""
    total = 0
    for x, spec in zip(jax.tree_util.tree_leaves(sds_tree),
                       jax.tree_util.tree_leaves(
                           spec_tree, is_leaf=lambda s: isinstance(
                               s, jax.sharding.PartitionSpec))):
        shape = list(x.shape)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                shape[d] //= sizes[a]
        total += int(np.prod(shape)) * np.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,step,moe", PAIRS)
def test_cells_trace_on_a_2x4_mesh(small_mesh, arch, step, moe):
    res = small_mesh[f"{arch}-{step}"]
    assert res["status"] == "ok" and res["mesh"] == "2x4"
    assert res["chips"] == 8
    sizes = {"data": 2, "model": 4}
    jcfg = jget_config(arch, reduced=True)
    rules = jsh.make_rules(_Mesh(sizes))
    total_params, _ = jcfg.param_counts()
    if step != "train" and total_params * 2 / 4 <= 12e9 and 8 >= 2:
        rules = jsh.make_rules(_Mesh(sizes), serve=True)  # JAX's serve test
    params, logical = abstract_model(jcfg)
    pspecs = jsh.param_pspecs(params, logical, rules)
    mem = res["memory_analysis"]
    p_bytes = _local_bytes(params, pspecs, sizes)
    assert mem["param_bytes"] == p_bytes
    if step == "train":
        f32 = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), params)
        assert mem["opt_state_bytes"] == 3 * _local_bytes(f32, pspecs,
                                                          sizes) + 4
    else:
        assert "opt_state_bytes" not in mem
    assert ("cache_bytes" in mem) == (step == "decode")
    assert mem["argument_size_in_bytes"] == sum(
        v for k, v in mem.items() if k.endswith("bytes") and
        k not in ("argument_size_in_bytes", "temp_size_in_bytes"))
    # the step's peak of live tensors, this rank's (mem_tracker on meta)
    assert 0 < mem["temp_size_in_bytes"]
    assert res["roofline"]["peak_memory_gb"] == \
        mem["temp_size_in_bytes"] / 1e9
    cost = res["cost_analysis"]
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    assert res["cost_analysis_raw_scan_body_once"]["flops"] == cost["flops"]
    r = res["roofline"]
    assert 0 < r["useful_frac"] <= 1.0
    assert r["bound"] in ("compute", "memory", "collective")
    assert res["collective_wire_bytes_per_chip"] == pytest.approx(
        sum(res["collective_breakdown"].values()))
    if moe == "local":
        assert res["collective_counts"].get("all-to-all", 0) > 0


def test_flops_times_chips_cover_the_unsharded_step(small_mesh):
    one = _run(ONE_BY_ONE, json.dumps([["qwen2-1.5b", "train"],
                                       ["gemma2-27b", "prefill"]]))
    for key, (traced, counted) in one.items():
        assert traced == counted > 0, key          # 1×1: the same work
    # the 2×4 cell at its own sequence length: every chip's share
    # together is at least the unsharded count
    two = _run(ONE_BY_ONE.replace('ShapeCase("t", 32, 4, step)',
                                  'ShapeCase("t", 32, 8, step)'),
               json.dumps([["qwen2-1.5b", "train"]]))
    traced_1x1 = two["qwen2-1.5b-train"][1]
    assert small_mesh["qwen2-1.5b-train"]["cost_analysis"]["flops"] * 8 \
        >= traced_1x1


def test_sharded_product_counts_one_chips_share():
    r = _run(PRODUCT)
    total = 2 * 256 * 4096 * 11008
    assert r["flops"] == total / 256
    assert r["out"] == [16, 11008 // 16]
    # the contraction dim gathered over "model": one all-gather of the
    # activation shard, [16, 4096] bf16, charged size · 15/16
    assert r["collectives"] == [["all-gather", 16 * 4096 * 2, 16]]
    from repro_torch.dist.hlo import recorded_collective_bytes
    wire, _ = recorded_collective_bytes(r["collectives"])
    assert wire == 16 * 4096 * 2 * 15 / 16


def test_chunked_attention_on_meta_raises(small_mesh):
    assert "no kernel for tensors on meta" in small_mesh["chunked"]


JAX_RUN_CELL_KEYS = {
    "arch", "shape", "mesh", "status", "chips", "compile_s",
    "cost_analysis", "cost_analysis_raw_scan_body_once", "memory_analysis",
    "collective_wire_bytes_per_chip", "collective_breakdown",
    "collective_counts", "params_total", "params_active",
    "model_flops_total", "roofline", "sharding_fallbacks", "microbatches"}


def test_cli_production_cells(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in ("qwen2-1.5b", "qwen1.5-0.5b"):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "train_4k", "--mesh", "single", "--out",
             str(tmp_path)], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=TIMEOUT)
        assert r.returncode == 0, r.stderr[-3000:]
        assert f"[ ok ] {arch} × train_4k × 16x16" in r.stdout
    d = json.loads((tmp_path / "qwen2-1.5b_train_4k_16x16.json").read_text())
    assert JAX_RUN_CELL_KEYS <= set(d)
    assert d["chips"] == 256 and d["mesh"] == "16x16"
    # 6·N·D over the chips' traced flops
    assert 0 < d["roofline"]["useful_frac"] <= 1
    assert math.isclose(d["model_flops_total"],
                        6.0 * d["params_active"] * 256 * 4096)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                        str(tmp_path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    # 12 heads on a 16-wide "model" axis: attention replicated, marked
    assert d["layout_fallbacks"]
    assert "| qwen2-1.5b † | train_4k | 16x16 | ok |" in r.stdout
    assert "layout_fallbacks" in r.stdout
    assert "| qwen1.5-0.5b | train_4k |" in r.stdout
