"""The benchmark loads neither JAX nor the JAX package, its file keeps its
schema, and its operation and byte counts match hand counts."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import yardstick as y

ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import perfbench
for m in pkgutil.walk_packages(perfbench.__path__, "perfbench."):
    importlib.import_module(m.name)
from perfbench import spec, tiny, harness, reference, weights, data
for path in (spec.HERE / "metrics").glob("*.py"):
    spec.metric_reader(path.stem)
import repro_torch.core, repro_torch.models, repro_torch.optim
import repro_torch.runtime, repro_torch.sync
import torch
torch.set_num_threads(1)
dense = tiny.cell("stablelm-1.6b.sync").conf
moe = tiny.cell("mixtral-8x22b.decode").conf
tok = data.tokens(1, "t", (2, 12), moe["vocab"], "cpu")
reference.serve_logits(moe, 1, tok, 8)
b = data.train_batch(1, 0, 0, 2, 8, dense["vocab"], "cpu")
reference.train_steps(dense, 1, [b], tiny.cell("stablelm-1.6b.sync").mix["optimizer"])
print("FORBIDDEN", ",".join(harness.forbidden_modules()))
"""


def test_nothing_loads_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("FORBIDDEN")]
    assert line == ["FORBIDDEN "], out.stdout[-2000:]


def test_forbidden_names_are_compared_whole():
    from perfbench import harness
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "jaxtyping", "flaxen",
         "reprox.core"]) == []
    assert harness.forbidden_modules(
        ["repro.core.sim", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_its_schema():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) or k.startswith("d_")
                       for k in c["reduced"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_causal_pairs_by_hand():
    assert y.causal_pairs(4, None) == 1 + 2 + 3 + 4
    assert y.causal_pairs(4, 2) == 1 + 2 + 2 + 2
    assert y.causal_pairs(3, 8) == 6


def test_flash_prefill_cost_by_hand():
    # b=1, H=2, KV=1, s=4, hd=2, no window: 10 pairs a head
    flops, nbytes = y.flash_prefill_cost(1, 2, 1, 4, 2, None)
    assert flops == 4 * 2 * 2 * 10
    assert nbytes == 2 * (1 * 2 * 4 * 2 * 2 + 1 * 1 * 4 * 2 * 2)


def test_flash_decode_cost_by_hand():
    # b=1, H=2, KV=1, C=8 slots of which 3 valid, hd=4
    flops, nbytes = y.flash_decode_cost(1, 2, 1, 8, 4, 3)
    assert flops == 4 * 2 * 4 * 3
    # q and o: 2·H·hd bf16; k and v: 2·KV·valid·hd bf16; 8 + 1 int32
    assert nbytes == 2 * (2 * 2 * 4) + 2 * (2 * 1 * 3 * 4) + 4 * 8 + 4


def test_roofline_takes_the_larger_bound():
    assert y.roofline_s(989e12, 0.0) == pytest.approx(1.0)
    assert y.roofline_s(0.0, 3.35e12) == pytest.approx(1.0)


DENSE = {"d_model": 2, "n_heads": 1, "n_kv_heads": 1, "head_dim": 2,
         "d_ff": 3, "vocab": 5, "n_layers": 1, "mlp": "dense",
         "window": None}


def test_model_operations_by_hand():
    # one layer: q, k, v, o 4 MACs each (32 ops), MLP 3·2·3 MACs (36)
    layer = 32 + 36
    head = 2 * 2 * 5
    # seq 2: 3 causal pairs, 4·H·hd = 8 ops each
    assert y.train_step_flops(DENSE, 1, 2) == 3 * (2 * (layer + head) + 24)
    assert y.prefill_flops(DENSE, 1, 2) == 2 * layer + 24 + head
    assert y.decode_flops(DENSE, 1, 1) == layer + 8 * 2 + head


def test_moe_operations_count_the_top_k_experts():
    moe = dict(DENSE, mlp="moe", moe={"num_experts": 4, "top_k": 2,
                                      "expert_d_ff": 3})
    # router 2·4 MACs, two experts of 3·2·3 MACs each, attention 32 ops
    assert y.decode_flops(moe, 1, 0) == (32 + 2 * (8 + 2 * 18)
                                         + 4 * 2 * 1 + 2 * 2 * 5)


def test_window_caps_the_attended_keys():
    w = dict(DENSE, window=2)
    assert y.decode_flops(w, 1, 9) == y.decode_flops(w, 1, 1)


def test_spread_and_percentile():
    assert y.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert y.percentile([1, 2, 3, 4, 5], 50) == 3
    assert y.percentile([0, 10], 90) == pytest.approx(9.0)
