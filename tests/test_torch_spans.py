"""The program's own spans and counters (``repro_torch.obs.trace``) and the
benchmark's readers of them, on the CPU at REDUCED sizes:

* with the profiler off, a MoE ``decode_step``, a train step and a
  ``DeltaSyncPod.do_round`` record nothing and enter no
  ``record_function``;
* under ``torch.profiler`` the same calls record each span with its
  ``parent`` and ``root``, each named ``repro_torch.<name>`` in the
  profiler's events; the MoE layer's spans record under a serve step only
  (a train step's forward runs twice under ``checkpoint``);
* ``moe.dropped_pairs`` is ``N·K − capacity`` a dispatch under a routing
  forced onto expert 0, and equals ``tap_routing``'s drops on the global
  path and on both local paths (two ``gloo`` ranks, a 1×2 mesh);
* each new per-layer metric gives the hand-computed number on hand-written
  spans, and ``None`` without them.
"""

import dataclasses
import json
import os
import random
import statistics
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import NetConfig, Simulator
from repro_torch.models import decode_step, init_model, moe, prefill
from repro_torch.obs import trace
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import TrainConfig, make_train_step
from repro_torch.sync import DeltaSyncPod, TopKCompressor

ROOT = Path(__file__).resolve().parent.parent
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}


@pytest.fixture(autouse=True)
def fresh_record():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def mixtral():
    cfg = get_config("mixtral-8x22b", reduced=True)
    return cfg, init_model(cfg, 0, device="cpu")


def _tokens(cfg, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=g)


def _serve(cfg, params, b=2, s=16):
    """A prefill, then one decode step."""
    with torch.no_grad():
        logits, caches = prefill(cfg, params, {"tokens": _tokens(cfg, b, s)},
                                 max_len=s + 2)
        pos = torch.full((b, 1), s, dtype=torch.int32)
        decode_step(cfg, params, logits[:, -1].argmax(-1)[:, None], pos,
                    caches)


def _batch(cfg, b=2, s=8, seed=1):
    tok = _tokens(cfg, b, s, seed)
    return {"tokens": tok, "labels": torch.roll(tok, 1, 1)}


def _train(cfg, params):
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig()))
    step(params, init_opt_state(params), _batch(cfg))


def _pod_round(cfg, params):
    """Two pods' rounds (one local train step each, top-k payloads), then
    their gossip."""
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig()))

    def local_update(p, round_idx, pod_id):
        p, _, _ = step(p, init_opt_state(p), _batch(cfg, seed=round_idx))
        return p

    sim = Simulator(NetConfig(loss=0.0, dup=0.0, seed=0))
    ids = ["pod0", "pod1"]
    pods = [sim.add_node(DeltaSyncPod(
        i, [j for j in ids if j != i], params, local_update, num_pods=2,
        compressor=TopKCompressor(0.1), rng=random.Random(n)))
        for n, i in enumerate(ids)]
    for pod in pods:
        sim.every(1.0, pod.on_periodic)
    for pod in pods:
        pod.do_round()
    sim.run_for(3.0)


CALLS = {"serve": _serve, "train": _train, "pod_round": _pod_round}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_nothing_records_with_the_profiler_off(call, mixtral, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    CALLS[call](*mixtral)
    assert trace.spans() == {"spans": [], "counts": {}}
    assert not [n for n in entered if n.startswith("repro_torch.")]


def _profiled(call, cfg, params):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        CALLS[call](cfg, params)
    names = {e.name for e in prof.events()}
    return trace.spans(), names


def _check_tree(spans):
    """Every span's parent is an earlier-opened span of the record with
    the same root, and a root is its own."""
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is None:
            assert s["root"] == s["id"] and s["root_name"] == s["name"]
        else:
            p = by_id[s["parent"]]
            assert s["root"] == p["root"]
            assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
        assert by_id[s["root"]]["name"] == s["root_name"]
        assert s["stream_s"] is None          # no card here
    return by_id


def test_profiled_serve_step_records_its_spans(mixtral):
    rec, names = _profiled("serve", *mixtral)
    spans = rec["spans"]
    _check_tree(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["prefill", "decode_step"]
    layers = mixtral[0].n_layers
    for root in roots:
        inner = [s for s in spans if s["root"] == root["id"]
                 and s is not root]
        assert {s["parent"] for s in inner} == {root["id"]}
        got = [s["name"] for s in inner]
        # the dispatch table and the gather are both ``moe.dispatch``
        assert got == ["moe.route", "moe.dispatch", "moe.dispatch",
                       "moe.experts", "moe.combine"] * layers
    assert {f"repro_torch.{n}" for n in MOE_SPANS | {"prefill",
                                                     "decode_step"}} <= names
    b, s, k = 2, 16, mixtral[0].moe.top_k
    assert rec["counts"]["moe.routed_pairs"] == layers * (b * s + b) * k


def test_profiled_train_step_records_its_spans(mixtral):
    rec, names = _profiled("train", *mixtral)
    spans = rec["spans"]
    by_id = _check_tree(spans)
    assert [s["name"] for s in spans] == ["train.optimizer", "train_step"]
    opt, step = spans
    assert opt["parent"] == step["id"] and step["parent"] is None
    # no span inside the model's layers on the training path, no counts
    assert not MOE_SPANS & {s["name"] for s in by_id.values()}
    assert rec["counts"] == {}
    assert "alloc_retries" not in step         # CUDA only
    assert {"repro_torch.train_step", "repro_torch.train.optimizer"} <= names


def test_profiled_pod_round_records_its_spans(mixtral):
    rec, names = _profiled("pod_round", *mixtral)
    spans = rec["spans"]
    by_id = _check_tree(spans)
    rounds = [s for s in spans if s["name"] == "pod.round"]
    assert len(rounds) == 2 and all(r["parent"] is None for r in rounds)
    for r in rounds:
        inner = [s for s in spans if s["parent"] == r["id"]]
        assert [s["name"] for s in inner] == ["pod.params", "train_step",
                                              "topk.compress"]
        (step,) = [s for s in inner if s["name"] == "train_step"]
        (opt,) = [s for s in spans if s["parent"] == step["id"]]
        assert opt["name"] == "train.optimizer" and opt["root"] == r["id"]
    gossip = [s for s in spans if s["name"].startswith("replica.")]
    assert {s["name"] for s in gossip} == {"replica.receive",
                                           "replica.periodic"}
    assert all(s["parent"] is None for s in gossip)
    assert {s["name"] for s in by_id.values()} == {
        "pod.round", "pod.params", "train_step", "train.optimizer",
        "topk.compress", "replica.receive", "replica.periodic"}
    assert {f"repro_torch.{s['name']}" for s in spans} <= names


# -- the mechanism ------------------------------------------------------------

def test_spans_nest_and_keep_to_their_roots():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer", note=3) as o:
            with trace.span("inner"):
                with trace.span("deep", within=("outer",)):
                    pass
            with trace.span("skipped", within=("decode_step",)):
                pass
            trace.count("n", 2)
            trace.count("n", torch.tensor(3))
        with trace.span("decode_step"):
            trace.count("m", 1)
    rec = trace.spans()
    by = {s["name"]: s for s in rec["spans"]}
    assert set(by) == {"outer", "inner", "deep", "decode_step"}
    assert by["outer"]["note"] == 3 and by["outer"]["id"] == o.id
    assert by["inner"]["parent"] == o.id and by["deep"]["parent"] == \
        by["inner"]["id"]
    assert {by[n]["root"] for n in ("outer", "inner", "deep")} == {o.id}
    assert by["deep"]["root_name"] == "outer"
    assert by["decode_step"]["root"] == by["decode_step"]["id"]
    assert rec["counts"] == {"n": 5, "m": 1}
    trace.clear()
    assert trace.spans() == {"spans": [], "counts": {}}


def test_spans_record_only_while_the_profiler_does():
    assert not trace.recording()
    assert trace.span("x") is trace.span("y")        # the shared no-op
    f = trace.spanned("f")(lambda a, b=0: a + b)
    assert f(1, b=2) == 3
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording() and not trace.recording(("x",))
        assert f(2, b=2) == 4
    assert f(3) == 3
    assert [s["name"] for s in trace.spans()["spans"]] == ["f"]


# -- the MoE counters ---------------------------------------------------------

@pytest.mark.parametrize("step", ["prefill", "decode_step"])
def test_dropped_pairs_count_a_routing_forced_onto_one_expert(mixtral, step):
    # the benchmark's capacity factor (REDUCED's 4.0 leaves room for all)
    cfg = dataclasses.replace(mixtral[0], moe=dataclasses.replace(
        mixtral[0].moe, capacity_factor=1.25))
    params = mixtral[1]
    b, s, K, L = 2, 16, cfg.moe.top_k, cfg.n_layers
    with torch.no_grad():
        logits, caches = prefill(cfg, params, {"tokens": _tokens(cfg, b, s)},
                                 max_len=s + 2)
    n = b * s if step == "prefill" else b
    forced = [torch.zeros((n, K), dtype=torch.int64)] * L
    with torch.no_grad(), moe.tap_routing(forced=forced) as tap, \
            profile(activities=[ProfilerActivity.CPU]):
        if step == "prefill":
            prefill(cfg, params, {"tokens": _tokens(cfg, b, s)},
                    max_len=s + 2)
        else:
            decode_step(cfg, params, logits[:, -1].argmax(-1)[:, None],
                        torch.full((b, 1), s, dtype=torch.int32), caches)
    counts = trace.spans()["counts"]
    by_hand = L * (n * K - moe.moe_capacity(cfg, n))
    assert by_hand > 0
    assert counts["moe.dropped_pairs"] == by_hand
    assert counts["moe.dropped_pairs"] == sum(int(d) for d in tap.drops)
    assert counts["moe.routed_pairs"] == L * n * K


def test_dropped_pairs_equal_the_tap_on_the_global_path(mixtral):
    cfg = dataclasses.replace(mixtral[0], moe=dataclasses.replace(
        mixtral[0].moe, capacity_factor=0.5))
    params = mixtral[1]
    with moe.tap_routing() as tap, \
            profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, params, b=4, s=16)
    counts = trace.spans()["counts"]
    assert len(tap.drops) == 2 * cfg.n_layers
    assert counts["moe.dropped_pairs"] == sum(int(d) for d in tap.drops) > 0


LOCAL_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import dist as D
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, moe, prefill
    from repro_torch.models.hints import activation_rules, default_rules
    from repro_torch.models.transformer import logical_specs
    from repro_torch.obs import trace
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    result = {}
    try:
        base = get_config("mixtral-8x22b", reduced=True)
        for regime, E in (("ep", 4), ("tp", 3)):
            cfg = dataclasses.replace(base, moe_impl="local",
                                      moe=dataclasses.replace(
                                          base.moe, num_experts=E,
                                          capacity_factor=0.5))
            params = init_model(cfg, 1, device="cpu")
            rules = D.make_rules(mesh, serve=True)
            dparams = D.distribute(params, D.param_pspecs(
                params, logical_specs(cfg), rules), mesh)
            tok = torch.randint(0, cfg.vocab, (4, 16),
                                generator=torch.Generator().manual_seed(2))
            before = dict(moe.local_fallbacks)
            trace.clear()
            with torch.no_grad(), \\
                    activation_rules(mesh, default_rules(False, serve=True)), \\
                    moe.tap_routing() as tap, \\
                    profile(activities=[ProfilerActivity.CPU]):
                prefill(cfg, dparams, {"tokens": tok}, max_len=18)
            counts = trace.spans()["counts"]
            result[regime] = {
                "tapped": len(tap.drops),
                "tap_drops": sum(int(d) for d in tap.drops),
                "dropped": counts.get("moe.dropped_pairs"),
                "routed": counts.get("moe.routed_pairs"),
                "fallbacks": {k: moe.local_fallbacks[k] - before[k]
                              for k in before}}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def local_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", LOCAL_WORKER, str(r), f"file://{d}/pg",
         str(d)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(ranks, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("regime", ["ep", "tp"])
def test_dropped_pairs_equal_the_tap_on_the_local_paths(local_paths, regime):
    layers = get_config("mixtral-8x22b", reduced=True).n_layers
    for got in (rank[regime] for rank in local_paths):
        assert got["fallbacks"] == {"tokens": 0, "expert_width": 0}
        assert got["tapped"] == layers
        assert got["dropped"] == got["tap_drops"] > 0
    # expert-parallel: each model rank dispatches half the tokens;
    # tensor-parallel: every rank dispatches all of them
    share = 2 if regime == "ep" else 1
    assert [r[regime]["routed"] for r in local_paths] == \
        [layers * 4 * 16 * 2 // share] * 2


# -- the benchmark's readers ----------------------------------------------------

def _span(i, name, root, root_name, host=0.0, stream=None, **fields):
    return dict(name=name, id=i, parent=None if i == root else root,
                root=root, root_name=root_name, t0=0.0, t1=host,
                host_s=host, stream_s=stream, **fields)


SERVE = [
    _span(1, "prefill", 1, "prefill", 0.8, 0.7),
    _span(2, "moe.experts", 1, "prefill", stream=0.5),
    _span(3, "moe.route", 1, "prefill", stream=0.5),
    _span(10, "decode_step", 10, "decode_step", 0.030, 0.05),
    _span(11, "moe.route", 10, "decode_step", stream=0.001),
    _span(12, "moe.dispatch", 10, "decode_step", stream=0.002),
    _span(13, "moe.experts", 10, "decode_step", stream=0.010),
    _span(14, "moe.experts", 10, "decode_step", stream=0.002),
    _span(15, "moe.combine", 10, "decode_step", stream=0.001),
    _span(20, "decode_step", 20, "decode_step", 0.040, 0.05),
    _span(21, "moe.route", 20, "decode_step", stream=0.002),
    _span(22, "moe.dispatch", 20, "decode_step", stream=0.003),
    _span(23, "moe.experts", 20, "decode_step", stream=0.014),
    _span(24, "moe.combine", 20, "decode_step", stream=0.003),
    _span(30, "decode_step", 30, "decode_step", 0.020, 0.05),
    _span(31, "moe.dispatch", 30, "decode_step", stream=0.001),
    _span(32, "moe.experts", 30, "decode_step", stream=0.016),
]
TRAIN = [
    _span(1, "train_step", 1, "train_step", 2.4, 2.4, alloc_retries=0),
    _span(2, "train.optimizer", 1, "train_step", stream=0.05),
    _span(3, "train_step", 3, "train_step", 2.4, 2.4, alloc_retries=2),
    _span(4, "train.optimizer", 3, "train_step", stream=0.08),
    _span(5, "train_step", 5, "train_step", 2.4, 2.4, alloc_retries=1),
    _span(6, "train.optimizer", 5, "train_step", stream=0.06),
    _span(7, "train_step", 7, "train_step", 2.4, 2.4, alloc_retries=1),
    _span(8, "train.optimizer", 7, "train_step", stream=0.07),
]
ROUND = [
    _span(1, "pod.round", 1, "pod.round", 10.0, 10.0),
    _span(2, "pod.params", 1, "pod.round", stream=0.5),
    _span(3, "train_step", 1, "pod.round", 2.4, 2.4, alloc_retries=3),
    _span(4, "train.optimizer", 1, "pod.round", stream=0.04),
    _span(5, "topk.compress", 1, "pod.round", stream=0.1),
    _span(6, "pod.round", 6, "pod.round", 10.0, 10.0),
    _span(7, "pod.params", 6, "pod.round", stream=0.7),
    _span(8, "train_step", 6, "pod.round", 2.4, 2.4, alloc_retries=0),
    _span(9, "train.optimizer", 6, "pod.round", stream=0.06),
    _span(10, "topk.compress", 6, "pod.round", stream=0.2),
    _span(11, "replica.periodic", 11, "replica.periodic", stream=0.005),
    _span(12, "replica.receive", 12, "replica.receive", stream=0.01),
    _span(13, "replica.receive", 13, "replica.receive", stream=0.02),
]

BY_HAND = {
    # decode steps' host times 30, 40, 20 ms
    "decode_enqueue_ms.serve": ("mixtral-8x22b.decode", SERVE, 30.0),
    # per decode step: 10 + 2, 14, 16 ms (the prefill's left out)
    "moe_experts_ms.serve": ("mixtral-8x22b.decode", SERVE, 14.0),
    # per decode step: 1 + 2 + 1, 2 + 3 + 3, 1 ms
    "moe_glue_ms.serve": ("mixtral-8x22b.prefill", SERVE, 4.0),
    "moe_drop_share.serve": ("mixtral-8x22b.decode", None, 12.5),
    # medians of 50, 80, 60, 70 ms and of 0, 2, 1, 1 retries a step
    "optimizer_ms.train": ("stablelm-1.6b.sync", TRAIN, 65.0),
    "alloc_retries.train": ("stablelm-1.6b.localsgd", ROUND, 1.5),
    "outer_params_ms.localsgd": ("stablelm-1.6b.localsgd", ROUND, 1200.0),
    "topk_ms.localsgd": ("stablelm-1.6b.localsgd", ROUND, 300.0),
    "gossip_ms.localsgd": ("stablelm-1.6b.localsgd", ROUND, 35.0),
}


def _run(workload):
    from perfbench import harness, spec
    return harness.Run(cell=spec.load_cell(workload), seed=1, seconds=1.0,
                       trace=True, device="cpu", t0=time.perf_counter())


def _read(name, workload, record, monkeypatch):
    from perfbench import spec
    monkeypatch.setattr(trace, "spans", lambda: record)
    return spec.metric_reader(name)(_run(workload))


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_metric_reader_by_hand(name, monkeypatch):
    workload, spans, want = BY_HAND[name]
    counts = {"moe.routed_pairs": 640, "moe.dropped_pairs": 80}
    got = _read(name, workload, {"spans": spans or SERVE, "counts": counts},
                monkeypatch)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_metric_reader_without_spans(name, monkeypatch):
    workload = BY_HAND[name][0]
    assert _read(name, workload, {"spans": [], "counts": {}},
                 monkeypatch) is None
    # as a run without a card records them: no stream time, no
    # allocator fields; only the host-clock readers read
    cpu = [{k: v for k, v in s.items() if k != "alloc_retries"}
           for s in SERVE + ROUND]
    for s in cpu:
        s["stream_s"] = None
    got = _read(name, workload, {"spans": cpu, "counts": {}}, monkeypatch)
    if name == "decode_enqueue_ms.serve":
        assert got == pytest.approx(statistics.median([30.0, 40.0, 20.0]))
    else:
        assert got is None
    # a program from before the spans: the module has no reader
    monkeypatch.delattr(trace, "spans")
    from perfbench import spec
    assert spec.metric_reader(name)(_run(workload)) is None


def test_every_new_reader_has_its_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, (workload, _, _) in BY_HAND.items():
        assert workload in entries[name]["workloads"]
        assert (ROOT / "perfbench" / "metrics" / f"{name}.py").is_file()
