"""Driver ``localsgd``: δ-CRDT local SGD, every pod on the one card.

Each pod (``DeltaSyncPod``) trains ``local_steps`` AdamW steps a round on
its own rank of the stream from its outer parameters, with a fresh
optimizer state, ships the round's displacement as one dot, top-k
compressed with error feedback, and the pods gossip over a lossy
simulated network (``Simulator``, periodic anti-entropy) between rounds.
Set-up is round 0 of every pod and its gossip; pod 0's round 0 starts
from the initial weights, so its first steps are held to the reference
as the ``train`` driver holds its steps. A round started in the window
runs whole, and the rate is over whole rounds: a round's outer work sits
between its pods' steps, and a window that ended on a step would count
it or not by where it fell. After the window the gossip runs until the
pods agree, and the outer parameters, the dots and the last top-k of
each pod are judged.
"""

from __future__ import annotations

import math
import random
import time

from .. import data, reference, spec, weights
from ..harness import Run
from ..tracing import Profiled
from .train import Checked, judge_steps, window_facts

CONVERGE_SIM_S = 300.0


def _pods_differ(pods) -> int:
    """Leaves on which the pods' outer parameters are not bit-equal."""
    import torch
    from repro_torch import tree as tu
    first = tu.leaves(pods[0].params())
    n = 0
    for pod in pods[1:]:
        for a, b in zip(first, tu.leaves(pod.params())):
            n += int(not torch.equal(a, b))
    return n


def _is_sparse(t) -> bool:
    return isinstance(t, dict) and "idx" in t


def _own_last_dot(pod):
    mine = [(s, upd) for (p, s), upd in pod.X.dots if p == pod.id]
    return max(mine, key=lambda t: t[0])[1] if mine else None


def topk_misses(pods, rate: float) -> int:
    """Leaves of each pod's last dot whose top-k with error feedback the
    reference does not reproduce: what was carried into that round's
    compression is the pod's residual with the shipped values put back;
    the reference's top-k of it has to ship the same entries and leave
    the same residual."""
    import torch
    from repro_torch import tree as tu
    misses = 0
    for pod in pods:
        sparse = tu.leaves(_own_last_dot(pod), is_leaf=_is_sparse)
        for s, r in zip(sparse, tu.leaves(pod.compressor.residual)):
            carried = r.clone()
            carried.reshape(-1)[s["idx"].long()] = s["vals"]
            idx, vals, left = reference.error_feedback(
                carried, torch.zeros_like(carried), rate)
            misses += int(not (torch.equal(idx.sort().values,
                                           s["idx"].long().sort().values)
                               and torch.equal(left, r)))
    return misses


def outer_gap(run: Run, pods) -> float:
    """Worst leaf of |program's outer parameters - init - Σ dots / P|
    over |Σ dots / P|, the sum laid out by the reference in float32."""
    from repro_torch import tree as tu
    conf = run.cell.conf
    dots = [tu.leaves(upd, is_leaf=_is_sparse) for _, upd in pods[0].X.dots]
    outer = tu.leaves(pods[0].params())
    paths = list(weights.leaf_paths(conf))
    order = _leaf_order(pods[0].outer.init, paths)
    worst = 0.0
    for i, p in enumerate(order):
        init = weights.initial_leaf(conf, run.seed, p, run.device)
        want = reference.dot_sum(init, [(d[i]["idx"], d[i]["vals"])
                                        for d in dots], 1.0 / len(pods))
        moved = float((want - init).norm())
        if moved == 0.0:
            continue
        worst = max(worst, float((outer[i].float() - want).norm()) / moved)
    return worst


def _leaf_order(tree, paths):
    """The paths in the order the port's tree flattens its leaves."""
    from repro_torch import tree as tu
    ids = {id(weights.get(tree, p)): p for p in paths}
    return [ids[id(t)] for t in tu.leaves(tree)]


def run(run: Run) -> None:
    from repro_torch.core import (NetConfig, Simulator, converged,
                                  make_policy)
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import TrainConfig, make_train_step
    from repro_torch.sync import DeltaSyncPod, TopKCompressor

    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    cfg = spec.model_config(conf)
    init_params = weights.make_params(conf, run.seed, dev)
    ocfg = AdamWConfig(**mix["optimizer"])
    step_fn = make_train_step(cfg, TrainConfig(optimizer=ocfg))
    checked = Checked(conf, run.seed, dev, mix["checked_steps"], ocfg.b1)
    K = mix["local_steps"]
    bad_steps = [0]

    def local_update(params, round_idx, pod_id):
        rank = int(pod_id[len("pod"):])
        opt = init_opt_state(params)
        p = params
        for k in range(K):
            batch = data.train_batch(run.seed, rank, round_idx * K + k,
                                     mix["batch"], mix["seq"],
                                     conf["vocab"], dev)
            with run.spans.span("local_step"):
                p, opt, metrics = step_fn(p, opt, batch)
                loss = float(metrics["loss"])
            bad_steps[0] += int(not math.isfinite(loss))
            if rank == 0 and round_idx == 0:
                checked.after_step(k + 1, loss, opt)
        return p

    sim = Simulator(NetConfig(loss=mix["net"]["loss"], dup=mix["net"]["dup"],
                              seed=run.seed))
    ids = [f"pod{n}" for n in range(mix["pods"])]
    pods = [sim.add_node(DeltaSyncPod(
        i, [j for j in ids if j != i], init_params, local_update,
        num_pods=len(ids), compressor=TopKCompressor(mix["topk"]),
        rng=random.Random(run.seed + n),
        policy=make_policy(mix["ship_policy"])))
        for n, i in enumerate(ids)]
    for pod in pods:
        sim.every(mix["gossip_interval"], pod.on_periodic)

    def one_round() -> None:
        with run.spans.span("round"):
            for pod in pods:
                with run.spans.span("pod_round"):
                    pod.do_round()
            with run.spans.span("gossip"):
                sim.run_for(mix["gossip_between_rounds"])

    one_round()
    run.end_setup()
    if run.trace:
        with Profiled(run.spans) as prof:
            for _ in range(mix["trace_rounds"]):
                one_round()
        run.trace_summary = prof.summary
    while time.perf_counter() < run.window[1]:
        one_round()
    run.failed = bad_steps[0]
    run.read_memory()
    run.attempted = window_facts(run, "round", len(pods) * K, "local_step")

    waited = 0.0
    while not converged(pods) and waited < CONVERGE_SIM_S:
        sim.run_for(mix["gossip_interval"])
        waited += mix["gossip_interval"]
    run.numbers["outer_split"] = float(_pods_differ(pods)
                                       + int(not converged(pods)))
    run.numbers["topk_misses"] = float(topk_misses(pods, mix["topk"]))
    run.numbers["outer_gap"] = outer_gap(run, pods)
    del pods, sim, init_params, step_fn
    run.free()
    judge_steps(run, checked, rank=0)
