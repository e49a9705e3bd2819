"""Driver ``train``: one replica's AdamW steps back to back.

Set-up builds the train step with its model and optimizer state and
drives it through the first ``checked_steps`` steps of the stream (the
warm-up), recording each step's loss, each leaf's norm of the first
step's clipped gradient (from the first moment after one step) and its
values at entries drawn from the seed, and each
leaf's norm of the change of the master weights after the last checked
step. The same object then trains through the window. After it, the
reference follows the checked steps from the same weights and batches.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict

from .. import data, judge, reference, spec, weights, yardstick
from ..harness import Run
from ..tracing import Profiled


class Checked:
    """What the program's first steps produced, leaf by leaf."""

    def __init__(self, conf: Dict, seed: int, device, steps: int, b1: float):
        self.conf, self.seed, self.device = conf, seed, device
        self.steps, self.b1 = steps, b1
        self.record: Dict[str, Any] = {"losses": [], "grad_norms": None,
                                       "grad_samples": None,
                                       "update_norms": None}

    def after_step(self, k: int, loss: float, opt_state: Dict) -> None:
        """Step ``k`` (1-based) of the checked run has finished."""
        if k > self.steps:
            return
        self.record["losses"].append(loss)
        paths = list(weights.leaf_paths(self.conf))
        if k == 1:
            norms, samples = {}, {}
            for p in paths:
                g = weights.get(opt_state["m"], p).float() / (1.0 - self.b1)
                norms[p] = float(g.norm())
                idx = weights.sample_index(self.seed, p, g.numel(),
                                           self.device)
                samples[p] = g.reshape(-1)[idx].cpu()
            self.record["grad_norms"] = norms
            self.record["grad_samples"] = samples
        if k == self.steps:
            norms = {}
            for p in paths:
                init = weights.initial_leaf(self.conf, self.seed, p,
                                            self.device)
                norms[p] = float((weights.get(opt_state["master"], p)
                                  - init).norm())
            self.record["update_norms"] = norms


def check_batches(run: Run, rank: int) -> list:
    conf, mix = run.cell.conf, run.cell.mix
    return [data.train_batch(run.seed, rank, k, mix["batch"], mix["seq"],
                             conf["vocab"], run.device)
            for k in range(mix["checked_steps"])]


def judge_steps(run: Run, checked: Checked, rank: int) -> None:
    """Run the reference over the checked steps and record the numbers."""
    ref = reference.train_steps(run.cell.conf, run.seed,
                                check_batches(run, rank),
                                run.cell.mix["optimizer"])
    run.numbers.update(judge.train_numbers(checked.record, ref))


def window_facts(run: Run, unit: str, steps_per_unit: int,
                 step_span: str) -> int:
    """The end-to-end rate, and what the per-layer readers take: every
    ``unit`` span (a step, or a round of steps) that started in the window
    runs to its end, and the rate is their tokens over the time from the
    window's start to the last one's end (a step takes 2-3 s on an H100:
    steps that ended inside 40 s would count in whole steps, 7% apart). Returns the
    steps that started."""
    mix, conf = run.cell.mix, run.cell.conf
    start, end = run.window
    started = [b for a, b in run.spans.by_name.get(unit, ())
               if start <= a < end]
    if not started:
        return 0
    took = max(started) - start
    steps = len(started) * steps_per_unit
    run.end_to_end["train_tokens_per_s"] = (steps * mix["batch"]
                                            * mix["seq"] / took)
    run.facts["train_flops"] = steps * yardstick.train_step_flops(
        conf, mix["batch"], mix["seq"])
    run.facts["train_s"] = took
    run.facts["step_span"] = step_span
    return steps


def run(run: Run) -> None:
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import TrainConfig, make_train_step

    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    cfg = spec.model_config(conf)
    params = weights.make_params(conf, run.seed, dev)
    opt_state = init_opt_state(params)
    ocfg = AdamWConfig(**mix["optimizer"])
    step_fn = make_train_step(cfg, TrainConfig(optimizer=ocfg))
    checked = Checked(conf, run.seed, dev, mix["checked_steps"], ocfg.b1)
    step = 0
    bad = 0

    def one_step() -> float:
        nonlocal params, opt_state, step, bad
        batch = data.train_batch(run.seed, 0, step, mix["batch"],
                                 mix["seq"], conf["vocab"], dev)
        with run.spans.span("train_step"):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
        step += 1
        bad += int(not math.isfinite(loss))
        return loss

    for k in range(1, mix["checked_steps"] + 1):
        checked.after_step(k, one_step(), opt_state)
    run.end_setup()
    if run.trace:
        with Profiled(run.spans) as prof:
            for _ in range(mix["trace_steps"]):
                one_step()
        run.trace_summary = prof.summary
    while time.perf_counter() < run.window[1]:
        one_step()
    run.failed = bad
    run.read_memory()
    run.attempted = window_facts(run, "train_step", 1, "train_step")
    del params, opt_state, step_fn
    run.free()
    judge_steps(run, checked, rank=0)
