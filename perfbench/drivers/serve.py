"""Driver ``serve``: a closed loop of batches of greedy requests.

Each batch is the next prompt length of the mix's cycle and ``batch``
prompts of tokens drawn from the seed; ``models.prefill``
runs the prompts, then ``models.decode_step`` runs one token a step
through the ring caches, every step's tokens copied to the host as a
server streams them. Set-up warms each prompt length (a prefill and two
decode steps). A batch started in the window runs to its end; tokens
count where they reached the host inside the window. After the window
the reference scores the served tokens of ``check_batches`` finished
batches (the longest prompt among them, the rest drawn from the seed).
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

from .. import data, judge, reference, spec, weights, yardstick
from ..harness import Run
from ..tracing import Profiled


class Batch:
    def __init__(self, index: int, s: int):
        self.index, self.s = index, s
        self.start = 0.0
        self.times: List[float] = []       # each step's tokens on the host
        self.served = None                 # [B, gen] on the device
        self.traced_steps = 0


def run(run: Run) -> None:
    import torch
    from repro_torch.models import decode_step, prefill

    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    cfg = spec.model_config(conf)
    params = weights.make_params(conf, run.seed, dev)
    B, G = mix["batch"], mix["gen"]

    def serve(index: int, s: int, steps: int,
              profiled: Optional[Profiled] = None, traced: int = 0) -> Batch:
        rec = Batch(index, s)
        tok = data.prompt(run.seed, index, B, s, conf["vocab"], dev)
        out = []
        with torch.no_grad():
            if profiled is not None:
                profiled.__enter__()
            rec.start = time.perf_counter()
            with run.spans.span("prefill"):
                logits, caches = prefill(cfg, params, {"tokens": tok},
                                         max_len=s + G)
                nxt = logits[:, -1].argmax(-1)
                nxt.cpu()
            rec.times.append(time.perf_counter())
            out.append(nxt)
            for i in range(steps - 1):
                pos = torch.full((B, 1), s + i, dtype=torch.int32,
                                 device=dev)
                with run.spans.span("decode_step"):
                    logits, caches = decode_step(cfg, params, nxt[:, None],
                                                 pos, caches)
                    nxt = logits[:, -1].argmax(-1)
                    nxt.cpu()
                rec.times.append(time.perf_counter())
                out.append(nxt)
                if profiled is not None and i + 1 == traced:
                    profiled.__exit__(None, None, None)
                    rec.traced_steps = traced
                    profiled = None
            if profiled is not None:
                profiled.__exit__(None, None, None)
                rec.traced_steps = steps - 1
        rec.served = torch.stack(out, dim=1)
        return rec

    for k, s in enumerate(mix["prompt_lengths"]):
        serve(-1 - k, s, 3)
    schedule = data.prompt_lengths(mix["prompt_lengths"])
    run.end_setup()
    end = run.window[1]
    batches: List[Batch] = []
    traced: Optional[Batch] = None
    while time.perf_counter() < end:
        s = next(schedule)
        if run.trace and traced is None:
            prof = Profiled(run.spans)
            traced = serve(len(batches), s, G, prof,
                           mix["trace_decode_steps"])
            run.trace_summary = prof.summary
            batches.append(traced)
            continue
        batches.append(serve(len(batches), s, G))
    run.read_memory()
    window_facts(run, batches, traced)
    run.attempted = B * len(batches)
    run.failed = B * sum(1 for b in batches if len(b.times) != G)

    rng = random.Random(run.seed)
    finished = [b for b in batches if len(b.times) == G]
    longest = max(finished, key=lambda b: (b.s, -b.index))
    rest = [b for b in finished if b is not longest]
    picked = [longest] + rng.sample(rest, min(len(rest),
                                              mix["check_batches"] - 1))
    kept = [(b.index, b.s, b.served) for b in picked]
    del params, batches, traced, finished, rest, picked
    run.free()
    gaps = []
    for index, s, served in kept:
        tok = data.prompt(run.seed, index, B, s, conf["vocab"], dev)
        full = torch.cat([tok, served[:, :-1]], dim=1)
        logits = reference.serve_logits(conf, run.seed, full, s)
        gaps.append(judge.served_gaps(logits, served))
        del logits
    run.numbers.update(judge.serve_numbers(torch.cat(gaps)))


def window_facts(run: Run, batches: List[Batch],
                 traced: Optional[Batch]) -> None:
    conf, mix = run.cell.conf, run.cell.mix
    B, G = mix["batch"], mix["gen"]
    start, end = run.window
    tokens = 0
    flops = 0.0
    ttft: List[float] = []
    gaps: List[float] = []
    for b in batches:
        if start <= b.start <= end:
            ttft += [(b.times[0] - b.start) * 1e3] * B
        for i, t in enumerate(b.times):
            if t > end:
                break
            tokens += B
            flops += (yardstick.prefill_flops(conf, B, b.s) if i == 0 else
                      yardstick.decode_flops(conf, B, b.s + i - 1))
            if i > 0:
                gaps.append((t - b.times[i - 1]) * 1e3)
    run.end_to_end["serve_tokens_per_s"] = tokens / run.seconds
    if ttft:
        run.end_to_end["ttft_ms_p90"] = yardstick.percentile(ttft, 90)
    run.facts["serve_flops"] = flops
    run.facts["tpot_ms"] = gaps
    if traced is not None:
        run.facts["flash_bounds"] = flash_bounds(conf, B, G, traced)


def flash_bounds(conf: Dict, B: int, G: int, b: Batch) -> Dict[str, Any]:
    """The least device time of the flash calls in the traced slice: one
    prefill call per layer, then one decode call per layer a step."""
    H, KV, hd, L = (conf["n_heads"], conf["n_kv_heads"], conf["head_dim"],
                    conf["n_layers"])
    w = conf.get("window")
    prefill_s = L * yardstick.roofline_s(*yardstick.flash_prefill_cost(
        B, H, KV, b.s, hd, w))
    C = b.s + G if w is None else min(w, b.s + G)
    decode_s = 0.0
    for i in range(b.traced_steps):
        pos = b.s + i
        valid = min(pos + 1, C) if w is None else min(pos + 1, C, w)
        decode_s += L * yardstick.roofline_s(*yardstick.flash_decode_cost(
            B, H, KV, C, hd, valid))
    return {"prefill_s": prefill_s, "decode_s": decode_s}
