"""The cells at the port's REDUCED sizes, for rehearsals on the CPU.

Each takes the real configuration and traffic files and changes only
sizes (layers, widths, vocabulary, batch, lengths) and the precision, to
float32, where the program agrees with the reference to a few units of
the last place: sound REDUCED runs read under 1e-5 on every compared
number. So the rehearsals hold the numbers to limits of their own,
``LIMITS``, well above that and below what a fault or the float8 control
reads at these sizes; the cells' limits, set from bfloat16 runs at full
width on the card, are in ``perfbench/limits/``. The command itself
refuses to run without a card, so the tests call the harness's functions
with these cells.
"""

from __future__ import annotations

import json
from typing import Dict

from .spec import HERE, Cell, load_cell

SIZES: Dict[str, Dict] = {
    "stablelm-1.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab=97, dtype="float32"),
    "mixtral-8x22b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=97,
                          moe={"num_experts": 4, "top_k": 2,
                               "expert_d_ff": 128, "capacity_factor": 1.25},
                          dtype="float32"),
}

TRAFFIC: Dict[str, Dict] = {
    "localsgd": dict(batch=2, seq=16, topk=0.1),
    "sync": dict(batch=2, seq=16),
    "decode": dict(batch=3, prompt_lengths=[8, 24], gen=6, check_batches=2),
    "prefill": dict(batch=2, prompt_lengths=[20, 36], gen=6,
                    check_batches=2),
}


LIMITS: Dict[str, Dict[str, float]] = {
    "localsgd": dict(grad_gap=1e-3, grad_sample_gap=1e-3, update_gap=1e-3,
                     outer_split=0, topk_misses=0, outer_gap=1e-3),
    "sync": dict(grad_gap=1e-3, grad_sample_gap=1e-3, update_gap=1e-3),
    "decode": dict(gap_mean=1e-3, gap_request_median_max=1e-3),
    # the cell compares only the per-request median; at these sizes the
    # float8 control leaves most tokens on the best, so the mean is held too
    "prefill": dict(gap_mean=1e-3, gap_request_median_max=1e-3),
}


def cell(workload: str) -> Cell:
    """``workload`` of ``BENCHMARK.json`` at its REDUCED sizes."""
    full = load_cell(workload)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    conf = dict(full.conf, **SIZES[w["config"]])
    mix = dict(full.mix, **TRAFFIC[w["traffic"]])
    return Cell(name=workload, chips=1, conf=conf, mix=mix,
                limits=LIMITS[w["traffic"]], end_to_end=full.end_to_end,
                per_layer=full.per_layer)
