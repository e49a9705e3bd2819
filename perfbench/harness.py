"""One run of one cell: what the drivers fill in, and the result line.

A driver (``perfbench/drivers/<driver>.py``, named by the traffic mix)
sets the cell up, marks the end of set-up, drives the program for the
window, reads the peak memory, frees the program's state and hands the
reference what it needs; :func:`finish` then reads the per-layer metrics
(traced runs), holds every compared number to its limit and builds the
result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

from . import spec as spec_mod
from .spec import Cell
from .tracing import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                                  # the process's start
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: Optional[float] = None
    window: Optional[tuple] = None             # (start, end), host clock
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace_summary: Optional[dict] = None
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0

    def synchronize(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def end_setup(self) -> float:
        """Set-up ends here; the window starts."""
        self.synchronize()
        now = time.perf_counter()
        self.setup_s = now - self.t0
        self.window = (now, now + self.seconds)
        return now

    def read_memory(self) -> None:
        if self.device != "cpu":
            import torch
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()


def driver(cell: Cell):
    return importlib.import_module(f"perfbench.drivers.{cell.mix['driver']}")


def execute(run: Run) -> None:
    driver(run.cell).run(run)


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """Modules (by default the loaded ones) whose top-level name, compared
    whole, is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def finish(run: Run) -> Dict[str, Any]:
    """The result object of a finished run (``metrics`` are the end-to-end
    ones, or with ``trace`` the per-layer ones)."""
    cell = run.cell
    metrics: Dict[str, Dict[str, Any]] = {}
    if run.trace:
        for m in cell.per_layer:
            value = spec_mod.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = run.setup_s
            else:
                value = run.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    correct = run.attempted > 0 and run.failed == 0
    for name, limit in cell.limits.items():
        value = run.numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    device = {"platform": "gpu" if run.device != "cpu" else "cpu",
              "kind": _device_kind(run.device), "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": run.attempted,
                           "failed": run.failed, "metrics": metrics,
                           "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        out["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                            "idle_gaps": run.trace_summary["idle_gaps"]}
    out["checks"] = checks
    return out


def _device_kind(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)
