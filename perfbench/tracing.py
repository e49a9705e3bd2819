"""Spans from the benchmark's own calls, and the device trace of a slice.

Spans are host-clock intervals around the calls the benchmark makes into
the program (each ends in a synchronise where its name says the work is
done). With ``--trace 1`` a fixed slice of the window runs under
``torch.profiler``; :func:`read_trace` turns its trace into the busy
time, the kernels by name and the longest idle gaps, each gap named by
the benchmark's span it falls in.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from .spec import ROOT

TRACE_FILE = ROOT / "build" / "perfbench" / "trace.json"
SLICE = "pb:slice"


class Spans:
    """Named host-clock intervals, kept in memory."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._labels = False

    def label_for_profiler(self, on: bool) -> None:
        self._labels = on

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        rf = None
        if self._labels:
            from torch.profiler import record_function
            rf = record_function(f"pb:{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.by_name[name].append((t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations(self, name: str, start: float = float("-inf"),
                  end: float = float("inf")) -> List[float]:
        """Durations (s) of the spans of ``name`` that ended in
        [start, end]."""
        return [b - a for a, b in self.by_name.get(name, ())
                if start <= b <= end]


class Profiled:
    """``torch.profiler`` around one slice of the window."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.summary: Optional[dict] = None
        self._prof = None
        self._rf = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.spans.label_for_profiler(True)
        self._rf = record_function(SLICE)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self.spans.label_for_profiler(False)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(TRACE_FILE))
            try:
                self.summary = read_trace(TRACE_FILE)
            finally:
                TRACE_FILE.unlink(missing_ok=True)
        return False


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_trace(path: Path) -> dict:
    """Busy seconds, slice seconds, kernel seconds by name, and the ten
    longest idle gaps (named by the innermost benchmark span around
    each) of a chrome trace holding one ``pb:slice``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("pb:")]
    slices = [e for e in notes if e["name"] == SLICE]
    if not slices:
        raise RuntimeError("the trace holds no benchmark slice")
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the device")
    s0 = float(slices[0]["ts"])
    s1 = s0 + float(slices[0]["dur"])
    by_name: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    iv = []
    for e in kernels:
        a = float(e["ts"])
        b = a + float(e["dur"])
        by_name[e["name"]] += float(e["dur"]) * 1e-6
        counts[e["name"]] += 1
        iv.append((max(a, s0), min(b, s1)))
    busy = _merge([(a, b) for a, b in iv if b > a])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][3:]) for e in notes if e["name"] != SLICE),
                   key=lambda t: t[1] - t[0])
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        mid = (a + b) / 2
        label = next((n for x, y, n in spans if x <= mid <= y), "host")
        gaps.append((label, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": (s1 - s0) * 1e-6,
            "kernel_s": dict(by_name), "kernel_n": dict(counts),
            "device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def kernel_seconds(summary: dict, needle: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``needle``."""
    s = sum(v for k, v in summary["kernel_s"].items() if needle in k)
    n = sum(v for k, v in summary["kernel_n"].items() if needle in k)
    return s, n
