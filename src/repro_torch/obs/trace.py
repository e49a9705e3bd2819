"""Structured trace bus: typed, timestamped events from every layer.

The paper's claims are *trajectory* claims — a δ-mutator's state reaches
every replica through some sequence of ships, joins, acks, and digest
exchanges — but until now that trajectory was only visible as aggregate
counters. The :class:`Tracer` records it as a stream of typed events:

====================  ========================================================
kind                  emitted when
====================  ========================================================
``write``             a local δ-mutation entered the delta buffer
                      (``Replica.operation``; fields: ``keys``, ``tag``)
``delta_ship``        a delta/state payload left for ``dst``
                      (fields: ``dst``, ``bytes``, ``full``, ``keys``,
                      causal ``tag``)
``delta_join``        a received payload was folded in (fields: ``src``,
                      ``via`` ∈ delta/handoff/digest-resp, ``bytes``,
                      ``keys`` = the keys that actually *changed state*;
                      empty ⇒ the payload was redundant)
``ack``               a cumulative ack arrived back at the sender
                      (fields: ``src``, ``tag``, ``stale``)
``digest_req``        a pull-round digest request shipped (``dst``, ``bytes``)
``digest_resp``       a digest response shipped (``dst``, ``bytes``)
``handoff``           a rebalance handoff shipped (``dst``, ``bytes``,
                      ``keys``)
``reap_propose``      the reaper proposed a tombstone to one member
``reap_ack``          a reap vote arrived (``src``, ``key``, ``ok``)
``reap_commit``       a fully-acked tombstone committed (``key``, ``epoch``)
``gc_horizon_advance``  delta-buffer entries left the buffer
                      (``horizon``, ``dropped``, ``depth``)
``queue_drop``        a bounded per-peer send queue shed old frames
                      (``dst``, ``dropped``)
``kernel_launch``     a kernel wrapper dispatched (``op``, ``h2d_bytes``;
                      via :func:`trace_kernel_launches`)
``span``              a program span ended (:func:`span`; fields: ``name``,
                      ``id``, ``parent``, ``root``, ``root_name``, host
                      ``t0`` and ``t1``, the CUDA ``events`` pair or
                      ``None``, and the site's own fields)
``count``             a program counter moved (:func:`count`; fields:
                      ``name`` and ``n``, a host number or a device
                      tensor)
====================  ========================================================

Every event also carries ``t`` (the tracer's clock), ``seq`` (a per-tracer
monotone index — total order of this node's events even under clock
ties), ``node``, and — for engine events — ``round`` (the replica's
anti-entropy round counter, the *logical* clock that makes a simulator
trace and a socket trace of the same schedule comparable).

**Deterministic-clock mode.** The tracer never calls ``time`` itself:
``clock`` is injected. Attach ``clock=lambda: sim.time`` and a simulated
run's trace is bit-reproducible; a socket run uses ``time.monotonic``.
Cross-run comparison never relies on absolute times — the analyzer's
semantic view (``repro_torch.obs.analyze.semantic_trace``) orders by per-node
``seq``/``round``, which both clocks agree on.

**Cost model.** A disabled tracer is one ``is None`` test per site. An
enabled tracer at the default ``sample=1.0`` builds one small dict per
event into a bounded ring buffer (``deque(maxlen=capacity)``) —
``bench_obs`` asserts the UDP load generator's throughput stays within
10% of the untraced run. ``sample < 1.0`` keeps a random fraction
(seeded — reproducible), trading analyzer completeness for overhead:
anomaly detection (``analyze.anomalies``) needs the full stream, so run
it at 1.0.

The JSONL sink mirrors every kept event to a file as it is emitted, one
JSON object per line — the interchange format ``analyze.load_trace``
reads back.

**Program spans and counters.** :func:`span` (a context manager) and
:func:`spanned` (its decorator form) time a piece of the program's own
work, and :func:`count` adds to a named counter; both record into one
process-wide tracer (:func:`program_tracer`, on ``time.perf_counter``,
the benchmark's clock). They record only while ``torch.profiler`` is
recording (``torch.autograd.profiler._is_profiler_enabled``, a module
global): with the profiler off a site costs that one flag test, and a
profiled slice turns every site on without any edit to its caller.
Under the profiler a span costs tens of microseconds of host time,
most of it its two CUDA events (52–62 µs a span on an H100 machine,
35–42 µs of it the events), so a profiled step with many spans runs
slower and idles more than one without. A
span holds its ``name``, host ``t0``/``t1``, its ``parent`` span's id
and its ``root``: the id of the outermost span around it (``prefill``,
``decode_step``, ``train_step`` or ``pod.round``), so that the spans of
one call share it. Each span also enters
``record_function("repro_torch.<name>")``, so it lands in the profiler's
chrome trace on the profiler's clock beside the kernels; and once CUDA
is initialised, it records a pair of timing events on the current
stream, read only by :func:`spans` (one synchronize there, none inside a
span). ``within=(names...)`` keeps a site to the calls whose outermost
open span has one of those names (the MoE's sites keep to the serve
steps: under ``checkpoint`` a training forward runs twice, and its spans
would fire twice). ``memory=True`` adds the step's
differences of the caching allocator's retries, device allocations and
frees (CUDA only). A counter's ``n`` is a host number or a device
tensor, kept as given (no sync) and summed by :func:`spans`.
:func:`clear` empties the record.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.autograd.profiler as _profiler

EVENT_KINDS = frozenset({
    "write", "delta_ship", "delta_join", "ack",
    "digest_req", "digest_resp", "handoff",
    "reap_propose", "reap_ack", "reap_commit",
    "gc_horizon_advance", "queue_drop", "kernel_launch",
    "span", "count",
})


class Tracer:
    """Bounded, sampled, optionally file-backed event recorder.

    One tracer per traced node (its ``node`` tag names the emitter);
    assign it to ``Replica.tracer`` / pass it to ``GossipNode`` and the
    instrumented layers feed it. ``clock`` is injected for determinism
    (see module docstring); ``sink`` is a path or open text file that
    receives each event as a JSON line.
    """

    __slots__ = ("node", "clock", "sample", "_rng", "_buf", "_sink",
                 "_owns_sink", "_seq", "dropped")

    def __init__(self, node: str = "", *,
                 clock: Optional[Callable[[], float]] = None,
                 capacity: int = 65536,
                 sink: Any = None,
                 sample: float = 1.0,
                 seed: int = 0):
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample!r}")
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity!r}")
        self.node = node
        if clock is None:
            clock = time.monotonic
        self.clock = clock
        self.sample = sample
        self._rng = random.Random(seed)
        self._buf: deque = deque(maxlen=capacity)
        self._owns_sink = isinstance(sink, (str, bytes))
        self._sink = open(sink, "w") if self._owns_sink else sink
        self._seq = 0
        self.dropped = 0     # events sampled out (not ring-buffer evictions)

    # -- emit -----------------------------------------------------------------
    def emit(self, kind: str, **fields: Any) -> None:
        """Record one event. Unknown kinds raise — the taxonomy is the
        contract the analyzer parses, so a typo'd kind must fail loudly
        at the emit site, not silently skew a report."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown trace event kind {kind!r}")
        if self.sample < 1.0 and self._rng.random() >= self.sample:
            self.dropped += 1
            return
        ev: Dict[str, Any] = {"t": self.clock(), "seq": self._seq,
                              "node": self.node, "kind": kind}
        ev.update(fields)
        self._seq += 1
        self._buf.append(ev)
        if self._sink is not None:
            self._sink.write(json.dumps(ev, separators=(",", ":")))
            self._sink.write("\n")

    # -- read back -------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """The retained events, oldest first (the ring buffer keeps the
        newest ``capacity``)."""
        return list(self._buf)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self._buf:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def clear(self) -> None:
        self._buf.clear()

    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            if self._owns_sink:
                self._sink.close()
            self._sink = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def merge_events(*sources: Any) -> List[Dict[str, Any]]:
    """Combine per-node traces (tracers or event lists) into one stream
    ordered by ``(t, node, seq)`` — what the analyzer consumes for a
    whole-cluster view. Per-node ``seq`` order is preserved even when
    clocks tie (a simulator applies a whole schedule at t=0)."""
    events: List[Dict[str, Any]] = []
    for s in sources:
        events.extend(s.events() if hasattr(s, "events") else s)
    return sorted(events, key=lambda e: (e.get("t", 0.0),
                                         e.get("node", ""),
                                         e.get("seq", 0)))


def trace_kernel_launches(tracer: Tracer) -> Callable[[], None]:
    """Install ``tracer`` as the process-wide kernel-launch hook: every
    ``kernels.ops`` wrapper dispatch emits a ``kernel_launch`` event
    (op name + host→device bytes staged). Returns an uninstall callable
    — the hook is global (the counters it mirrors are process-wide), so
    callers must remove it when their scope ends."""
    from ..kernels import ops

    def hook(op: str, h2d_bytes: int) -> None:
        tracer.emit("kernel_launch", op=op, h2d_bytes=h2d_bytes)

    ops.set_launch_hook(hook)
    return lambda: ops.set_launch_hook(None)


# ---------------------------------------------------------------------------
# Program spans and counters (module docstring, "Program spans and counters")
# ---------------------------------------------------------------------------

# a ``memory=True`` span's fields: its differences of these
# ``torch.cuda.memory_stats()`` keys
ALLOC_STATS = {"alloc_retries": "num_alloc_retries",
               "device_allocs": "num_device_alloc",
               "device_frees": "num_device_free"}

_program: Optional[Tracer] = None
_local = threading.local()            # each thread's stack of open spans
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


def program_tracer() -> Tracer:
    """The process-wide tracer that spans and counters record into."""
    global _program
    if _program is None:
        _program = Tracer("program", clock=time.perf_counter)
    return _program


def _open_spans() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def recording(within: Optional[Sequence[str]] = None) -> bool:
    """Whether a site records now: ``torch.profiler`` is recording and,
    with ``within``, the outermost open span has one of those names."""
    if not _profiler._is_profiler_enabled:
        return False
    if within is None:
        return True
    stack = _open_spans()
    return bool(stack) and stack[0].name in within


def _alloc_stats() -> Optional[Dict[str, int]]:
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(v, 0)) for k, v in ALLOC_STATS.items()}


class _Span:
    __slots__ = ("name", "memory", "fields", "id", "parent", "root",
                 "root_name", "t0", "_rf", "_start", "_mem")

    def __init__(self, name: str, memory: bool, fields: Dict[str, Any]):
        self.name, self.memory, self.fields = name, memory, fields

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        outer = stack[0] if stack else self
        self.root, self.root_name = outer.id, outer.name
        stack.append(self)
        self._rf = _profiler.record_function(f"repro_torch.{self.name}")
        self._rf.__enter__()
        self._start = None
        if torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._mem = _alloc_stats() if self.memory else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        t1 = time.perf_counter()
        fields = dict(self.fields)
        if self._mem is not None:
            after = _alloc_stats()
            fields.update({k: after[k] - self._mem[k] for k in after})
        events = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self._start, end)
        self._rf.__exit__(None, None, None)
        _open_spans().pop()
        program_tracer().emit("span", name=self.name, id=self.id,
                              parent=self.parent, root=self.root,
                              root_name=self.root_name, t0=self.t0, t1=t1,
                              events=events, **fields)


def span(name: str, *, within: Optional[Sequence[str]] = None,
         memory: bool = False, **fields: Any):
    """A context manager that records ``name``'s span while the profiler
    records (and, with ``within``, under one of those roots); otherwise
    a shared no-op."""
    if not recording(within):
        return _OFF
    return _Span(name, memory, fields)


def spanned(name: str, *, within: Optional[Sequence[str]] = None,
            memory: bool = False) -> Callable:
    """Decorator: each call of the function is one :func:`span`."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def traced(*args: Any, **kwargs: Any) -> Any:
            if not recording(within):
                return fn(*args, **kwargs)
            with _Span(name, memory, {}):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: Any) -> None:
    """Add ``n`` (a host number, or a device tensor kept as it is: no
    sync) to the counter ``name`` while the profiler records."""
    if recording():
        program_tracer().emit("count", name=name, n=n)


def spans() -> Dict[str, Any]:
    """What the program recorded, oldest first: ``{"spans": [...],
    "counts": {...}}``. Each span is its event's fields, with ``host_s``
    (``t1 - t0``) and ``stream_s`` (its CUDA events' elapsed time, after
    one synchronize; ``None`` without them) in place of the events; each
    counter is its ``n`` summed, as a host number."""
    events = _program.events() if _program is not None else []
    if any(e["kind"] == "span" and e["events"] is not None for e in events):
        torch.cuda.synchronize()
    out: List[Dict[str, Any]] = []
    totals: Dict[str, Any] = {}
    for e in events:
        if e["kind"] == "count":
            totals[e["name"]] = totals.get(e["name"], 0) + e["n"]
            continue
        s = {k: v for k, v in e.items()
             if k not in ("t", "seq", "node", "kind", "events")}
        s["host_s"] = e["t1"] - e["t0"]
        ev = e["events"]
        s["stream_s"] = (ev[0].elapsed_time(ev[1]) * 1e-3
                         if ev is not None else None)
        out.append(s)
    counts = {k: v.item() if isinstance(v, torch.Tensor) else v
              for k, v in totals.items()}
    return {"spans": out, "counts": counts}


def clear() -> None:
    """Forget every recorded span and counter."""
    if _program is not None:
        _program.clear()
