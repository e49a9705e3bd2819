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
"""

from __future__ import annotations

import json
import random
from collections import deque
from typing import Any, Callable, Dict, List, Optional

EVENT_KINDS = frozenset({
    "write", "delta_ship", "delta_join", "ack",
    "digest_req", "digest_resp", "handoff",
    "reap_propose", "reap_ack", "reap_commit",
    "gc_horizon_advance", "queue_drop", "kernel_launch",
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
            import time
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
