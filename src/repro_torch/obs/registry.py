"""Metrics registry: one home for every counter the nine layers grew.

The runtime already *counts* everything that matters — ``sim.NetStats``
counts sent frames, ``net.stats.LinkStats`` adds the receive side,
``kernels.ops.KernelCounters`` counts launches and staging bytes — but
each in its own shape, none scrapeable. The registry does not replace
those objects (their attribute APIs are load-bearing at hundreds of call
sites); it **absorbs** them: an absorber registers a collector that
reads the live stats object at scrape time and publishes its fields as
labelled metric families. Call sites keep incrementing plain attributes;
the registry sees the current value whenever someone looks.

Three family types, Prometheus-shaped:

* :class:`Counter` — monotone totals. ``inc()`` for native counts, or
  ``set_total()`` for absorbed sources that already accumulate.
* :class:`Gauge` — point-in-time values; ``set()``/``inc()``/``dec()``,
  or ``set_function(fn)`` for values computed at collect time.
* :class:`Histogram` — fixed buckets + sum/count; ``observe()`` and an
  ``approx_quantile`` for the bench tables.

Families carry label *names*; children (one per label-value tuple) carry
the numbers. Dynamic label sets — per-peer, per-kind, per-link-class —
come from **collectors**: callables registered via
:meth:`Registry.add_collector` that run at the top of every
``snapshot()`` / ``render_prometheus()`` and write whatever children the
live objects currently imply.

The registry also hosts the δ-CRDT metrics lattice
(:class:`MetricRecord` / :class:`MetricsState` / :class:`Metrics`, moved
here from ``sync/metrics.py`` — that module is now a re-export shim):
local process counters and replicated duplicate-safe aggregates are two
views of the same observability layer, and :meth:`Registry.absorb_crdt_metrics`
bridges them (each replicated metric's cluster-wide aggregates surface
as gauges).
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.crdts import DeltaCRDT
from ..core.dots import ReplicaId

# ---------------------------------------------------------------------------
# Metric families
# ---------------------------------------------------------------------------

_RESERVED = {"le"}      # histogram bucket label


def _check_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


class _Family:
    """Shared labelled-children machinery for the three metric types."""

    typ = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        bad = _RESERVED & set(labelnames)
        if bad:
            raise ValueError(f"reserved label name(s) {sorted(bad)}")
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], Any] = {}

    def labels(self, *values: Any, **kv: Any):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make_child()
        return child

    def _make_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [(n, v) for n, v in zip(self.labelnames, key)] + list(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{n}="{_escape(v)}"' for n, v in pairs)
        return "{" + inner + "}"

    def clear(self) -> None:
        self._children.clear()

    # a label-less family proxies child methods through a default child
    def _default(self):
        return self.labels()


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def set_total(self, total: float) -> None:
        """Install an externally-accumulated monotone total (absorbers:
        the source object — NetStats etc. — is the accumulator; the
        child just mirrors it at collect time)."""
        self.value = float(total)


class Counter(_Family):
    typ = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set_total(self, total: float) -> None:
        self._default().set_total(total)

    @property
    def value(self) -> float:
        return self._default().value

    def render(self, out: List[str]) -> None:
        for key, child in sorted(self._children.items()):
            out.append(f"{self.name}{self._label_str(key)} "
                       f"{_fmt(child.value)}")

    def sample(self) -> Any:
        if not self.labelnames:
            return self._default().value
        return {",".join(k): c.value for k, c in sorted(self._children.items())}


class _GaugeChild:
    __slots__ = ("_value", "fn")

    def __init__(self):
        self._value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self.fn = None
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        self.fn = fn

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


class Gauge(_Family):
    typ = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value

    def render(self, out: List[str]) -> None:
        for key, child in sorted(self._children.items()):
            out.append(f"{self.name}{self._label_str(key)} "
                       f"{_fmt(child.value)}")

    def sample(self) -> Any:
        if not self.labelnames:
            return self._default().value
        return {",".join(k): c.value for k, c in sorted(self._children.items())}


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)     # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.buckets):
            self.counts[i] += 1

    def approx_quantile(self, q: float) -> float:
        """Bucket-boundary quantile estimate (upper bound of the bucket
        the q-th observation falls in; +Inf tail returns the largest
        finite bound). NaN with no observations."""
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        seen = 0
        for ub, c in zip(self.buckets, self.counts):
            seen += c
            if seen >= rank:
                return ub
        return self.buckets[-1] if self.buckets else float("nan")


class Histogram(_Family):
    typ = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def approx_quantile(self, q: float) -> float:
        return self._default().approx_quantile(q)

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def render(self, out: List[str]) -> None:
        for key, child in sorted(self._children.items()):
            cum = 0
            for ub, c in zip(child.buckets, child.counts):
                cum += c
                out.append(f"{self.name}_bucket"
                           f"{self._label_str(key, (('le', _fmt(ub)),))} "
                           f"{cum}")
            out.append(f"{self.name}_bucket"
                       f"{self._label_str(key, (('le', '+Inf'),))} "
                       f"{child.count}")
            out.append(f"{self.name}_sum{self._label_str(key)} "
                       f"{_fmt(child.sum)}")
            out.append(f"{self.name}_count{self._label_str(key)} "
                       f"{child.count}")

    def sample(self) -> Any:
        def one(c: _HistogramChild) -> Dict[str, Any]:
            return {"count": c.count, "sum": c.sum,
                    "p50": c.approx_quantile(0.5),
                    "p99": c.approx_quantile(0.99)}
        if not self.labelnames:
            return one(self._default())
        return {",".join(k): one(c)
                for k, c in sorted(self._children.items())}


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Registry:
    """A named set of metric families plus collect-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent by
    name — re-declaring with different labelnames raises, so two
    subsystems cannot silently fork one metric). Collectors run at the
    top of every :meth:`snapshot` / :meth:`render_prometheus`; they are
    how dynamic label sets (per-peer gauges, per-kind byte columns) stay
    current without the hot path writing to the registry at all. A lock
    guards family creation and collection — scrapes come from an asyncio
    sidecar while bench threads observe histograms.
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- declaration ------------------------------------------------------------
    def _get_or_make(self, cls, name: str, help: str,
                     labelnames: Sequence[str], **kw) -> Any:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or (
                        fam.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.typ}{fam.labelnames}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        for fn in list(self._collectors):
            fn()

    # -- output -----------------------------------------------------------------
    def render_prometheus(self) -> str:
        """The Prometheus text exposition of every family."""
        self.collect()
        out: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    out.append(f"# HELP {name} {fam.help}")
                out.append(f"# TYPE {name} {fam.typ}")
                fam.render(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able ``{metric: value}`` view: scalars for label-less
        families, ``{label-values: value}`` maps otherwise, and
        count/sum/p50/p99 summaries for histograms."""
        self.collect()
        with self._lock:
            return {name: self._families[name].sample()
                    for name in sorted(self._families)}

    def render_json(self) -> str:
        def clean(v: Any) -> Any:
            if isinstance(v, float) and not math.isfinite(v):
                return str(v)
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            return v
        return json.dumps({k: clean(v) for k, v in self.snapshot().items()},
                          sort_keys=True)

    # -- absorbers: existing stats objects → labelled families --------------------
    def absorb_net_stats(self, stats: Any, *, node: str = "") -> None:
        """Publish a live :class:`~repro_torch.core.sim.NetStats` (every field
        it has today — frame/byte totals, per-kind and per-link-class
        splits, the cost-model accumulator) as ``repro_net_*`` families
        labelled by ``node``. The stats object stays the accumulator;
        nothing at its call sites changes."""
        c = {
            "repro_net_frames_sent_total": ("sent", "frames sent"),
            "repro_net_frames_delivered_total": ("delivered",
                                                 "frames delivered"),
            "repro_net_frames_dropped_total": ("dropped", "frames dropped"),
            "repro_net_frames_duplicated_total": ("duplicated",
                                                  "frames duplicated"),
            "repro_net_bytes_sent_total": ("bytes_sent", "bytes sent"),
        }
        fams = {name: self.counter(name, help, ("node",))
                for name, (_, help) in c.items()}
        kind_n = self.counter("repro_net_frames_by_kind_total",
                              "frames sent per payload kind",
                              ("node", "kind"))
        kind_b = self.counter("repro_net_bytes_by_kind_total",
                              "bytes sent per payload kind",
                              ("node", "kind"))
        cls_b = self.counter("repro_net_bytes_by_class_total",
                             "bytes sent per link class",
                             ("node", "link_class"))
        cost = self.counter("repro_net_link_cost_total",
                            "bytes × link byte-cost (WAN egress billing)",
                            ("node",))

        def collect() -> None:
            for name, (attr, _) in c.items():
                fams[name].labels(node).set_total(getattr(stats, attr))
            for k, v in stats.by_kind.items():
                kind_n.labels(node, k).set_total(v)
            for k, v in stats.bytes_by_kind.items():
                kind_b.labels(node, k).set_total(v)
            for k, v in stats.bytes_by_class.items():
                cls_b.labels(node, k).set_total(v)
            cost.labels(node).set_total(stats.link_cost)

        self.add_collector(collect)

    def absorb_link_stats(self, stats: Any, *, node: str = "",
                          clock: Optional[Callable[[], float]] = None
                          ) -> None:
        """:meth:`absorb_net_stats` plus the socket-only columns of
        :class:`~repro_torch.net.stats.LinkStats` (receive mirror, datagram and
        stream channel counters, queue drops) and the derived per-link
        byte-*rate* gauges: with a ``clock``, ``repro_net_bytes_sent_per_second``
        (and per link class) over the window since the previous scrape —
        the liveness signal the obs-smoke CI job asserts is finite."""
        self.absorb_net_stats(stats, node=node)
        c = {
            "repro_net_bytes_recv_total": ("bytes_recv", "bytes received"),
            "repro_net_datagrams_sent_total": ("datagrams_sent",
                                               "UDP datagrams sent"),
            "repro_net_datagrams_recv_total": ("datagrams_recv",
                                               "UDP datagrams received"),
            "repro_net_chunks_sent_total": ("chunks_sent",
                                            "oversized-frame shards sent"),
            "repro_net_reassembly_drops_total": (
                "reassembly_drops", "partial oversized frames evicted"),
            "repro_net_resyncs_total": ("resyncs",
                                        "stream resyncs after corruption"),
            "repro_net_reconnects_total": ("reconnects",
                                           "TCP dial retries after a drop"),
            "repro_net_queue_drops_total": (
                "queue_drops", "frames shed by bounded send queues"),
        }
        fams = {name: self.counter(name, help, ("node",))
                for name, (_, help) in c.items()}
        rkind_b = self.counter("repro_net_recv_bytes_by_kind_total",
                               "bytes received per payload kind",
                               ("node", "kind"))
        rcls_b = self.counter("repro_net_recv_bytes_by_class_total",
                              "bytes received per link class",
                              ("node", "link_class"))
        rate = self.gauge("repro_net_bytes_sent_per_second",
                          "send byte rate over the last scrape window",
                          ("node",))
        rate_cls = self.gauge("repro_net_bytes_by_class_per_second",
                              "per-link-class send byte rate over the "
                              "last scrape window",
                              ("node", "link_class"))
        window = {"t": None, "bytes": 0, "by_class": {}}

        def collect() -> None:
            for name, (attr, _) in c.items():
                fams[name].labels(node).set_total(getattr(stats, attr))
            for k, v in stats.recv_bytes_by_kind.items():
                rkind_b.labels(node, k).set_total(v)
            for k, v in stats.recv_bytes_by_class.items():
                rcls_b.labels(node, k).set_total(v)
            if clock is None:
                return
            now = clock()
            if window["t"] is not None:
                dt = now - window["t"]
                if dt > 0:
                    rate.labels(node).set(
                        (stats.bytes_sent - window["bytes"]) / dt)
                    for k, v in stats.bytes_by_class.items():
                        prev = window["by_class"].get(k, 0)
                        rate_cls.labels(node, k).set((v - prev) / dt)
            else:
                # first scrape: rates are defined (0.0), just windowless
                rate.labels(node).set(0.0)
                for k in stats.bytes_by_class:
                    rate_cls.labels(node, k).set(0.0)
            window["t"] = now
            window["bytes"] = stats.bytes_sent
            window["by_class"] = dict(stats.bytes_by_class)

        self.add_collector(collect)

    def absorb_kernel_counters(self, kc: Optional[Any] = None, *,
                               node: str = "") -> None:
        """Publish :class:`~repro_torch.kernels.ops.KernelCounters` (default:
        the process-wide instance) as ``repro_kernel_*`` counters."""
        if kc is None:
            from ..kernels import ops
            kc = ops.counters
        launches = self.counter("repro_kernel_launches_total",
                                "kernel wrapper dispatches", ("node",))
        h2d = self.counter("repro_kernel_h2d_bytes_total",
                           "bytes staged host→device", ("node",))
        d2h = self.counter("repro_kernel_d2h_bytes_total",
                           "bytes fetched device→host", ("node",))

        def collect() -> None:
            launches.labels(node).set_total(kc.launches)
            h2d.labels(node).set_total(kc.h2d_bytes)
            d2h.labels(node).set_total(kc.d2h_bytes)

        self.add_collector(collect)

    def absorb_crdt_metrics(self, metrics: "Metrics", *,
                            node: str = "") -> None:
        """Publish a replicated :class:`Metrics` recorder's cluster-wide
        aggregates (exact once every reporter's latest record has
        gossiped in) as gauges labelled by metric name."""
        count = self.gauge("repro_crdt_metric_count",
                           "replicated sample count per metric",
                           ("node", "metric"))
        total = self.gauge("repro_crdt_metric_sum",
                           "replicated sample sum per metric",
                           ("node", "metric"))

        def collect() -> None:
            for m, _ in metrics.state.entries:
                count.labels(node, m).set(metrics.state.count(m))
                total.labels(node, m).set(metrics.state.total(m))

        self.add_collector(collect)


_GLOBAL = Registry()


def global_registry() -> Registry:
    """The process-wide registry — what ``benchmarks/run.py --json``
    snapshots per suite and in-process probes default to."""
    return _GLOBAL


def reset_global_registry() -> Registry:
    """Replace the process-wide registry with a fresh one (tests and
    per-suite bench isolation; the old instance keeps working for anyone
    still holding it)."""
    global _GLOBAL
    _GLOBAL = Registry()
    return _GLOBAL


# ---------------------------------------------------------------------------
# Replicated δ-CRDT metrics (moved verbatim in semantics from sync/metrics.py;
# that module now re-exports these names)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MetricRecord:
    """Per-replica monotone ``(n, sum, min, max)`` sample record —
    versioned by its own sample count so joins keep the freshest record
    per reporter (idempotent, commutative; §4.2's counter argument)."""

    n: int = 0
    total: float = 0.0
    min_v: float = float("inf")
    max_v: float = float("-inf")

    def observe(self, value: float, weight: int = 1) -> "MetricRecord":
        return MetricRecord(self.n + weight, self.total + value,
                            min(self.min_v, value), max(self.max_v, value))

    def join(self, other: "MetricRecord") -> "MetricRecord":
        # per-replica records are monotone in n: larger n subsumes
        return self if self.n >= other.n else other


@dataclass(frozen=True)
class MetricsState(DeltaCRDT):
    """metric name → replica → MetricRecord."""

    entries: Tuple[Tuple[str, Tuple[Tuple[ReplicaId, MetricRecord], ...]], ...] = ()

    @staticmethod
    def bottom() -> "MetricsState":
        return MetricsState()

    def _as_dict(self) -> Dict[str, Dict[ReplicaId, MetricRecord]]:
        return {m: dict(rs) for m, rs in self.entries}

    @staticmethod
    def _freeze(d: Dict[str, Dict[ReplicaId, MetricRecord]]) -> "MetricsState":
        return MetricsState(tuple(sorted(
            (m, tuple(sorted(rs.items()))) for m, rs in d.items())))

    def observe_delta(self, i: ReplicaId, metric: str, value: float,
                      weight: int = 1) -> "MetricsState":
        cur = self._as_dict().get(metric, {}).get(i, MetricRecord())
        return MetricsState._freeze({metric: {i: cur.observe(value, weight)}})

    def observe_full(self, i: ReplicaId, metric: str, value: float,
                     weight: int = 1) -> "MetricsState":
        return self.join(self.observe_delta(i, metric, value, weight))

    def join(self, other: "MetricsState") -> "MetricsState":
        a = self._as_dict()
        for m, rs in other._as_dict().items():
            mine = a.setdefault(m, {})
            for r, rec in rs.items():
                mine[r] = mine[r].join(rec) if r in mine else rec
        return MetricsState._freeze(a)

    # -- aggregates -----------------------------------------------------------
    def count(self, metric: str) -> int:
        return sum(rec.n for rec in self._as_dict().get(metric, {}).values())

    def total(self, metric: str) -> float:
        return sum(rec.total for rec in self._as_dict().get(metric, {}).values())

    def mean(self, metric: str) -> float:
        n = self.count(metric)
        return self.total(metric) / n if n else float("nan")

    def minimum(self, metric: str) -> float:
        vals = [rec.min_v for rec in self._as_dict().get(metric, {}).values()]
        return min(vals) if vals else float("inf")

    def maximum(self, metric: str) -> float:
        vals = [rec.max_v for rec in self._as_dict().get(metric, {}).values()]
        return max(vals) if vals else float("-inf")


class Metrics:
    """Convenience recorder for one replica."""

    def __init__(self, replica: ReplicaId):
        self.replica = replica
        self.state = MetricsState.bottom()

    def observe(self, metric: str, value: float, weight: int = 1) -> MetricsState:
        delta = self.state.observe_delta(self.replica, metric, value, weight)
        self.state = self.state.join(delta)
        return delta

    def merge(self, remote: MetricsState) -> None:
        self.state = self.state.join(remote)
