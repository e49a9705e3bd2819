"""Unified observability: trace bus, metrics registry, probes, scrape.

One subsystem, four surfaces (DESIGN.md §12):

* :mod:`repro_torch.obs.trace`    — :class:`Tracer`, the structured event bus
  every engine layer emits into (deterministic-clock mode makes sim and
  socket traces comparable).
* :mod:`repro_torch.obs.registry` — :class:`Registry` (counters / gauges /
  histograms with label sets) plus absorbers for the counters the repo
  already keeps (``NetStats``/``LinkStats``/``KernelCounters``) and the
  replicated δ-CRDT metrics lattice (ex ``sync/metrics.py``).
* :mod:`repro_torch.obs.probes`   — derived convergence-lag and engine-health
  gauges (:class:`ReplicaProbes`, :class:`AckLagProbe`, marker lag).
* :mod:`repro_torch.obs.scrape`   — :class:`MetricsServer` (Prometheus text +
  JSON sidecar endpoint) and the matching :func:`scrape` clients.
* :mod:`repro_torch.obs.analyze`  — trace analytics: redundancy ratio,
  convergence rounds/lag per key, anomaly flags, semantic equivalence.
"""

from .analyze import (anomalies, convergence, load_trace, redundancy,
                      report, semantic_trace)
from .probes import AckLagProbe, ReplicaProbes, marker_lag_histogram
from .registry import (Counter, Gauge, Histogram, Metrics, MetricRecord,
                       MetricsState, Registry, global_registry,
                       reset_global_registry)
from .scrape import MetricsServer, parse_prometheus, scrape, scrape_json
from .trace import EVENT_KINDS, Tracer, merge_events, trace_kernel_launches

__all__ = [
    "AckLagProbe", "Counter", "EVENT_KINDS", "Gauge", "Histogram",
    "Metrics", "MetricRecord", "MetricsServer", "MetricsState",
    "Registry", "ReplicaProbes", "Tracer", "anomalies", "convergence",
    "global_registry", "load_trace", "marker_lag_histogram",
    "merge_events", "parse_prometheus", "redundancy", "report",
    "reset_global_registry", "scrape", "scrape_json", "semantic_trace",
    "trace_kernel_launches",
]
