"""Compatibility shim: the replicated δ-CRDT metrics moved to
:mod:`repro_torch.obs.registry` (the single metrics home — local process
counters and replicated duplicate-safe aggregates are two views of one
observability layer). Import from ``repro_torch.obs`` in new code."""

from __future__ import annotations

from ..obs.registry import MetricRecord, Metrics, MetricsState

__all__ = ["MetricRecord", "Metrics", "MetricsState"]
