"""HLO collective parsing + ring-cost accounting.

The JAX package's module, kept as it is (pure text and numpy) so that the
port reads the JAX dry-run's HLO the same way, plus
:func:`recorded_collective_bytes`, which charges the collectives the
port's dry-run records from ``DTensor``'s ``c10d_functional`` calls with
the same ring costs.

Walks compiled-HLO text (``compiled.as_text()``) and, for every collective
op, derives the per-chip wire bytes from the result shape and the replica
group size under the standard ring algorithms:

    all-gather          result · (G-1)/G
    reduce-scatter      result · (G-1)        (input = result · G)
    all-reduce          2 · size · (G-1)/G    (reduce-scatter + all-gather)
    all-to-all          size · (G-1)/G
    collective-permute  size                  (one hop)

``-start`` variants count as the op; ``-done`` halves are skipped.

Replica groups come in two syntaxes:

* explicit   ``replica_groups={{0,1,2,3},{4,5,6,7}}``
* iota       ``replica_groups=[32,16]<=[512]`` or
             ``[16,32]<=[32,16]T(1,0)`` — reshape ``arange(prod)`` to the
             source shape, apply the transpose, flatten, regroup.

``cross_pod_bytes`` materializes the device lists and charges only
collectives whose groups span a pod boundary (device // pod_size differs
within a group) — the §Perf "cross-pod traffic" accounting.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3b11fnuz": 1, "f8e4m3fnuz": 1, "f8e5m2fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")

_OP_RE = re.compile(
    r"\b(" + "|".join(sorted(_COLLECTIVES, key=len, reverse=True))
    + r")(-start|-done)?\(")
_SHAPE_RE = re.compile(r"\b([a-z]\w*)\[([0-9,]*)\]")
_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_EXPLICIT_RE = re.compile(r"replica_groups=\{(\{[^}]*\}(?:,\{[^}]*\})*)\}")


def _result_bytes(line: str) -> Optional[float]:
    """Bytes of the first (result) shape on the line."""
    m = _SHAPE_RE.search(line)
    if not m or m.group(1) not in _DTYPE_BYTES:
        # tuple results like (f32[...], u32[...]): scan for the first
        # known dtype on the line
        for m in _SHAPE_RE.finditer(line):
            if m.group(1) in _DTYPE_BYTES:
                break
        else:
            return None
    dims = [int(d) for d in m.group(2).split(",") if d] or [1]
    return float(np.prod(dims)) * _DTYPE_BYTES[m.group(1)]


def _parse_groups(line: str, n_devices: int) -> Optional[np.ndarray]:
    """[n_groups, group_size] device array, or None for 'all devices'."""
    m = _IOTA_RE.search(line)
    if m:
        n_groups, group_size = int(m.group(1)), int(m.group(2))
        src = [int(d) for d in m.group(3).split(",")]
        devs = np.arange(int(np.prod(src))).reshape(src)
        if m.group(4):
            perm = [int(p) for p in m.group(4).split(",")]
            devs = devs.transpose(perm)
        return devs.reshape(n_groups, group_size)
    m = _EXPLICIT_RE.search(line)
    if m:
        groups = [[int(d) for d in g.split(",") if d]
                  for g in re.findall(r"\{([^}]*)\}", m.group(1))]
        groups = [g for g in groups if g]
        if not groups:
            return None
        width = max(len(g) for g in groups)
        return np.asarray([g + g[-1:] * (width - len(g)) for g in groups])
    return None


def _group_size(line: str, n_devices: int) -> int:
    groups = _parse_groups(line, n_devices)
    if groups is None:
        return max(1, n_devices)
    return max(1, groups.shape[1])


def _ring_cost(kind: str, size: float, g: int) -> float:
    if g <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-gather":
        return size * (g - 1) / g
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if kind == "all-to-all":
        return size * (g - 1) / g
    if kind in ("collective-permute", "collective-broadcast"):
        return size
    return 0.0  # pragma: no cover


def _iter_collectives(hlo: str):
    for line in hlo.splitlines():
        m = _OP_RE.search(line)
        if not m or m.group(2) == "-done":
            continue
        yield m.group(1), line


def collective_bytes(hlo: str, n_devices: int) -> Tuple[float, Dict[str, float]]:
    """(total per-chip wire bytes, per-kind breakdown) for an HLO module."""
    per_kind: Dict[str, float] = {}
    total = 0.0
    for kind, line in _iter_collectives(hlo):
        size = _result_bytes(line)
        if size is None:
            continue
        cost = _ring_cost(kind, size, _group_size(line, n_devices))
        per_kind[kind] = per_kind.get(kind, 0.0) + cost
        total += cost
    return total, per_kind


def collective_count(hlo: str) -> Dict[str, int]:
    """Number of collective ops by kind (async pairs counted once)."""
    counts: Dict[str, int] = {}
    for kind, _line in _iter_collectives(hlo):
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def cross_pod_bytes(hlo: str, n_devices: int, pod_size: int) -> float:
    """Per-chip wire bytes of collectives whose replica groups span a pod
    boundary (membership-aware: a group entirely inside one pod is free)."""
    total = 0.0
    for kind, line in _iter_collectives(hlo):
        size = _result_bytes(line)
        if size is None:
            continue
        groups = _parse_groups(line, n_devices)
        if groups is None:
            spans = n_devices > pod_size
            g = max(1, n_devices)
        else:
            pods = groups // pod_size
            spans = bool((pods != pods[:, :1]).any())
            g = groups.shape[1]
        if spans:
            total += _ring_cost(kind, size, g)
    return total


# ---------------------------------------------------------------------------
# Collectives recorded while the port runs (no HLO text)
# ---------------------------------------------------------------------------

def recorded_collective_bytes(records) -> Tuple[float, Dict[str, float]]:
    """(total per-chip wire bytes, per-kind breakdown) of collectives
    recorded as ``(kind, result bytes, group size)`` — ``kind`` one of the
    HLO names above, the group the mesh dimension the collective ran on
    (``launch.dryrun.StepCounter`` records them under ``CommDebugMode``) —
    charged with the same ring costs as ``collective_bytes``."""
    per_kind: Dict[str, float] = {}
    total = 0.0
    for kind, size, g in records:
        cost = _ring_cost(kind, float(size), int(g))
        per_kind[kind] = per_kind.get(kind, 0.0) + cost
        total += cost
    return total, per_kind
