"""Trace analyzer: redundancy, convergence, and anomaly detection.

2006.09823 frames strong eventual consistency as a *trace* property —
every delivered update is eventually joined everywhere — and 1803.02750
quantifies the cost side: how many of the shipped bytes were already
known to the receiver. Both are directly computable from a merged
:class:`~repro_torch.obs.trace.Tracer` stream:

* :func:`redundancy` — bytes shipped (``delta_ship`` + ``digest_resp``
  + ``handoff``) vs. bytes whose arrival actually changed receiver
  state (``delta_join`` with a non-empty changed-key set). The ratio is
  ≥ 1.0 by construction; ship-all on a mesh sits far above BP+RR.
* :func:`convergence` — per key: writes, the writers, the nodes the key
  reached, the seconds from last write to the last state-changing join,
  and the number of writer ship-rounds that elapsed in that window
  (the paper's rounds-to-convergence, measured not simulated).
* :func:`anomalies` — trace-level SEC violations:
  ``ship_without_join`` (a written key was shipped but never changed
  state anywhere else — the delivery hole a converged cluster must not
  have), ``ship_before_have`` (a node shipped a key it neither wrote nor
  joined first — accounting corruption), ``ack_without_ship`` (an ack
  arrived from a peer that was never shipped a tagged payload, or for a
  tag above anything shipped — credit corruption upstream of RR's
  known-state bound).
* :func:`semantic_trace` — the timing-free per-key view two runs of the
  same schedule must agree on (who wrote how often, who converged to
  holding it); ``test_sim_socket_equivalence`` asserts a Simulator run
  and a loopback UDP run produce equal semantic traces. Ship edges and
  digest participation are deliberately excluded: *which* peer first
  delivered a key is a race both in the sim and on sockets.
* :func:`report` — the bench-facing rollup (redundancy ratio,
  convergence summary, anomaly counts) recorded into BENCH_tier1.json.

Caveats the functions enforce: events whose key lists were truncated
(``keys_truncated``) disable key-level anomaly checks rather than
emitting false positives, and a ring buffer that evicted early events
can fabricate ``ship_before_have`` — analyze full traces (size the
tracer capacity to the run, or use a JSONL sink).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Set

from .trace import merge_events

SHIP_KINDS = ("delta_ship", "digest_resp", "handoff")


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read one tracer's JSONL sink back into an event list."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _events(trace: Any) -> List[Dict[str, Any]]:
    """Accept a tracer, an event list, or a list of either (merged)."""
    if hasattr(trace, "events"):
        return trace.events()
    if isinstance(trace, (list, tuple)) and trace and not isinstance(
            trace[0], dict):
        return merge_events(*trace)
    return list(trace)


# ---------------------------------------------------------------------------
# Redundancy: shipped bytes vs bytes that changed state
# ---------------------------------------------------------------------------

def redundancy(trace: Any) -> Dict[str, Any]:
    """How much of the shipped traffic was already known to receivers.

    ``ratio`` = state-carrying bytes shipped / bytes of arrivals that
    changed receiver state (NaN when nothing joined). ``redundant_joins``
    counts arrivals that changed nothing at all — the payloads RR/BP
    exist to eliminate.
    """
    shipped = joined = 0
    ships = joins = redundant = 0
    for ev in _events(trace):
        k = ev["kind"]
        if k in SHIP_KINDS:
            shipped += ev.get("bytes", 0)
            ships += 1
        elif k == "delta_join":
            joins += 1
            if ev.get("joined", 0) > 0:
                joined += ev.get("bytes", 0)
            else:
                redundant += 1
    return {
        "shipped_bytes": shipped,
        "joined_bytes": joined,
        "ratio": (shipped / joined) if joined else float("nan"),
        "ships": ships,
        "joins": joins,
        "redundant_joins": redundant,
    }


# ---------------------------------------------------------------------------
# Convergence: per-key write→everywhere lag and rounds
# ---------------------------------------------------------------------------

def convergence(trace: Any) -> Dict[str, Dict[str, Any]]:
    """Per-key convergence record (see module docstring). ``lag_s`` and
    ``rounds`` measure from the key's *last* write to its last
    state-changing join — on a converged run, the moment every replica
    held the final value."""
    events = _events(trace)
    out: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev["kind"] != "write":
            continue
        for k in ev.get("keys") or ():
            rec = out.setdefault(k, {"writes": 0, "writers": set(),
                                     "nodes": set(), "last_write_t": None,
                                     "lag_s": 0.0, "rounds": 0})
            rec["writes"] += 1
            rec["writers"].add(ev["node"])
            rec["nodes"].add(ev["node"])
            t = ev.get("t", 0.0)
            if rec["last_write_t"] is None or t > rec["last_write_t"]:
                rec["last_write_t"] = t
    for ev in events:
        if ev["kind"] != "delta_join" or not ev.get("joined", 0):
            continue
        for k in ev.get("keys") or ():
            rec = out.get(k)
            if rec is None:
                continue
            rec["nodes"].add(ev["node"])
            if rec["last_write_t"] is not None:
                lag = ev.get("t", 0.0) - rec["last_write_t"]
                if lag > rec["lag_s"]:
                    rec["lag_s"] = lag
    # rounds: distinct (writer, round) ship rounds carrying the key in
    # each key's convergence window [last write, last changing join]
    for ev in events:
        if ev["kind"] != "delta_ship":
            continue
        for k in ev.get("keys") or ():
            rec = out.get(k)
            if rec is None or ev["node"] not in rec["writers"]:
                continue
            t0 = rec["last_write_t"]
            if t0 is not None and t0 <= ev.get("t", 0.0) <= t0 + rec["lag_s"]:
                rounds = rec.setdefault("_round_set", set())
                rounds.add((ev["node"], ev.get("round", 0)))
    for rec in out.values():
        rec["rounds"] = len(rec.pop("_round_set", ()))
        rec["writers"] = sorted(rec["writers"])
        rec["nodes"] = sorted(rec["nodes"])
    return out


# ---------------------------------------------------------------------------
# Anomalies
# ---------------------------------------------------------------------------

def anomalies(trace: Any) -> List[Dict[str, Any]]:
    """Trace-level consistency violations (empty list ⇔ clean trace)."""
    events = _events(trace)
    truncated = any(ev.get("keys_truncated") for ev in events)
    out: List[Dict[str, Any]] = []

    # ack bookkeeping is key-independent: always checkable
    max_ship_tag: Dict[tuple, int] = {}
    for ev in events:
        if ev["kind"] == "delta_ship" and "tag" in ev:
            edge = (ev["node"], ev["dst"])
            max_ship_tag[edge] = max(max_ship_tag.get(edge, -1), ev["tag"])
        elif ev["kind"] == "ack":
            edge = (ev["node"], ev["src"])
            top = max_ship_tag.get(edge)
            if top is None:
                out.append({"kind": "ack_without_ship", "node": ev["node"],
                            "src": ev["src"], "tag": ev.get("tag")})
            elif ev.get("tag", 0) > top:
                out.append({"kind": "ack_above_ship", "node": ev["node"],
                            "src": ev["src"], "tag": ev.get("tag"),
                            "max_shipped": top})
    if truncated:
        out.append({"kind": "keys_truncated",
                    "note": "key-level checks skipped"})
        return out

    nodes: Set[str] = {ev["node"] for ev in events}
    have: Dict[str, Set[str]] = {}          # node -> keys written/joined
    shipped_keys: Set[str] = set()
    written_keys: Set[str] = set()
    joined_keys: Set[str] = set()
    for ev in events:
        node = ev["node"]
        if ev["kind"] == "write":
            ks = ev.get("keys") or ()
            written_keys.update(ks)
            have.setdefault(node, set()).update(ks)
        elif ev["kind"] == "delta_join":
            ks = (ev.get("keys") or ()) if ev.get("joined", 0) else ()
            joined_keys.update(ks)
            have.setdefault(node, set()).update(ks)
        elif ev["kind"] in ("delta_ship", "handoff"):
            ks = ev.get("keys") or ()
            shipped_keys.update(ks)
            if not ev.get("full"):
                held = have.get(node, set())
                for k in ks:
                    if k not in held:
                        out.append({"kind": "ship_before_have",
                                    "node": node, "dst": ev.get("dst"),
                                    "key": k, "seq": ev.get("seq")})
    if len(nodes) > 1:
        for k in sorted((written_keys & shipped_keys) - joined_keys):
            out.append({"kind": "ship_without_join", "key": k})
    return out


# ---------------------------------------------------------------------------
# Semantic equivalence
# ---------------------------------------------------------------------------

def semantic_trace(trace: Any) -> Dict[str, Dict[str, Any]]:
    """The timing-free view two runs of one schedule must agree on:
    per key, how many writes each writer issued and the sorted set of
    nodes that ended up holding it (writers + state-changing joiners)."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in _events(trace):
        if ev["kind"] == "write":
            for k in ev.get("keys") or ():
                rec = out.setdefault(k, {"writes": {}, "joined": set()})
                w = rec["writes"]
                w[ev["node"]] = w.get(ev["node"], 0) + 1
                rec["joined"].add(ev["node"])
        elif ev["kind"] == "delta_join" and ev.get("joined", 0):
            for k in ev.get("keys") or ():
                rec = out.setdefault(k, {"writes": {}, "joined": set()})
                rec["joined"].add(ev["node"])
    return {k: {"writes": rec["writes"],
                "joined": sorted(rec["joined"])}
            for k, rec in out.items()}


# ---------------------------------------------------------------------------
# Rollup
# ---------------------------------------------------------------------------

def report(trace: Any, *, expect_converged: Optional[Iterable[str]] = None
           ) -> Dict[str, Any]:
    """The bench-facing rollup: redundancy, convergence summary, anomaly
    counts. ``expect_converged`` (an iterable of node ids) additionally
    asserts every written key reached every one of those nodes."""
    events = _events(trace)
    red = redundancy(events)
    conv = convergence(events)
    anom = anomalies(events)
    lags = [rec["lag_s"] for rec in conv.values() if rec["writes"]]
    rounds = [rec["rounds"] for rec in conv.values() if rec["writes"]]
    anomaly_counts: Dict[str, int] = {}
    for a in anom:
        anomaly_counts[a["kind"]] = anomaly_counts.get(a["kind"], 0) + 1
    rep = {
        "redundancy": red,
        "keys": len(conv),
        "mean_lag_s": (sum(lags) / len(lags)) if lags else 0.0,
        "max_lag_s": max(lags) if lags else 0.0,
        "mean_rounds": (sum(rounds) / len(rounds)) if rounds else 0.0,
        "anomalies": anomaly_counts,
        "anomaly_list": anom,
    }
    if expect_converged is not None:
        want = set(expect_converged)
        missing = {k: sorted(want - set(rec["nodes"]))
                   for k, rec in conv.items()
                   if want - set(rec["nodes"])}
        rep["unconverged_keys"] = missing
    return rep
