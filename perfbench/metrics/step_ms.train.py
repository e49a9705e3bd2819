"""Median host-clock time of one train step in the window (a span around
the step, ending when its loss reaches the host)."""

import statistics


def read(run):
    start, end = run.window
    name = run.facts.get("step_span")
    if name is None:
        return None
    d = run.spans.durations(name, start, end)
    return 1e3 * statistics.median(d) if d else None
