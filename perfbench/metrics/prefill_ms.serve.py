"""Mean host-clock time of ``models.prefill`` in the window, from the call
to its first tokens on the host (a mean: the mix's prompt lengths come in
a fixed cycle, and a median would jump between them)."""

import statistics


def read(run):
    start, end = run.window
    d = run.spans.durations("prefill", start, end)
    return 1e3 * statistics.fmean(d) if d else None
