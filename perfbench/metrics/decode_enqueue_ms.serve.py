"""Median host time of the traced slice's ``decode_step`` spans, recorded
inside the program (``repro_torch.obs.trace``) from the call to its
return, with no sync inside: the host's cost to enqueue one decode step.
``None`` where the program records no spans."""

import statistics


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    d = [s["host_s"] for s in trace.spans()["spans"]
         if s["name"] == "decode_step"]
    return 1e3 * statistics.median(d) if d else None
