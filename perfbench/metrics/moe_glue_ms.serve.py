"""Median, over the traced decode steps, of the stream time of the MoE
glue's spans under one ``decode_step`` root: ``moe.route``,
``moe.dispatch`` (the dispatch table and the gather of the tokens) and
``moe.combine`` (``repro_torch.obs.trace``). Each span's time is the
interval between its two CUDA events: in a host-paced step it follows
the host's enqueueing under the profiler, gaps included, and is not the
kernels' device time. ``None`` where the program records no spans or no
stream time."""

import statistics

NAMES = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    per_step = {}
    for s in trace.spans()["spans"]:
        if s["name"] in NAMES and s["root_name"] == "decode_step":
            if s["stream_s"] is None:
                return None
            per_step[s["root"]] = per_step.get(s["root"], 0.0) + s["stream_s"]
    return 1e3 * statistics.median(per_step.values()) if per_step else None
