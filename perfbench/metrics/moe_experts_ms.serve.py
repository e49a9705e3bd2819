"""Median, over the traced decode steps, of the stream time of the
``moe.experts`` spans (the routed experts' products, and the shared
experts' where a configuration has them) under one ``decode_step`` root
(``repro_torch.obs.trace``). Each span's time is the interval between
its two CUDA events, host gaps inside it included under the profiler:
not the kernels' device time. ``None`` where the program records no
spans or no stream time."""

import statistics

NAMES = ("moe.experts",)


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
