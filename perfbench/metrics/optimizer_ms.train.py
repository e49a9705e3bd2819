"""Median stream time of the traced steps' ``train.optimizer`` spans
(``optim.adamw_update``, global-norm clip included; ``repro_torch.obs.trace``,
CUDA events). ``None`` where the program records no spans or no stream
time."""

import statistics


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    d = [s["stream_s"] for s in trace.spans()["spans"]
         if s["name"] == "train.optimizer"]
    if not d or None in d:
        return None
    return 1e3 * statistics.median(d)
