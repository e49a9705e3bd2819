"""Stream time of the ``topk.compress`` spans (``TopKCompressor.compress``:
each leaf's top-k with error feedback, at every pod's round) in a
traced round, summed over the pods (``repro_torch.obs.trace``, CUDA
events; the slice's total divided by its rounds). ``None`` where the program
records no spans or no stream time."""

NAMES = ("topk.compress",)


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    d = [s["stream_s"] for s in trace.spans()["spans"] if s["name"] in NAMES]
    if not d or None in d:
        return None
    return 1e3 * sum(d) / run.cell.mix["trace_rounds"]
