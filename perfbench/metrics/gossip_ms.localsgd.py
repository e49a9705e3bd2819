"""Stream time of the gossip's spans, ``replica.receive`` and
``replica.periodic`` (``Replica.on_receive`` and ``on_periodic``: the
payloads, their joins into the dot store and the acks) in a
traced round, summed over the pods (``repro_torch.obs.trace``, CUDA
events; the slice's total divided by its rounds). ``None`` where the program
records no spans or no stream time."""

NAMES = ("replica.receive", "replica.periodic")


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    d = [s["stream_s"] for s in trace.spans()["spans"] if s["name"] in NAMES]
    if not d or None in d:
        return None
    return 1e3 * sum(d) / run.cell.mix["trace_rounds"]
