"""Share of the (token, k) pairs that the MoE dispatch dropped past an
expert's capacity in the traced slice: the program's counters
``moe.dropped_pairs`` over ``moe.routed_pairs`` (``repro_torch.obs.trace``;
the prefill's dispatches and each decode step's), in percent. ``None``
where the program counts nothing."""


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    counts = trace.spans()["counts"]
    routed = counts.get("moe.routed_pairs", 0)
    if not routed:
        return None
    return 100.0 * counts.get("moe.dropped_pairs", 0) / routed
