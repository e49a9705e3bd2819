"""The caching allocator's retries (``num_alloc_retries``: an allocation
that failed, freed the allocator's cached blocks and tried again) summed
over the traced ``train_step`` spans, per step (``repro_torch.obs.trace``;
the span's difference across the step, on CUDA only). 0 is a reading.
``None`` where the program records no such span."""


def read(run):
    from repro_torch.obs import trace
    if not hasattr(trace, "spans"):
        return None
    d = [s["alloc_retries"] for s in trace.spans()["spans"]
         if s["name"] == "train_step" and "alloc_retries" in s]
    return sum(d) / len(d) if d else None
