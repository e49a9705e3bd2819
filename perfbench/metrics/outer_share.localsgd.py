"""Share of the measured rounds' time outside the pods' local train
steps: top-k with error feedback, the dot's join into the store,
materialising the outer parameters, fresh optimizer state and the
gossip, in percent."""


def read(run):
    took = run.facts.get("train_s")
    if not took:
        return None
    start = run.window[0]
    end = start + took
    inside = sum(min(b, end) - max(a, start)
                 for a, b in run.spans.by_name.get("local_step", ())
                 if b > start and a < end)
    return 100.0 * (1.0 - inside / took)
