"""Share of the traced slice of the window with no kernel running on the
card (``torch.profiler``), in percent."""


def read(run):
    t = run.trace_summary
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
