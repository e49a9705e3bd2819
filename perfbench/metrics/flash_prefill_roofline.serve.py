"""``flash_attention_fwd``'s share of its roofline in the traced slice:
the least time of its calls there (``yardstick.flash_prefill_cost``)
over their device time in the profiler's trace, in percent."""

from perfbench.tracing import kernel_seconds


def read(run):
    bounds, t = run.facts.get("flash_bounds"), run.trace_summary
    if not bounds or not t:
        return None
    seconds, n = kernel_seconds(t, "flash_fwd")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * bounds["prefill_s"] / seconds
