"""95th percentile of the gaps between a request's consecutive tokens
reaching the host, over the tokens that reached it in the window."""

from perfbench.yardstick import percentile


def read(run):
    gaps = run.facts.get("tpot_ms")
    return percentile(gaps, 95) if gaps else None
