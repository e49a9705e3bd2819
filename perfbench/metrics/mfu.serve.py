"""Model operations of the prefill and decode tokens processed in the
window (the top-k experts' work only, attention over the window;
``yardstick.prefill_flops`` and ``decode_flops``) over the window times
the card's bf16 peak, in percent."""

from perfbench.yardstick import PEAK_BF16_FLOPS


def read(run):
    flops = run.facts.get("serve_flops")
    if not flops:
        return None
    return 100.0 * flops / (run.seconds * PEAK_BF16_FLOPS)
