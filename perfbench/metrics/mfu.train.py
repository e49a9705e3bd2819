"""Model operations of the train steps that started in the window
(forward and backward, nothing recomputed; ``yardstick.train_step_flops``)
over the time they took times the card's bf16 peak, in percent."""

from perfbench.yardstick import PEAK_BF16_FLOPS


def read(run):
    flops = run.facts.get("train_flops")
    if not flops:
        return None
    return 100.0 * flops / (run.facts["train_s"] * PEAK_BF16_FLOPS)
