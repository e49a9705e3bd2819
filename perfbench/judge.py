"""The numbers that decide ``correct``: what the program produced, held
against the reference.

Training: each checked step's loss (relative gap); each leaf's norm of
the first step's clipped gradient and of the parameters' change after
the checked steps, as the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and of
the median leaf, worst leaf; and the first gradient itself at entries
drawn from the seed (``grad_sample_gap``), which a change of direction
moves where the clipped norms do not. Leaves whose reference gradient is under a
thousandth of the median leaf's (a key bias under softmax) move by
round-off alone and are left out of the change.

Serving: at each position of the served tokens, how far the served
token's logit lies below the reference's best there, in units of the
spread of the reference's logits, averaged over the positions, and the
same per request: the worst request's mean, and the worst request's
median, which a fault in one slot of a large batch moves where the mean
over the batch dilutes it. The widest single gap is kept as a reading:
near-ties of the MoE router flip an expert, or the pair an expert's
capacity drops, on rounding alone, and a flipped position reads as far
off in bfloat16 as in float8.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Sequence

import torch

STILL = 1e-3


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def moving_leaves(ref_grads: Dict) -> list:
    med = statistics.median(ref_grads.values())
    return [p for p, g in ref_grads.items() if g >= STILL * med]


def leaf_gap(program: Dict, reference: Dict,
             leaves: Optional[Iterable] = None) -> float:
    leaves = list(reference) if leaves is None else list(leaves)
    med = statistics.median(reference[p] for p in leaves)
    return max(abs(program[p] - reference[p]) / max(reference[p], med)
               for p in leaves)


def sample_gap(program: Dict, reference: Dict, leaves: Iterable) -> float:
    """Worst leaf of |program's values - reference's| over |reference's|
    at the sampled entries."""
    return max(float((program[p] - reference[p]).norm()
                     / reference[p].norm()) for p in leaves)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad_norms", "grad_samples",
    "update_norms"}."""
    moving = moving_leaves(ref["grad_norms"])
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
            "grad_sample_gap": sample_gap(prog["grad_samples"],
                                          ref["grad_samples"], moving),
            "update_gap": leaf_gap(prog["update_norms"], ref["update_norms"],
                                   moving)}


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor
                ) -> torch.Tensor:
    """ref_logits [B, G, V], served [B, G] → at each position the served
    token's logit below the reference's best, in units of the standard
    deviation of the reference's logits there."""
    best = ref_logits.max(dim=-1).values
    got = torch.gather(ref_logits, -1, served[..., None].long())[..., 0]
    return (best - got) / ref_logits.std(dim=-1)


def serve_numbers(gaps: torch.Tensor) -> Dict[str, float]:
    """``gaps`` [requests, served tokens]. A cell's limits file names the
    numbers it compares; the rest are readings."""
    g = gaps.float()
    return {"gap_mean": float(g.mean()),
            "gap_request_max": float(g.mean(dim=1).max()),
            "gap_request_median_max": float(g.median(dim=1).values.max()),
            "gap_max": float(g.max()),
            "off_best": float((g > 0).float().mean())}
