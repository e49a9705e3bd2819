"""The yardstick: the card's peaks, the operations and bytes a piece of
work needs (counted from its shapes), and the spread of a set of runs.

Operations count a multiply-add as two. A kernel's bytes are each input
read once and each output written once, whatever the kernel reads again;
where the work depends on the inputs (a causal or windowed mask, the
valid slots of a ring cache), only what these inputs need is counted.
Model operations count forward and backward (twice the forward) of
every product the model needs, nothing recomputed, attention over the
keys each position attends.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs of a causal self-attention over ``s`` positions,
    each query seeing at most ``window`` keys (itself included)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_prefill_cost(b: int, H: int, KV: int, s: int, hd: int,
                       window: Optional[int], itemsize: int = 2
                       ) -> Tuple[float, float]:
    """(operations, bytes) of one ``flash_attention_fwd`` call: QK^T and
    PV over the pairs the mask keeps; q, k, v read, o written."""
    flops = 4.0 * b * H * hd * causal_pairs(s, window)
    nbytes = itemsize * (2.0 * b * H * s * hd + 2.0 * b * KV * s * hd)
    return flops, nbytes


def flash_decode_cost(b: int, H: int, KV: int, C: int, hd: int,
                      valid: int, itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one ``flash_decode_fwd`` call: one query a
    row against ``valid`` slots of a ``C``-slot ring; q read, o written,
    the valid slots' k and v read, every slot's position (int32) read to
    tell which are valid, and each row's query position."""
    flops = 4.0 * b * H * hd * valid
    nbytes = (itemsize * (2.0 * b * H * hd + 2.0 * b * KV * valid * hd)
              + 4.0 * b * C + 4.0 * b)
    return flops, nbytes


def roofline_s(flops: float, nbytes: float,
               peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time of the work on the card."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def _layer_matmul_flops(conf: Dict) -> float:
    """Forward operations of one layer's products for one token, without
    attention's scores and PV (MoE: the router and the top-k experts)."""
    d, H, KV, hd = (conf["d_model"], conf["n_heads"], conf["n_kv_heads"],
                    conf["head_dim"])
    attn = 2.0 * (d * H * hd + 2 * d * KV * hd + H * hd * d)
    if conf["mlp"] == "dense":
        mlp = 2.0 * 3 * d * conf["d_ff"]
    else:
        m = conf["moe"]
        mlp = 2.0 * (d * m["num_experts"]
                     + m["top_k"] * 3 * d * m["expert_d_ff"])
    return attn + mlp


def _attention_flops(conf: Dict, pairs: float) -> float:
    return 4.0 * conf["n_heads"] * conf["head_dim"] * pairs


def train_step_flops(conf: Dict, batch: int, seq: int) -> float:
    """Model operations of one train step: forward and backward (3× the
    forward) over ``batch`` rows of ``seq`` tokens, logits at every
    position."""
    L = conf["n_layers"]
    per_row = (seq * (L * _layer_matmul_flops(conf)
                      + 2.0 * conf["d_model"] * conf["vocab"])
               + L * _attention_flops(conf, causal_pairs(seq,
                                                         conf.get("window"))))
    return 3.0 * batch * per_row


def prefill_flops(conf: Dict, batch: int, s: int) -> float:
    """Model operations of one prefill: ``s`` prompt tokens a row through
    every layer, logits at the last position."""
    L = conf["n_layers"]
    per_row = (s * L * _layer_matmul_flops(conf)
               + L * _attention_flops(conf, causal_pairs(s,
                                                         conf.get("window")))
               + 2.0 * conf["d_model"] * conf["vocab"])
    return batch * per_row


def decode_flops(conf: Dict, batch: int, pos: int) -> float:
    """Model operations of one decode step at position ``pos``: each row's
    token through every layer, attending min(pos + 1, window) keys."""
    L = conf["n_layers"]
    w = conf.get("window")
    ctx = pos + 1 if w is None else min(pos + 1, w)
    return batch * (L * (_layer_matmul_flops(conf)
                         + _attention_flops(conf, ctx))
                    + 2.0 * conf["d_model"] * conf["vocab"])


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles``, n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile (0-100) by linear interpolation between
    closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
