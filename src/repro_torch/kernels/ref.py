"""Plain PyTorch versions of the δ-CRDT kernels: the CPU path and the
yardstick every CUDA kernel is held against on the card.

Attention oracles arrive with the model slice."""

from __future__ import annotations

from typing import List, Tuple

import torch


def delta_join_ref(a_vals, a_vers, b_vals, b_vers
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    take_b = b_vers > a_vers
    return (torch.where(take_b[:, None], b_vals, a_vals),
            torch.maximum(a_vers, b_vers))


def batched_delta_join_ref(segments) -> List[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Per-segment oracle for the stacked batched join."""
    return [delta_join_ref(*s) for s in segments]


def chunk_digest_ref(x) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    return xf.abs().amax(dim=-1), (xf * xf).sum(dim=-1)


def fused_join_digest_ref(a_vals, a_vers, b_vals, b_vers):
    """Join + digest-of-the-merge (the kernel fuses these into one pass
    over device memory)."""
    ov, over = delta_join_ref(a_vals, a_vers, b_vals, b_vers)
    ma, ss = chunk_digest_ref(ov)
    return ov, over, ma, ss


def scatter_join_ref(vals, vers, maxabs, sumsq, idx, d_vals, d_vers):
    """Sparse scatter-ingest: merge ``r`` delta rows into copies of the
    resident columns at rows ``idx`` and refresh those rows' digest;
    every other row is unchanged and the inputs are left intact.
    Duplicate positions are only legal when their merged content is
    identical (the pad-row convention), so write order cannot matter."""
    if int(idx.shape[0]) == 0:
        return vals, vers, maxabs, sumsq
    idx = idx.long()
    cur_v = vals[idx]
    cur_r = vers[idx]
    take = d_vers > cur_r
    merged = torch.where(take[:, None], d_vals, cur_v)
    ma, ss = chunk_digest_ref(merged)
    ov, over = vals.clone(), vers.clone()
    oma, oss = maxabs.clone(), sumsq.clone()
    ov[idx] = merged
    over[idx] = torch.maximum(cur_r, d_vers)
    oma[idx] = ma
    oss[idx] = ss
    return ov, over, oma, oss
