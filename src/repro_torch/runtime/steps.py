"""Train / serve step factories.

``make_train_step``: loss (remat'd loop over layers) → grads
(``torch.autograd.grad``) → global-norm clip → AdamW with fp32 master.
Optional microbatch gradient accumulation in f32 (activation memory ÷
n_micro), as the JAX package's ``lax.scan`` over microbatches.

The factories close over the ModelConfig only; params/opt-state/batch come
in as arguments, and the step is functional: it returns new parameter and
optimizer trees and leaves its inputs intact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from .. import tree as tu
from ..models import decode_step as model_decode
from ..models import prefill as model_prefill
from ..models import train_loss
from ..obs.trace import spanned
from ..optim import AdamWConfig, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 1
    remat: bool = True


def _split_micro(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``'s batch as [n, b/n, ...] microbatches: microbatch i is the
    i-th slice of b/n rows, as the JAX package's reshape makes it. A
    ``DTensor`` whose batch is sharded is gathered first (the batch
    inputs are small) and each microbatch's rows sharded as the batch
    was."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or not any(
            p == Shard(0) for p in x.placements):
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    mesh = x.device_mesh
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    micro = whole.reshape((n, b // n) + tuple(x.shape[1:]))
    return micro.redistribute(mesh, [Shard(p.dim + 1) if isinstance(
        p, Shard) else p for p in x.placements])


def make_train_step(cfg, tcfg: TrainConfig = TrainConfig()) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics)."""

    def value_and_grad(params, batch):
        flat, treedef = tu.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = train_loss(cfg, treedef.unflatten(leaves), batch,
                              remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), treedef.unflatten(list(grads))

    # the step's span carries the caching allocator's retries, device
    # allocations and frees across it (on CUDA)
    @spanned("train_step", memory=True)
    def train_step(params, opt_state, batch):
        if tcfg.microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            n = tcfg.microbatches
            micro = {k: _split_micro(v, n) for k, v in batch.items()}
            loss = 0.0
            grads = tu.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(n):
                mb = {k: v[i] for k, v in micro.items()}
                l_i, g_i = value_and_grad(params, mb)
                grads = tu.tree_map(
                    lambda a, x: a + x.to(torch.float32) / n, grads, g_i)
                loss = loss + l_i / n
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             tcfg.optimizer)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step


def make_prefill_fn(cfg, max_len: int) -> Callable:
    """(params, batch) → (next-token logits, caches)."""

    def prefill_fn(params, batch):
        return model_prefill(cfg, params, batch, max_len=max_len)

    return prefill_fn


def make_decode_fn(cfg) -> Callable:
    """(params, tokens, pos, caches) → (logits, caches); the caches are
    updated in place."""

    def decode_fn(params, tokens, pos, caches):
        return model_decode(cfg, params, tokens, pos, caches)

    return decode_fn
