"""AdamW (decoupled weight decay) with mixed-precision discipline.

* params may be bf16; the optimizer keeps an fp32 master copy and fp32
  moments (12 bytes/param);
* gradients are cast to fp32 before moment updates;
* global-norm clipping in fp32;
* linear warmup → cosine decay schedule computed from the int32 step
  tensor on its device, in f32 as the JAX package computes it.

The update is functional: it returns new tensors and leaves its inputs
intact; on ``DTensor`` parameters the state and the update keep the
parameters' placements (``opt_state_pspecs``: ZeRO, the state shards
like the parameters).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from .. import tree as tu
from ..obs.trace import spanned


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at_step(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * \
        0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    leaves = tu.leaves(params)
    device = leaves[0].device if leaves else "cpu"
    # zeros laid out like each parameter (a DTensor's placements too)
    zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)
    return {
        "m": tu.tree_map(zeros, params),
        "v": tu.tree_map(zeros, params),
        "master": tu.tree_map(
            lambda x: x.detach().to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_pspecs(param_pspecs: Any) -> Dict[str, Any]:
    """Optimizer state shards exactly like the parameters (ZeRO); the
    step replicates."""
    from ..dist.shardings import P
    return {"m": param_pspecs, "v": param_pspecs, "master": param_pspecs,
            "step": P()}


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient in its parameter's placements (the ZeRO
    reduce-scatter of a partial sum), so that the state and the update
    keep the parameter's layout; a plain gradient as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tu.leaves(tree)))


@spanned("train.optimizer")
@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    grads = tu.tree_map(_laid_out_as, grads, params)
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at_step(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v, master):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        new_master = master - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                    + cfg.weight_decay * master)
        return new_master.to(p.dtype), m, v, new_master

    flat_p, treedef = tu.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m = treedef.flatten_up_to(state["m"])
    flat_v = treedef.flatten_up_to(state["v"])
    flat_ma = treedef.flatten_up_to(state["master"])
    outs = [upd(p, g, m, v, ma) for p, g, m, v, ma
            in zip(flat_p, flat_g, flat_m, flat_v, flat_ma)]
    new_params = treedef.unflatten([o[0] for o in outs])
    new_state = {
        "m": treedef.unflatten([o[1] for o in outs]),
        "v": treedef.unflatten([o[2] for o in outs]),
        "master": treedef.unflatten([o[3] for o in outs]),
        "step": step,
    }
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
