"""Optimizer substrate: AdamW with fp32 master weights, global-norm
clipping, warmup+cosine schedule. Plain functions over pytrees of
tensors (the JAX package's ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_update, init_opt_state, lr_at_step,
                    opt_state_pspecs)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_at_step",
           "opt_state_pspecs"]
