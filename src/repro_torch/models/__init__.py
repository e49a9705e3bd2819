"""Model stack of the port: one composable decoder, trained by
``train_loss`` and served by prefill and decode steps (the JAX package's
``repro.models``)."""

from .config import (LayerSpec, MLASpec, ModelConfig, MoESpec, SSMSpec,
                     layout_groups)
from .transformer import (caches_max_len, decode_step, forward,
                          init_caches, init_model, prefill, train_loss)

__all__ = [
    "LayerSpec", "MLASpec", "ModelConfig", "MoESpec", "SSMSpec",
    "layout_groups", "caches_max_len", "decode_step", "forward",
    "init_caches", "init_model", "prefill", "train_loss",
]
