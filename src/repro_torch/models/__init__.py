"""Model stack of the port: one composable decoder, served by prefill and
decode steps (the JAX package's ``repro.models``, serving path)."""

from .config import (LayerSpec, MLASpec, ModelConfig, MoESpec, SSMSpec,
                     layout_groups)
from .transformer import (caches_max_len, decode_step, init_caches,
                          init_model, prefill)

__all__ = [
    "LayerSpec", "MLASpec", "ModelConfig", "MoESpec", "SSMSpec",
    "layout_groups", "caches_max_len", "decode_step", "init_caches",
    "init_model", "prefill",
]
