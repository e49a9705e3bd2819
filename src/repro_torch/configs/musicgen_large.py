"""musicgen-large [audio] — 48L d_model=2048 32H (MHA) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]
Backbone only: the EnCodec frontend is a STUB — input_specs() supplies
precomputed frame embeddings; LN + GELU + sinusoidal positions."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    act="gelu", norm="ln", pos="sinusoidal",
    input_mode="embeds",
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="musicgen-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=64,
    act="gelu", norm="ln", pos="sinusoidal",
    input_mode="embeds",
    subquadratic=False, dtype="float32",
)
