"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA) d_ff=5632
vocab=100352. LayerNorm + partial rotary (25%), QKV bias per the published
stablelm-2-1_6b config. [hf:stabilityai/stablelm-2-1_6b; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    qkv_bias=True, rotary_pct=0.25,
    act="swiglu", norm="ln", pos="rope",
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="stablelm-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=97,
    qkv_bias=True, rotary_pct=0.25,
    act="swiglu", norm="ln", pos="rope",
    subquadratic=False, dtype="float32",
)
