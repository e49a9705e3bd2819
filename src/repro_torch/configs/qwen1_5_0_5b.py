"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (MHA) d_ff=2816
vocab=151936, QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    act="swiglu", norm="rms", pos="rope",
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="qwen1.5-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=111,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    act="swiglu", norm="rms", pos="rope",
    subquadratic=False, dtype="float32",
)
