"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    act="swiglu", norm="rms", pos="rope",
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="qwen2-reduced", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
    d_ff=96, vocab=103,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    act="swiglu", norm="rms", pos="rope",
    subquadratic=False, dtype="float32",
)
