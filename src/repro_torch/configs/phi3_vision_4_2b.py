"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend (STUB: input_specs supplies
precomputed patch embeddings). [hf:microsoft/Phi-3-vision-128k-instruct]"""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    act="swiglu", norm="rms", pos="rope",
    input_mode="tokens+prefix", prefix_len=256,  # 256 patch positions
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="phi-3-vision-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=101,
    act="swiglu", norm="rms", pos="rope",
    input_mode="tokens+prefix", prefix_len=8,
    subquadratic=False, dtype="float32",
)
