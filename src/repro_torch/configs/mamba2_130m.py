"""mamba2-130m [ssm] — 24L d_model=768, attn-free, ssm_state=128, SSD
(state-space duality). [arXiv:2405.21060; unverified] Pure mixer blocks
(no MLP), tied embeddings."""

from ..models.config import LayerSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    layout=tuple(LayerSpec(kind="ssm", mlp="none") for _ in range(24)),
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64,
                n_groups=1, chunk=256),
    act="swiglu", norm="rms", pos="none", tie_embeddings=True,
    subquadratic=True,  # O(1)-in-seq decode state → runs long_500k
)

REDUCED = ModelConfig(
    name="mamba2-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=89,
    layout=tuple(LayerSpec(kind="ssm", mlp="none") for _ in range(2)),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=16,
                n_groups=1, chunk=8),
    act="swiglu", norm="rms", pos="none", tie_embeddings=True,
    subquadratic=True, dtype="float32",
)
