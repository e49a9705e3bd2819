"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""

from ..models.config import LayerSpec, ModelConfig, MoESpec

_WINDOW = 4096

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    layout=tuple(LayerSpec(kind="attn", window=_WINDOW, mlp="moe")
                 for _ in range(56)),
    moe=MoESpec(num_experts=8, top_k=2, expert_d_ff=16384),
    act="swiglu", norm="rms", pos="rope", rope_theta=1e6,
    subquadratic=True,  # SWA: decode cache bounded by the window
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=97,
    layout=tuple(LayerSpec(kind="attn", window=16, mlp="moe")
                 for _ in range(2)),
    moe=MoESpec(num_experts=4, top_k=2, expert_d_ff=128,
                capacity_factor=float(4)),
    act="swiglu", norm="rms", pos="rope", rope_theta=1e6,
    subquadratic=True, dtype="float32",
)
