"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf] First layer keeps a dense MLP (first_k_dense=1,
dense d_ff=12288, per the published config)."""

from ..models.config import LayerSpec, MLASpec, ModelConfig, MoESpec

_LAYOUT = (LayerSpec(kind="mla", mlp="dense"),) + tuple(
    LayerSpec(kind="mla", mlp="moe") for _ in range(59))

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    layout=_LAYOUT,
    mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoESpec(num_experts=160, top_k=6, expert_d_ff=1536,
                num_shared_experts=2, shared_d_ff=1536),
    act="swiglu", norm="rms", pos="rope",
    subquadratic=False,  # MLA is full attention → skip long_500k
)

REDUCED = ModelConfig(
    name="deepseek-v2-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=89,
    layout=(LayerSpec(kind="mla", mlp="dense"),
            LayerSpec(kind="mla", mlp="moe")),
    mla=MLASpec(q_lora_rank=32, kv_lora_rank=16,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoESpec(num_experts=8, top_k=2, expert_d_ff=64,
                num_shared_experts=2, shared_d_ff=64,
                capacity_factor=float(8)),
    act="swiglu", norm="rms", pos="rope",
    subquadratic=False, dtype="float32",
)
