"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2; Mamba+attention 1:7 interleave (attention at
layer offset 4, period 8) and MoE every 2nd layer (offset 1, period 2).
[arXiv:2403.19887; hf] Jamba's Mamba-1 layers are mapped to the SSD block
(DESIGN.md §changed-assumptions)."""

from ..models.config import LayerSpec, ModelConfig, MoESpec, SSMSpec

_LAYOUT = tuple(
    LayerSpec(kind=("attn" if i % 8 == 4 else "ssm"),
              mlp=("moe" if i % 2 == 1 else "dense"))
    for i in range(32))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    layout=_LAYOUT,
    moe=MoESpec(num_experts=16, top_k=2, expert_d_ff=14336),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=64,
                n_groups=1, chunk=256),
    act="swiglu", norm="rms", pos="none",  # jamba uses no positional emb
    subquadratic=True,  # SSM-dominant: runs long_500k
)

REDUCED = ModelConfig(
    name="jamba-reduced", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=91,
    layout=tuple(
        LayerSpec(kind=("attn" if i % 4 == 2 else "ssm"),
                  mlp=("moe" if i % 2 == 1 else "dense"))
        for i in range(4)),
    moe=MoESpec(num_experts=4, top_k=2, expert_d_ff=128,
                capacity_factor=float(4)),
    ssm=SSMSpec(d_state=8, d_conv=4, expand=2, head_dim=16,
                n_groups=1, chunk=8),
    act="swiglu", norm="rms", pos="none",
    subquadratic=True, dtype="float32",
)
