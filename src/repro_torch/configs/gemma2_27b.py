"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local(4096-window)/global alternating attention, attn/final
logit softcaps, pre+post norms, GeGLU, scaled+tied embeddings.
[arXiv:2408.00118; hf] query_pre_attn_scalar=144 → query scale 144^-1/2."""

from ..models.config import LayerSpec, ModelConfig

_LAYOUT = tuple(
    LayerSpec(kind="attn", window=(4096 if i % 2 == 0 else None),
              mlp="dense")
    for i in range(46))

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    layout=_LAYOUT,
    attn_softcap=50.0, final_softcap=30.0, query_scale=144.0 ** -0.5,
    act="geglu", norm="rms", post_norms=True, pos="rope",
    scale_embed=True, tie_embeddings=True,
    subquadratic=False,  # global layers keep full KV → skip long_500k
)

REDUCED = ModelConfig(
    name="gemma2-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=93,
    layout=(LayerSpec(kind="attn", window=16, mlp="dense"),
            LayerSpec(kind="attn", window=None, mlp="dense")),
    attn_softcap=50.0, final_softcap=30.0, query_scale=16.0 ** -0.5,
    act="geglu", norm="rms", post_norms=True, pos="rope",
    scale_embed=True, tie_embeddings=True,
    subquadratic=False, dtype="float32",
)
