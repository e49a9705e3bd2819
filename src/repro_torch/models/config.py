"""Model configuration schema and layer-layout machinery (the port's own
copy of the JAX package's ``models/config.py``, field for field).

A ``ModelConfig`` fully describes one architecture (dense / GQA / MLA /
MoE / SSM / hybrid / VLM / audio backbones). The per-layer structure is a
list of ``LayerSpec``; ``layout_groups`` factors it into groups (smallest
repeating super-block, else runs of identical specs). The port runs each
group as a Python loop over its repeats, but keeps the grouping: layer
parameters and caches are stacked per group with a leading ``layers``
axis, so the two packages' parameter trees line up leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0          # per shared expert
    router_noise: float = 0.0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class MLASpec:
    """DeepSeek-V2 multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class LayerSpec:
    """One decoder block: attention (or SSM) + MLP (dense or MoE)."""
    kind: str = "attn"            # "attn" | "mla" | "ssm"
    window: Optional[int] = None  # sliding-window size (None = full/global)
    mlp: str = "dense"            # "dense" | "moe"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "dense"|"moe"|"ssm"|"hybrid"|"vlm"|"audio"
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attn-free
    n_kv_heads: int
    d_ff: int                     # dense-MLP hidden size (0 if none)
    vocab: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    layout: Tuple[LayerSpec, ...] = ()
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    mla: Optional[MLASpec] = None
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0       # partial rotary (stablelm: 0.25)
    attn_softcap: Optional[float] = None      # gemma2: 50.0
    final_softcap: Optional[float] = None     # gemma2: 30.0
    query_scale: Optional[float] = None       # gemma2: 1/sqrt(query_pre_attn)
    # block details
    norm: str = "rms"             # "rms" | "ln"
    act: str = "swiglu"           # "swiglu" | "geglu" | "gelu"
    post_norms: bool = False      # gemma2 post-attn/post-ffn norms
    pos: str = "rope"             # "rope" | "sinusoidal" | "none"
    scale_embed: bool = False     # gemma2: embed * sqrt(d_model)
    tie_embeddings: bool = False
    # modality frontend (STUB): inputs arrive as precomputed embeddings
    input_mode: str = "tokens"    # "tokens" | "embeds" | "tokens+prefix"
    prefix_len: int = 0           # vlm: number of patch-embedding positions
    # attention execution path: "naive" materializes [s,s] scores (plain
    # torch products); "chunked" is flash attention — on the card the
    # hand-written kernels of kernels/flash_attention, on the CPU their
    # plain tiled build (tile-skipped, online softmax)
    attn_impl: str = "naive"
    attn_block: int = 2048
    # MoE execution path: "global" single dispatch, "local" per-shard
    # dispatch under a mesh (the global one without)
    moe_impl: str = "global"
    # numerics
    dtype: str = "bfloat16"
    # long-context capability: True iff decode state is o(seq_len)
    subquadratic: bool = False

    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    def default_layout(self) -> Tuple[LayerSpec, ...]:
        if self.layout:
            return self.layout
        return tuple(LayerSpec() for _ in range(self.n_layers))

    # -- parameter count (for 6·N·D roofline bookkeeping) ---------------------
    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params_per_token)."""
        d, hd = self.d_model, (self.resolved_head_dim() if self.n_heads else 0)
        # active counts the LM-head matmul once; the token-embedding gather
        # is not a matmul (0 FLOPs), so it never enters MODEL_FLOPS
        total = self.vocab * d
        active = self.vocab * d
        if not self.tie_embeddings:
            total += self.vocab * d
        for spec in self.default_layout():
            t = a = 0
            if spec.kind == "attn":
                q = d * self.n_heads * hd + (self.n_heads * hd if self.qkv_bias else 0)
                kv = 2 * (d * self.n_kv_heads * hd + (self.n_kv_heads * hd if self.qkv_bias else 0))
                o = self.n_heads * hd * d
                t = a = q + kv + o
            elif spec.kind == "mla":
                m = self.mla
                qh = m.qk_nope_head_dim + m.qk_rope_head_dim
                t = a = (d * m.q_lora_rank
                         + m.q_lora_rank * self.n_heads * qh
                         + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                         + m.kv_lora_rank * self.n_heads
                         * (m.qk_nope_head_dim + m.v_head_dim)
                         + self.n_heads * m.v_head_dim * d)
            elif spec.kind == "ssm":
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                # in_proj (z,x,B,C,dt) + conv + out_proj + A,D
                t = a = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                         + s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                         + d_in * d + 2 * nh)
            if spec.mlp == "none":
                pass
            elif spec.mlp == "dense":
                gates = 2 if self.act in ("swiglu", "geglu") else 1
                t_mlp = (gates + 1) * d * self.d_ff
                t += t_mlp
                a += t_mlp
            elif spec.mlp == "moe":
                m = self.moe
                gates = 2 if self.act in ("swiglu", "geglu") else 1
                per_expert = (gates + 1) * d * m.expert_d_ff
                shared = m.num_shared_experts * (gates + 1) * d * m.shared_d_ff
                router = d * m.num_experts
                t += m.num_experts * per_expert + shared + router
                a += m.top_k * per_expert + shared + router
            total += t
            active += a
        return total, active


# ---------------------------------------------------------------------------
# Layout factoring into stacked layer groups
# ---------------------------------------------------------------------------

def layout_groups(layout: Sequence[LayerSpec]) -> List[Tuple[Tuple[LayerSpec, ...], int]]:
    """Factor the layer list into (super_block, repeats) groups.

    Preference order:
      1. smallest period p with layout[i] == layout[i mod p]  → one group,
         super-block of p layers repeated L/p times (gemma2 p=2, jamba p=8);
      2. otherwise runs of identical consecutive specs, each repeated
         (deepseek-v2: [dense]×1 + [moe]×59).

    Parameters and caches are stacked per group along a leading axis.
    """
    L = len(layout)
    # p == L is excluded: "repeating once" is no repetition, and accepting
    # it would unroll heterogeneous stacks (e.g. deepseek's 1+59 layout)
    # into one giant super-block.
    for p in range(1, L):
        if L % p != 0:
            continue
        if all(layout[i] == layout[i % p] for i in range(L)):
            return [(tuple(layout[:p]), L // p)]
    # runs fallback
    groups: List[Tuple[Tuple[LayerSpec, ...], int]] = []
    i = 0
    while i < L:
        j = i
        while j < L and layout[j] == layout[i]:
            j += 1
        groups.append(((layout[i],), j - i))
        i = j
    return groups
