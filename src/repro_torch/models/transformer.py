"""Decoder stack over ``LayerSpec`` layouts: training and serving.

* blocks: pre-norm attention, MLA or the SSD mixer + dense-or-MoE MLP,
  or no MLP (mamba2's pure mixer blocks) (+ gemma2-style post-norms),
  assembled per the config's layer layout;
* layer parameters are stacked per group of ``layout_groups`` with a
  leading ``layers`` axis, exactly as the JAX package stacks them for its
  ``lax.scan``; the port runs each group as a Python loop over its
  repeats, on views of the stacked tensors (in training the views come
  from one ``torch.unbind``, whose backward stacks the layers' gradients
  into the stacked parameter's);
* ``torch.utils.checkpoint`` (remat) around each repeated super-block in
  training, where the JAX package has ``jax.checkpoint``;
* entry points: ``forward`` / ``train_loss`` (full sequence),
  ``prefill`` (prompt → last-position logits and caches) and
  ``decode_step`` (one token against the caches).

``input_mode`` selects token embedding, raw embeddings (musicgen frames),
or token+prefix embeddings (phi-3-vision patches), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_map
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import LayerSpec, ModelConfig, layout_groups
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_tokens,
                     init_embedding, init_mlp, init_norm, lm_logits,
                     sinusoidal_positions)

AUX_LOSS_WEIGHT = 0.01


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
                dtype) -> Dict[str, Any]:
    dev = gen.device
    p: Dict[str, Any] = {"norm1": init_norm(cfg, cfg.d_model, dev)}
    if spec.kind == "attn":
        p["mix"] = attn_mod.init_attention(cfg, gen, dtype)
    elif spec.kind == "mla":
        p["mix"] = mla_mod.init_mla(cfg, gen, dtype)
    elif spec.kind == "ssm":
        p["mix"] = ssm_mod.init_ssm(cfg, gen, dtype)
    else:
        raise ValueError(spec.kind)
    if spec.mlp == "dense":
        p["norm2"] = init_norm(cfg, cfg.d_model, dev)
        p["mlp"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype)
    elif spec.mlp == "moe":
        p["norm2"] = init_norm(cfg, cfg.d_model, dev)
        p["mlp"] = moe_mod.init_moe(cfg, gen, dtype)
    elif spec.mlp != "none":   # "none": pure mixer block (mamba2)
        raise ValueError(spec.mlp)
    if cfg.post_norms:
        p["post_attn"] = init_norm(cfg, cfg.d_model, dev)
        p["post_mlp"] = init_norm(cfg, cfg.d_model, dev)
    return p


def _stack(trees: List[Any]) -> Any:
    """Stack equal-shaped trees (dicts of tensors) along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree: Any, r: int) -> Any:
    """Layer ``r``'s views of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree: Any, repeats: int) -> List[Any]:
    """Every layer's views of a stacked tree, from one ``torch.unbind``
    per leaf (``_layer`` for all ``r`` at once)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, repeats) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()}
                for r in range(repeats)]
    return list(torch.unbind(tree, 0))


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda"
               ) -> Dict[str, Any]:
    """Random parameters from ``seed`` (an explicit ``torch.Generator`` on
    ``device``), laid out as the JAX package's ``init_model``: ``embed``,
    ``final_norm`` and ``groups``, a list (one per layout group) of lists
    (one per layer of the group's super-block) of parameter dicts stacked
    over the group's repeats."""
    dtype = compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": init_embedding(cfg, gen, dtype),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
        "groups": [],
    }
    for block, repeats in layout_groups(cfg.default_layout()):
        # each repeat is copied into its slot of the stacked tensors as
        # soon as it is drawn: the peak is the model plus one super-block
        stacked = None
        for r in range(repeats):
            layer = [_init_layer(cfg, spec, gen, dtype) for spec in block]
            if stacked is None:
                stacked = tree_map(
                    lambda t: t.new_empty((repeats,) + tuple(t.shape)), layer)
            tree_map(lambda s, t, r=r: s[r].copy_(t), stacked, layer)
        params["groups"].append(stacked)
    return params


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                 x: torch.Tensor, positions: torch.Tensor, mode: str,
                 cache: Optional[Dict], cache_capacity: Optional[int]
                 ) -> Tuple[torch.Tensor, Optional[Dict],
                            Optional[torch.Tensor]]:
    """One decoder block. Returns (x, new_cache, aux_loss), the aux loss
    None for a block without MoE."""
    aux = None
    h = apply_norm(p["norm1"], x, cfg.norm)
    if spec.kind == "ssm":
        if mode == "decode":
            y, new_cache = ssm_mod.ssm_decode(p["mix"], cfg, h, cache)
        else:
            # prefill gives SSM layers a capacity of 0: build the cache
            # on the capacity's presence, not its truth
            y, new_cache = ssm_mod.ssm_full(
                p["mix"], cfg, h, make_cache=cache_capacity is not None)
    else:
        if spec.kind == "attn":
            full, step = attn_mod.attend_full, attn_mod.attend_decode
        elif spec.kind == "mla":
            full, step = mla_mod.mla_full, mla_mod.mla_decode
        else:
            raise ValueError(spec.kind)
        if mode == "decode":
            y, new_cache = step(p["mix"], cfg, spec, h, positions, cache)
        else:
            y, new_cache = full(p["mix"], cfg, spec, h, positions,
                                make_cache=cache_capacity)
    if cfg.post_norms:
        y = apply_norm(p["post_attn"], y, cfg.norm)
    x = x + y

    if spec.mlp == "none":
        return x, new_cache, aux
    h = apply_norm(p["norm2"], x, cfg.norm)
    if spec.mlp == "dense":
        y = apply_mlp(p["mlp"], h, cfg.act)
    else:
        y, aux = moe_mod.apply_moe(p["mlp"], cfg, h)
    if cfg.post_norms:
        y = apply_norm(p["post_mlp"], y, cfg.norm)
    return x + y, new_cache, aux


def _cache_capacity(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.kind == "ssm":
        return 0  # SSM caches are fixed-shape; capacity unused
    if spec.window is not None:
        return min(spec.window, max_len)
    return max_len


# ---------------------------------------------------------------------------
# Stack runner (a loop over the stacked layer groups)
# ---------------------------------------------------------------------------

def _run_stack(cfg: ModelConfig, params: Dict, x: torch.Tensor,
               positions: torch.Tensor, mode: str,
               caches: Optional[List] = None,
               max_len: Optional[int] = None, remat: bool = True
               ) -> Tuple[torch.Tensor, Optional[List], torch.Tensor]:
    """Returns ``(x, caches, aux)``. ``mode`` "train" runs the full
    sequence (each repeated super-block under ``checkpoint`` when
    ``remat``); "prefill" builds the caches (stacked per group as the JAX
    scan stacks them); "decode" updates ``caches`` in place and returns
    them. ``aux`` is the MoE load-balancing loss of a "train" run: per
    repeat the sum over the super-block's layers, summed over the
    repeats, then over the groups (the JAX package's order); 0 for the
    dense family and for the serving modes, which do not use it."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: List[Any] = []
    for gi, (block, repeats) in enumerate(layout_groups(
            cfg.default_layout())):
        stacked = params["groups"][gi]
        if mode == "train":
            per_layer = [_unstack(stacked[li], repeats)
                         for li in range(len(block))]

            def body(x, layer_params, block=block):
                aux_l = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
                for li, spec in enumerate(block):
                    x, _, aux = _apply_block(cfg, spec, layer_params[li], x,
                                             positions, mode, None, None)
                    if aux is not None:
                        aux_l = aux_l + aux
                return x, aux_l

            aux_stack = []
            for r in range(repeats):
                layer_params = [per_layer[li][r] for li in range(len(block))]
                x, aux_l = (checkpoint(body, x, layer_params,
                                       use_reentrant=False)
                            if remat else body(x, layer_params))
                aux_stack.append(aux_l)
            aux_total = aux_total + torch.stack(aux_stack).sum()
            continue
        group_cache = caches[gi] if caches is not None else None
        made: List[List[Dict]] = [[] for _ in block]
        for r in range(repeats):
            for li, spec in enumerate(block):
                c = (_layer(group_cache[li], r) if group_cache is not None
                     else None)
                cap = (_cache_capacity(cfg, spec, max_len)
                       if mode == "prefill" else None)
                x, nc, _ = _apply_block(cfg, spec, _layer(stacked[li], r),
                                        x, positions, mode, c, cap)
                made[li].append(nc)
        new_caches.append([_stack(m) for m in made] if mode == "prefill"
                          else group_cache)
    return x, (new_caches if mode != "train" else None), aux_total


# ---------------------------------------------------------------------------
# Inputs → hidden states
# ---------------------------------------------------------------------------

def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


def _inputs_to_hidden(cfg: ModelConfig, params: Dict, batch: Dict
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype = compute_dtype(cfg)
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(dtype)
        b, s = x.shape[0], x.shape[1]
        positions = batch.get("positions")
        if positions is None:
            positions = _arange_positions(b, s, x.device)
    elif cfg.input_mode == "tokens+prefix" and "prefix_embeds" in batch:
        prefix = batch["prefix_embeds"].to(dtype)
        tok = embed_tokens(params["embed"], cfg, batch["tokens"])
        x = torch.cat([prefix, tok], dim=1)
        b, s = x.shape[0], x.shape[1]
        positions = _arange_positions(b, s, x.device)
    else:
        x = embed_tokens(params["embed"], cfg, batch["tokens"])
        b, s = x.shape[0], x.shape[1]
        positions = batch.get("positions")
        if positions is None:
            positions = _arange_positions(b, s, x.device)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model, x.dtype)
    return x, positions


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (training). Returns (logits f32, aux_loss)."""
    x, positions = _inputs_to_hidden(cfg, params, batch)
    x, _, aux = _run_stack(cfg, params, x, positions, "train", remat=remat)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params["embed"], cfg, x), aux


def train_loss(cfg: ModelConfig, params: Dict, batch: Dict,
               remat: bool = True) -> torch.Tensor:
    logits, aux = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    if cfg.input_mode == "tokens+prefix":
        logits = logits[:, cfg.prefix_len:, :]  # loss on text positions only
    loss = cross_entropy(logits, labels, batch.get("loss_mask"))
    return loss + AUX_LOSS_WEIGHT * aux


def prefill(cfg: ModelConfig, params: Dict, batch: Dict, max_len: int
            ) -> Tuple[torch.Tensor, List]:
    """Run the prompt; returns (last-position logits [b, 1, vocab] f32,
    caches)."""
    x, positions = _inputs_to_hidden(cfg, params, batch)
    x, caches, _ = _run_stack(cfg, params, x, positions, "prefill",
                              max_len=max_len)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params["embed"], cfg, x[:, -1:, :]), caches


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                pos: torch.Tensor, caches: List
                ) -> Tuple[torch.Tensor, List]:
    """One decode step: tokens [b,1] (or embeds [b,1,d]), pos [b,1].
    The caches are updated in place (and returned)."""
    if cfg.input_mode == "embeds":
        batch = {"embeds": tokens, "positions": pos}
    else:
        batch = {"tokens": tokens, "positions": pos}
    x, positions = _inputs_to_hidden(cfg, params, batch)
    x, caches, _ = _run_stack(cfg, params, x, positions, "decode",
                              caches=caches)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params["embed"], cfg, x), caches


def caches_max_len(caches: List) -> int:
    """The most slots of any attention or MLA cache (1 if none: SSM
    caches carry no slots)."""
    best = 1
    for group in caches:
        if group is None:
            continue
        for c in group:
            if c is not None and "k" in c:
                best = max(best, c["k"].shape[2])   # [layers,b,C,kv,hd]
            elif c is not None and "ckv" in c:
                best = max(best, c["ckv"].shape[2])
    return best


def init_caches(cfg: ModelConfig, params: Dict, b: int, max_len: int,
                dtype=None) -> List:
    """Fresh (empty) caches shaped like prefill's output, on the
    parameters' device."""
    dtype = dtype or compute_dtype(cfg)
    device = params["embed"]["tok"].device
    caches = []
    for block, repeats in layout_groups(cfg.default_layout()):
        sub = []
        for spec in block:
            cap = _cache_capacity(cfg, spec, max_len)
            if spec.kind == "attn":
                c = attn_mod.init_kv_cache(b, cap, cfg.n_kv_heads,
                                           cfg.resolved_head_dim(), dtype,
                                           device)
            elif spec.kind == "mla":
                c = mla_mod.init_mla_cache(b, cap, cfg.mla, dtype, device)
            elif spec.kind == "ssm":
                c = ssm_mod.init_ssm_cache(cfg, b, dtype, device)
            else:
                raise ValueError(spec.kind)
            sub.append({k: v[None].repeat((repeats,) + (1,) * v.dim())
                        for k, v in c.items()})
        caches.append(sub)
    return caches
