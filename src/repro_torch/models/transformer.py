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
  ``decode_step`` (one token against the caches);
* on a mesh (``DTensor`` parameters placed by ``dist.shardings`` from
  :func:`logical_specs`, rules installed by ``hints.activation_rules``)
  the same entry points run sharded: activations pinned by the
  reference's hints (and one after the mixer's residual), each mixer on
  its rank's shards (:func:`_mix`).

``input_mode`` selects token embedding, raw embeddings (musicgen frames),
or token+prefix embeddings (phi-3-vision patches), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..obs.trace import spanned
from ..tree import flatten, tree_map
from . import attention as attn_mod
from . import hints
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import LayerSpec, ModelConfig, layout_groups
from .hints import even, hint, on_shards
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_tokens,
                     embedding_specs, init_embedding, init_mlp, init_norm,
                     lm_logits, mlp_specs, norm_specs, sinusoidal_positions)

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


class _Shapes:
    """Stands in for the generator on ``meta``: ``_normal`` then draws
    nothing and gives the shape alone."""

    device = torch.device("meta")


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda"
               ) -> Dict[str, Any]:
    """Random parameters from ``seed`` (an explicit ``torch.Generator`` on
    ``device``), laid out as the JAX package's ``init_model``: ``embed``,
    ``final_norm`` and ``groups``, a list (one per layout group) of lists
    (one per layer of the group's super-block) of parameter dicts stacked
    over the group's repeats. On ``device="meta"`` the same tree of
    shapes and dtypes, with no data and no generator (the dry-run's)."""
    dtype = compute_dtype(cfg)
    gen = (_Shapes() if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
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


def _layer_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": norm_specs(cfg)}
    if spec.kind == "attn":
        s["mix"] = attn_mod.attention_specs(cfg)
    elif spec.kind == "mla":
        s["mix"] = mla_mod.mla_specs(cfg)
    elif spec.kind == "ssm":
        s["mix"] = ssm_mod.ssm_specs(cfg)
    else:
        raise ValueError(spec.kind)
    if spec.mlp in ("dense", "moe"):
        s["norm2"] = norm_specs(cfg)
        s["mlp"] = (mlp_specs(cfg) if spec.mlp == "dense"
                    else moe_mod.moe_specs(cfg))
    elif spec.mlp != "none":
        raise ValueError(spec.mlp)
    if cfg.post_norms:
        s["post_attn"] = norm_specs(cfg)
        s["post_mlp"] = norm_specs(cfg)
    return s


def logical_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree of logical axis names of ``init_model(cfg)``'s
    parameters, leaf for leaf (a tuple of names, ``None`` for a dim no
    rule shards): the second result of the JAX package's ``init_model``,
    from the config alone. Stacked layers carry a leading ``"layers"``."""
    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("layers",) + tuple(tree)

    return {
        "embed": embedding_specs(cfg),
        "final_norm": norm_specs(cfg),
        "groups": [[stacked(_layer_specs(cfg, spec)) for spec in block]
                   for block, _ in layout_groups(cfg.default_layout())],
    }


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

# the keys of each mixer's cache, in the sorted order they cross a
# ``local_map`` boundary
_CACHE_KEYS = {"attn": ("idx", "k", "pos", "v"),
               "mla": ("ckv", "idx", "krope", "pos"),
               "ssm": ("conv", "idx", "ssm")}


def _cache_axes(key: str, batch: Optional[str], heads: Optional[str]
                ) -> Tuple[Optional[str], ...]:
    """Logical layout of one cache tensor of a layer: the batch, and the
    KV heads of an attention ring ``[b, C, KV, hd]``."""
    if key == "idx":
        return ()
    if key in ("k", "v"):
        return (batch, None, heads, None)
    return (batch,) + (None,) * {"pos": 1, "ckv": 2, "krope": 2,
                                 "conv": 2, "ssm": 3}[key]


def _mixer_layout(cfg: ModelConfig, spec: LayerSpec, b: int):
    """(batch axis, heads axis, the config the shards see) of a mixer
    under the installed mesh: the batch over the data axes, attention and
    MLA heads over "model" with the config's head counts cut to one
    rank's; where a count does not divide, that dim replicates
    (recorded). The SSD mixer's fused [x | B | C] projection has no even
    split by heads: it runs replicated over "model" (recorded)."""
    batch = even("batch", b, what=f"{spec.kind} mixer batch")
    if spec.kind == "ssm":
        if hints.axis_size("heads") > 1:
            hints.record_fallback("ssm mixer: replicated over the heads "
                                  "axis")
        return batch, None, cfg
    kv = cfg.n_kv_heads if spec.kind == "attn" else cfg.n_heads
    heads = even("heads", cfg.n_heads, kv, what=f"{spec.kind} heads")
    if heads is None:
        return batch, None, cfg
    n = hints.axis_size("heads")
    local = {"n_heads": cfg.n_heads // n}
    if spec.kind == "attn":
        local.update(n_kv_heads=cfg.n_kv_heads // n,
                     head_dim=cfg.resolved_head_dim())
    return batch, heads, dataclasses.replace(cfg, **local)


def cache_axes(cfg: ModelConfig, b: int) -> List:
    """The logical layout of ``init_caches(cfg, ..., b, ...)``'s tensors
    under the installed mesh, leaf for leaf (a leading ``None`` for the
    stacked layers): what the mixers' shards read and write in place."""
    out = []
    for block, _ in layout_groups(cfg.default_layout()):
        sub = []
        for spec in block:
            batch, heads, _ = _mixer_layout(cfg, spec, b)
            sub.append({k: (None,) + _cache_axes(k, batch, heads)
                        for k in _CACHE_KEYS[spec.kind]})
        out.append(sub)
    return out


def _run_mixer(cfg: ModelConfig, spec: LayerSpec, p: Dict, h, positions,
               mode: str, cache: Optional[Dict],
               cache_capacity: Optional[int]):
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
    return y, new_cache


def _mix(cfg: ModelConfig, spec: LayerSpec, p: Dict, h, positions,
         mode: str, cache: Optional[Dict], cache_capacity: Optional[int]):
    """The block's mixer (attention, MLA or SSD): ``_run_mixer``, and
    under a mesh the same code on each rank's shards
    (``hints.on_shards``, laid out by :func:`_mixer_layout`), so that the
    flash kernels and the in-place ring writes see plain tensors. Heads
    over "model" leave each rank a partial sum of the output projection.
    """
    if hints.current_rules() is None:
        return _run_mixer(cfg, spec, p, h, positions, mode, cache,
                          cache_capacity)
    batch, heads, lcfg = _mixer_layout(cfg, spec, h.shape[0])
    names = {"attn": attn_mod.attention_specs, "mla": mla_mod.mla_specs,
             "ssm": ssm_mod.ssm_specs}[spec.kind](cfg)
    p_leaves, p_def = flatten(p["mix"])
    p_axes = [tuple(heads if n in ("heads", "kv") else None for n in ax)
              for ax in p_def.flatten_up_to(names)]
    keys = _CACHE_KEYS[spec.kind]
    c_leaves = [cache[k] for k in keys] if mode == "decode" else []
    c_axes = [_cache_axes(k, batch, heads) for k in keys]
    y_axes = (hints.Summed((batch, None, None)) if heads is not None
              else (batch, None, None))

    def local(h, positions, *leaves):
        pl = {"mix": p_def.unflatten(leaves[:len(p_leaves)])}
        cl = (dict(zip(keys, leaves[len(p_leaves):])) if mode == "decode"
              else None)
        y, nc = _run_mixer(lcfg, spec, pl, h, positions, mode, cl,
                           cache_capacity)
        return (y,) + (tuple(nc[k] for k in keys)
                       if mode == "prefill" else ())

    out = on_shards(local, [h, positions] + p_leaves + c_leaves,
                    [(batch, None, None), (batch, None)] + p_axes + c_axes,
                    [y_axes] + (c_axes if mode == "prefill" else []),
                    inplace=range(2 + len(p_leaves),
                                  2 + len(p_leaves) + len(c_leaves)))
    if mode == "prefill":
        return out[0], dict(zip(keys, out[1:]))
    return out[0], cache


def _apply_block(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                 x: torch.Tensor, positions: torch.Tensor, mode: str,
                 cache: Optional[Dict], cache_capacity: Optional[int]
                 ) -> Tuple[torch.Tensor, Optional[Dict],
                            Optional[torch.Tensor]]:
    """One decoder block. Returns (x, new_cache, aux_loss), the aux loss
    None for a block without MoE."""
    aux = None
    x = hint(x, ("batch", None, None))
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, new_cache = _mix(cfg, spec, p, h, positions, mode, cache,
                        cache_capacity)
    if cfg.post_norms:
        y = apply_norm(p["post_attn"], y, cfg.norm)
    # under a mesh the mixer's output is a partial sum over the heads
    # axis: reduce it here, so that the MLP reads the batch-sharded
    # activations (else its products gather the activations, not the
    # weights); a no-op without a mesh
    x = hint(x + y, ("batch", None, None))

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

            rules = hints.current_rules()

            def body(x, layer_params, block=block):
                # the recompute runs on autograd's device thread, which
                # does not see this thread's mesh rules: put them back
                with hints.reinstalled(rules):
                    aux_l = torch.zeros((), dtype=torch.float32,
                                        device=x.device)
                    for li, spec in enumerate(block):
                        x, _, aux = _apply_block(cfg, spec, layer_params[li],
                                                 x, positions, mode, None,
                                                 None)
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
    batch = {k: hints.on_mesh(v) for k, v in batch.items()}
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
    positions = hints.on_mesh(positions)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model, x.dtype)
    x = hint(x, ("batch", None, None))
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


@spanned("prefill")
def prefill(cfg: ModelConfig, params: Dict, batch: Dict, max_len: int
            ) -> Tuple[torch.Tensor, List]:
    """Run the prompt; returns (last-position logits [b, 1, vocab] f32,
    caches)."""
    x, positions = _inputs_to_hidden(cfg, params, batch)
    x, caches, _ = _run_stack(cfg, params, x, positions, "prefill",
                              max_len=max_len)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params["embed"], cfg, x[:, -1:, :]), caches


@spanned("decode_step")
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
