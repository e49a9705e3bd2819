"""Weights drawn from the seed, on the device, in the tree the port takes.

Every leaf of every layer has its own generator, seeded from the run's
seed and the leaf's name, so the reference can draw any one layer again,
bit for bit, without the program's tensors. The tree is the one the
port's ``init_model`` lays out (``embed``, ``final_norm``, and
``groups[0][0]`` with each leaf stacked over the layers), since every
layer of a benchmark configuration is alike.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

# (path, per-layer shape, dtype name, kind, scale): kind "normal" draws
# scale·N(0, 1), "scale" 1 + scale·N(0, 1)
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, str, float]

NORM_JITTER = 0.1
SMALL = 0.02


def _norm_leaves(conf, where: Tuple[str, ...]) -> List[Leaf]:
    d = conf["d_model"]
    out = [(where + ("scale",), (d,), "float32", "scale", NORM_JITTER)]
    if conf["norm"] == "ln":
        out.append((where + ("bias",), (d,), "float32", "normal", SMALL))
    return out


def layer_leaves(conf: Dict[str, Any]) -> List[Leaf]:
    """One layer's leaves, paths relative to the layer."""
    d, H, KV, hd = (conf["d_model"], conf["n_heads"], conf["n_kv_heads"],
                    conf["head_dim"])
    dt = conf["dtype"]
    out = _norm_leaves(conf, ("norm1",))
    out += [(("mix", "wq"), (d, H * hd), dt, "normal", 1 / math.sqrt(d)),
            (("mix", "wk"), (d, KV * hd), dt, "normal", 1 / math.sqrt(d)),
            (("mix", "wv"), (d, KV * hd), dt, "normal", 1 / math.sqrt(d)),
            (("mix", "wo"), (H * hd, d), dt, "normal",
             1 / math.sqrt(H * hd))]
    if conf["qkv_bias"]:
        out += [(("mix", "bq"), (H * hd,), dt, "normal", SMALL),
                (("mix", "bk"), (KV * hd,), dt, "normal", SMALL),
                (("mix", "bv"), (KV * hd,), dt, "normal", SMALL)]
    out += _norm_leaves(conf, ("norm2",))
    if conf["mlp"] == "dense":
        ff = conf["d_ff"]
        out += [(("mlp", "wi"), (d, ff), dt, "normal", 1 / math.sqrt(d)),
                (("mlp", "wg"), (d, ff), dt, "normal", 1 / math.sqrt(d)),
                (("mlp", "wo"), (ff, d), dt, "normal", 1 / math.sqrt(ff))]
    else:
        m = conf["moe"]
        E, ff = m["num_experts"], m["expert_d_ff"]
        out += [(("mlp", "router"), (d, E), "float32", "normal",
                 1 / math.sqrt(d)),
                (("mlp", "wi"), (E, d, ff), dt, "normal", 1 / math.sqrt(d)),
                (("mlp", "wg"), (E, d, ff), dt, "normal", 1 / math.sqrt(d)),
                (("mlp", "wo"), (E, ff, d), dt, "normal",
                 1 / math.sqrt(ff))]
    return out


def top_leaves(conf: Dict[str, Any]) -> List[Leaf]:
    d, V, dt = conf["d_model"], conf["vocab"], conf["dtype"]
    out = [(("embed", "tok"), (V, d), dt, "normal", SMALL)]
    if not conf["tie_embeddings"]:
        out.append((("embed", "head"), (d, V), dt, "normal", SMALL))
    return out + _norm_leaves(conf, ("final_norm",))


def leaf_seed(seed: int, path: Tuple, layer: int) -> int:
    tag = f"{seed}/{'/'.join(str(k) for k in path)}/{layer}".encode()
    return int.from_bytes(hashlib.sha256(tag).digest()[:8], "little") \
        & (2 ** 63 - 1)


def draw(out: torch.Tensor, seed: int, path: Tuple[str, ...], layer: int,
         kind: str, scale: float) -> torch.Tensor:
    """Fill ``out`` in place with the leaf's values (one generator call)."""
    gen = torch.Generator(device=out.device)
    gen.manual_seed(leaf_seed(seed, path, layer))
    if kind == "scale":
        out.normal_(1.0, scale, generator=gen)
    else:
        out.normal_(0.0, scale, generator=gen)
    return out


def one(conf, seed: int, leaf: Leaf, layer: int, device) -> torch.Tensor:
    """One leaf of one layer (``layer`` -1: a leaf outside the layers)."""
    path, shape, dt, kind, scale = leaf
    t = torch.empty(shape, dtype=getattr(torch, dt), device=device)
    return draw(t, seed, path, layer, kind, scale)


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(conf: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The port's parameter tree, drawn on ``device``."""
    L = conf["n_layers"]
    params: Dict[str, Any] = {}
    for leaf in top_leaves(conf):
        _set(params, leaf[0], one(conf, seed, leaf, -1, device))
    layer: Dict[str, Any] = {}
    for path, shape, dt, kind, scale in layer_leaves(conf):
        stacked = torch.empty((L,) + shape, dtype=getattr(torch, dt),
                              device=device)
        for r in range(L):
            draw(stacked[r], seed, path, r, kind, scale)
        _set(layer, path, stacked)
    params["groups"] = [[layer]]
    return params


def leaf_paths(conf: Dict[str, Any]) -> Iterator[Tuple]:
    """Each leaf's path in the port's tree (stacked leaves under
    ``("groups", 0, 0)``)."""
    for leaf in top_leaves(conf):
        yield leaf[0]
    for leaf in layer_leaves(conf):
        yield ("groups", 0, 0) + leaf[0]


def initial_leaf(conf, seed: int, path: Tuple, device,
                 dtype=torch.float32) -> torch.Tensor:
    """A leaf of the initial tree, drawn again (stacked leaves whole)."""
    if path[0] == "groups":
        leaf = {lf[0]: lf for lf in layer_leaves(conf)}[tuple(path[3:])]
        return torch.stack([one(conf, seed, leaf, r, device)
                            for r in range(conf["n_layers"])]).to(dtype)
    leaf = {lf[0]: lf for lf in top_leaves(conf)}[tuple(path)]
    return one(conf, seed, leaf, -1, device).to(dtype)


SAMPLES = 4096


def sample_index(seed: int, path: Tuple, n: int, device) -> torch.Tensor:
    """The flat indices of a leaf of ``n`` entries at which gradients are
    compared: all of them up to ``SAMPLES``, else ``SAMPLES`` drawn from
    the seed."""
    if n <= SAMPLES:
        return torch.arange(n, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, ("sample",) + tuple(path), 0))
    return torch.randint(0, n, (SAMPLES,), generator=gen, device=device)


def get(tree: Any, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree
