"""The plain reference: the configurations' models, their loss, AdamW,
top-k with error feedback and the dot sum, in plain PyTorch.

Written from the published equations and the configuration files; it
imports nothing of the program and takes none of its tensors. It draws
the weights again from the seed (:mod:`.weights`), computes in float32
with TF32 off, and works through long inputs in blocks: a row at a time,
a block of queries at a time, a layer at a time when serving, each
layer's activations recomputed in the backward when training.

``quant="fp8"`` is the control: every product's operands rounded to
float8 (e4m3, one scale per row of the left operand and per column of
the right), the next precision below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import weights

F8_MAX = 448.0
Q_BLOCK = 1024


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """float32 products in float32 (TF32 off), the switches restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (the amax over ``dim`` maps to 448); the
    gradient passes through unchanged."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = F8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, quant: str) -> torch.Tensor:
    if quant == "fp8":
        return torch.matmul(fake_fp8(x, -1), fake_fp8(w, -2))
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str,
         eps: float) -> torch.Tensor:
    if kind == "rms":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
            * p["scale"]
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         pct: float) -> torch.Tensor:
    """x [T, H, hd]: the first ``rot`` dims rotate in adjacent pairs
    (2i, 2i+1) by pos · theta^(-2i/rot); the rest pass."""
    hd = x.shape[-1]
    rot = int(hd * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    i = torch.arange(0, rot, 2, dtype=torch.float64, device=x.device)
    ang = pos.to(torch.float64)[:, None] * (1.0 / theta ** (i / rot))
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    a, b = x[..., 0:rot:2], x[..., 1:rot:2]
    r = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
    return torch.cat([r.reshape(x.shape[:-1] + (rot,)), x[..., rot:]], -1)


def attention(conf: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor,
              quant: str) -> torch.Tensor:
    """One row's self-attention, h [T, d]: causal, each query seeing the
    keys less than ``window`` positions back, query head i reading KV
    head i // (H / KV); queries in blocks of ``Q_BLOCK``."""
    T = h.shape[0]
    H, KV, hd = conf["n_heads"], conf["n_kv_heads"], conf["head_dim"]
    q, k, v = mm(h, p["wq"], quant), mm(h, p["wk"], quant), \
        mm(h, p["wv"], quant)
    if conf["qkv_bias"]:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos = torch.arange(T, device=h.device)
    q = rope(q.reshape(T, H, hd), pos, conf["rope_theta"],
             conf["rotary_pct"])
    k = rope(k.reshape(T, KV, hd), pos, conf["rope_theta"],
             conf["rotary_pct"])
    v = v.reshape(T, KV, hd)
    k = k.repeat_interleave(H // KV, dim=1).transpose(0, 1)   # [H, T, hd]
    v = v.repeat_interleave(H // KV, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    window = conf.get("window")
    outs = []
    for a in range(0, T, Q_BLOCK):
        b = min(a + Q_BLOCK, T)
        lo = 0 if window is None else max(0, a - window + 1)
        sc = torch.matmul(q[:, a:b], k[:, lo:b].transpose(1, 2)) \
            / math.sqrt(hd)
        qp = pos[a:b, None]
        kp = pos[None, lo:b]
        keep = kp <= qp
        if window is not None:
            keep &= (qp - kp) < window
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(torch.matmul(torch.softmax(sc, -1), v[:, lo:b]))
    o = torch.cat(outs, dim=1).transpose(0, 1).reshape(T, H * hd)
    return mm(o, p["wo"], quant)


def dense_mlp(p: Dict[str, torch.Tensor], h: torch.Tensor,
              quant: str) -> torch.Tensor:
    return mm(F.silu(mm(h, p["wg"], quant)) * mm(h, p["wi"], quant),
              p["wo"], quant)


def moe_capacity(n_tokens: int, moe: Dict) -> int:
    return max(1, int(math.ceil(n_tokens * moe["top_k"] / moe["num_experts"]
                                * moe["capacity_factor"])))


def moe(conf: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor,
        quant: str) -> torch.Tensor:
    """One dispatch over the tokens h [N, d]: softmax router in f32, each
    token's top-k experts (ties to the lower index), gates renormalized
    over them; an expert takes its pairs in (token, k) order up to its
    capacity and the rest are dropped; the output is each kept pair's
    gated SwiGLU expert output, summed over the token's pairs."""
    m = conf["moe"]
    E, K = m["num_experts"], m["top_k"]
    N = h.shape[0]
    probs = torch.softmax(torch.matmul(h, p["router"]), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :K] / vals[:, :K].sum(-1, keepdim=True)
    ids = ids[:, :K].reshape(-1)                       # pair t·K + k
    onehot = F.one_hot(ids, E)
    rank = (onehot.cumsum(0) * onehot).sum(-1) - 1     # place in its expert
    kept = rank < moe_capacity(N, m)
    out = torch.zeros_like(h)
    tok = torch.arange(N * K, device=h.device) // K
    g = gates.reshape(-1)
    for e in range(E):
        sel = torch.nonzero(kept & (ids == e)).reshape(-1)
        if sel.numel() == 0:
            continue
        x = h[tok[sel]]
        y = mm(F.silu(mm(x, p["wg"][e], quant)) * mm(x, p["wi"][e], quant),
               p["wo"][e], quant)
        out.index_add_(0, tok[sel], y * g[sel, None])
    return out


# ---------------------------------------------------------------------------
# Serving: logits of a batch, prompt then served tokens, a layer at a time
# ---------------------------------------------------------------------------

def _layer_weights(conf, seed: int, layer: int, device) -> Dict:
    tree: Dict = {}
    for leaf in weights.layer_leaves(conf):
        t = weights.one(conf, seed, leaf, layer, device).float()
        node = tree
        for k in leaf[0][:-1]:
            node = node.setdefault(k, {})
        node[leaf[0][-1]] = t
    return tree


def _top(conf, seed: int, path: Tuple[str, ...], device) -> torch.Tensor:
    leaf = {lf[0]: lf for lf in weights.top_leaves(conf)}[path]
    return weights.one(conf, seed, leaf, -1, device).float()


def serve_logits(conf: Dict, seed: int, tokens: torch.Tensor, s: int,
                 quant: str = "f32") -> torch.Tensor:
    """Logits [B, T - s + 1, V] at positions s-1 .. T-1 of ``tokens``
    [B, T] (a prompt of ``s`` tokens, then the tokens served after it).
    The MoE dispatches as the served batch did: every prompt token of
    every row in one dispatch (row-major), then each later position's B
    tokens in one."""
    dev = tokens.device
    B, T = tokens.shape
    eps = conf["norm_eps"]
    with torch.no_grad(), exact_f32():
        x = _top(conf, seed, ("embed", "tok"), dev)[tokens]
        for layer in range(conf["n_layers"]):
            W = _layer_weights(conf, seed, layer, dev)
            h = norm(x, W["norm1"], conf["norm"], eps)
            for b in range(B):
                x[b] += attention(conf, W["mix"], h[b], quant)
            h = norm(x, W["norm2"], conf["norm"], eps)
            if conf["mlp"] == "dense":
                for b in range(B):
                    x[b] += dense_mlp(W["mlp"], h[b], quant)
            else:
                d = h.shape[-1]
                x[:, :s] += moe(conf, W["mlp"], h[:, :s].reshape(B * s, d),
                                quant).reshape(B, s, d)
                for t in range(s, T):
                    x[:, t] += moe(conf, W["mlp"], h[:, t], quant)
            del W, h
        fin = {"scale": _top(conf, seed, ("final_norm", "scale"), dev)}
        if conf["norm"] == "ln":
            fin["bias"] = _top(conf, seed, ("final_norm", "bias"), dev)
        x = norm(x[:, s - 1:], fin, conf["norm"], eps)
        head = (_top(conf, seed, ("embed", "tok"), dev).t()
                if conf["tie_embeddings"]
                else _top(conf, seed, ("embed", "head"), dev))
        return mm(x, head, quant)


# ---------------------------------------------------------------------------
# Training: loss, gradients and AdamW over the whole model in float32
# ---------------------------------------------------------------------------

def _block(conf: Dict, quant: str, x: torch.Tensor, *leaves) -> torch.Tensor:
    p = _unflat(conf, leaves)
    eps = conf["norm_eps"]
    x = x + attention(conf, p["mix"], norm(x, p["norm1"], conf["norm"], eps),
                      quant)
    h = norm(x, p["norm2"], conf["norm"], eps)
    if conf["mlp"] == "dense":
        return x + dense_mlp(p["mlp"], h, quant)
    return x + moe(conf, p["mlp"], h, quant)


def _unflat(conf: Dict, leaves) -> Dict:
    tree: Dict = {}
    for (path, *_), t in zip(weights.layer_leaves(conf), leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def row_loss(conf: Dict, params: Dict[Tuple, torch.Tensor],
             tokens: torch.Tensor, labels: torch.Tensor,
             quant: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of one row (tokens [T]), each layer
    recomputed in the backward."""
    eps = conf["norm_eps"]
    x = params[("embed", "tok")][tokens]
    order = [("groups", 0, 0) + lf[0] for lf in weights.layer_leaves(conf)]
    for layer in range(conf["n_layers"]):
        leaves = [params[p][layer] for p in order]
        x = checkpoint(_block, conf, quant, x, *leaves, use_reentrant=False)
    fin = {"scale": params[("final_norm", "scale")]}
    if conf["norm"] == "ln":
        fin["bias"] = params[("final_norm", "bias")]
    x = norm(x, fin, conf["norm"], eps)
    head = (params[("embed", "tok")].t() if conf["tie_embeddings"]
            else params[("embed", "head")])
    logits = mm(x, head, quant)
    return F.cross_entropy(logits, labels)


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to ``lr``, then a cosine decay to min_lr_frac·lr."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    t = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0), 1.0)
    lo = opt["min_lr_frac"] * lr
    return lo + (lr - lo) * 0.5 * (1.0 + math.cos(math.pi * t))


def train_steps(conf: Dict, seed: int, batches: Sequence[Dict], opt: Dict,
                quant: str = "f32", rows: Optional[int] = None) -> Dict:
    """AdamW steps from the initial weights over ``batches`` (each
    {"tokens", "labels"} [B, T]): the loss of each step, each leaf's norm
    of the first step's clipped gradient and its values at the entries
    ``weights.sample_index`` draws, and each leaf's norm of the change of
    the parameters after the last step. ``rows`` (a fault)
    takes only the first rows of each batch."""
    dev = batches[0]["tokens"].device
    paths = list(weights.leaf_paths(conf))
    with exact_f32():
        params = {p: weights.initial_leaf(conf, seed, p, dev)
                  .requires_grad_(True) for p in paths}
        m = {p: torch.zeros_like(t) for p, t in params.items()}
        v = {p: torch.zeros_like(t) for p, t in params.items()}
        losses, grad_norms, grad_samples = [], None, None
        for step, batch in enumerate(batches, start=1):
            n = rows or batch["tokens"].shape[0]
            total = 0.0
            for r in range(n):
                loss = row_loss(conf, params, batch["tokens"][r],
                                batch["labels"][r], quant) / n
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                gnorm = math.sqrt(sum(float((t.grad * t.grad).sum())
                                      for t in params.values()))
                scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
                if step == 1:
                    grad_norms = {p: float(t.grad.norm()) * scale
                                  for p, t in params.items()}
                    grad_samples = {
                        p: (t.grad.reshape(-1)[weights.sample_index(
                            seed, p, t.numel(), dev)] * scale).cpu()
                        for p, t in params.items()}
                lr = lr_at(opt, step)
                b1, b2 = opt["b1"], opt["b2"]
                for p, t in params.items():
                    g = t.grad * scale
                    m[p].mul_(b1).add_(g, alpha=1 - b1)
                    v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[p] / (1 - b1 ** step)
                    vhat = v[p] / (1 - b2 ** step)
                    t.sub_(lr * (mhat / (vhat.sqrt() + opt["eps"])
                                 + opt["weight_decay"] * t))
                    t.grad = None
        del m, v
        with torch.no_grad():
            update_norms = {}
            for p in paths:
                init = weights.initial_leaf(conf, seed, p, dev)
                update_norms[p] = float((params[p] - init).norm())
    return {"losses": losses, "grad_norms": grad_norms,
            "grad_samples": grad_samples, "update_norms": update_norms}


# ---------------------------------------------------------------------------
# Top-k with error feedback, and the sum of dots
# ---------------------------------------------------------------------------

def topk_keep(x: torch.Tensor, rate: float) -> Tuple[torch.Tensor, int]:
    """The flat indices of the round(rate·n) entries of largest magnitude
    (at least one; ties to the lower index), and that count."""
    flat = x.reshape(-1)
    k = max(1, min(int(round(rate * flat.numel())), flat.numel()))
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    return order[:k], k


def error_feedback(update: torch.Tensor, residual: torch.Tensor,
                   rate: float) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(kept indices, kept values, new residual) of one leaf: the round's
    update plus the carried residual, its top-k shipped and the rest
    carried on."""
    carried = update + residual
    idx, _ = topk_keep(carried, rate)
    vals = carried.reshape(-1)[idx]
    left = carried.clone()
    left.reshape(-1)[idx] = 0
    return idx, vals, left


def dot_sum(init: torch.Tensor, dots: List[Tuple[torch.Tensor,
                                                 torch.Tensor]],
            scale: float) -> torch.Tensor:
    """init + scale · Σ over dots of each dot's sparse update (indices,
    values) laid out dense, in float32."""
    total = torch.zeros(init.numel(), dtype=torch.float32,
                        device=init.device)
    for idx, vals in dots:
        total.index_add_(0, idx.long(), vals.float())
    return init.float() + scale * total.reshape(init.shape)
