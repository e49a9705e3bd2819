"""Assigned input-shape cases and per-(arch × shape) input specs.

The four LM shape cells (seq_len × global_batch):

    train_4k      4,096 × 256    → traces train_step
    prefill_32k   32,768 × 32    → traces serve prefill
    decode_32k    32,768 × 128   → traces serve_step (1 token + 32k cache)
    long_500k     524,288 × 1    → traces serve_step; sub-quadratic archs
                                   only (cfg.subquadratic)

``input_specs`` returns ``meta`` tensors (shapes and dtypes, no storage)
for the dry-run, the decode caches from ``init_caches`` on ``meta``
parameters; ``smoke_batch`` builds tiny concrete batches for the per-arch
CPU smoke tests, drawn from numpy exactly as the JAX package draws them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models import ModelConfig, init_caches, init_model


@dataclass(frozen=True)
class ShapeCase:
    name: str
    seq: int
    batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPE_CASES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, case: ShapeCase) -> Tuple[bool, str]:
    """Whether this (arch × shape) cell runs, and why not if it doesn't."""
    if case.name == "long_500k" and not cfg.subquadratic:
        return False, (f"{cfg.name}: full-attention decode state at 512k "
                       "context is not sub-quadratic — skipped per the "
                       "assignment (DESIGN.md §Arch-applicability)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, case: ShapeCase) -> Dict[str, Any]:
    """``meta``-tensor tree of the step function's inputs for this cell."""
    b, s = case.batch, case.seq
    f = getattr(torch, cfg.dtype)
    tok = torch.int32
    if case.step in ("train", "prefill"):
        if cfg.input_mode == "embeds":
            batch = {"embeds": _meta((b, s, cfg.d_model), f)}
            if case.step == "train":
                batch["labels"] = _meta((b, s), tok)
        elif cfg.input_mode == "tokens+prefix":
            st = s - cfg.prefix_len
            batch = {"tokens": _meta((b, st), tok),
                     "prefix_embeds": _meta((b, cfg.prefix_len, cfg.d_model),
                                            f)}
            if case.step == "train":
                batch["labels"] = _meta((b, st), tok)
        else:
            batch = {"tokens": _meta((b, s), tok)}
            if case.step == "train":
                batch["labels"] = _meta((b, s), tok)
        return batch

    # decode: one new token against a seq-length cache
    if cfg.input_mode == "embeds":
        token = _meta((b, 1, cfg.d_model), f)
    else:
        token = _meta((b, 1), tok)
    caches = init_caches(cfg, init_model(cfg, device="meta"), b, s)
    return {"tokens": token, "pos": _meta((b, 1), tok), "caches": caches}


# ---------------------------------------------------------------------------
# Concrete tiny batches for smoke tests
# ---------------------------------------------------------------------------

def _floats(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _ints(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def smoke_batch(cfg: ModelConfig, b: int = 2, s: int = 16,
                seed: int = 0, train: bool = True) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    f = getattr(torch, cfg.dtype)
    if cfg.input_mode == "embeds":
        batch = {"embeds": _floats(rng.normal(size=(b, s, cfg.d_model)), f)}
        if train:
            batch["labels"] = _ints(rng.integers(0, cfg.vocab, size=(b, s)))
    elif cfg.input_mode == "tokens+prefix":
        st = s - cfg.prefix_len
        if st <= 0:
            raise ValueError(f"{s} positions leave no text after the "
                             f"{cfg.prefix_len}-position prefix")
        batch = {
            "tokens": _ints(rng.integers(0, cfg.vocab, size=(b, st))),
            "prefix_embeds": _floats(
                rng.normal(size=(b, cfg.prefix_len, cfg.d_model)), f),
        }
        if train:
            batch["labels"] = _ints(rng.integers(0, cfg.vocab, size=(b, st)))
    else:
        batch = {"tokens": _ints(rng.integers(0, cfg.vocab, size=(b, s)))}
        if train:
            batch["labels"] = _ints(rng.integers(0, cfg.vocab, size=(b, s)))
    return batch
