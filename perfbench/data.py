"""Inputs drawn from the seed: token batches and prompts.

Every seed gets the same work: the same batch shapes and the same
schedule of prompt lengths, with its own tokens. (An order of lengths
drawn from the seed moved the batch that the window's end cuts, and
with it the tokens per second, by 8% between seeds on an H100.)
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List

import torch


def _seed(*parts) -> int:
    tag = "/".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(tag).digest()[:8], "little") \
        & (2 ** 63 - 1)


def tokens(seed: int, tag: str, shape, vocab: int, device) -> torch.Tensor:
    """Token ids uniform over the vocabulary (int64), one generator call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, tag))
    return torch.randint(0, vocab, tuple(shape), generator=gen,
                         device=device)


def train_batch(seed: int, rank: int, step: int, batch: int, seq: int,
                vocab: int, device) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s batch of step ``step``: ``batch`` rows of ``seq``
    tokens and their next tokens as labels (rows of seq + 1 drawn once)."""
    rows = tokens(seed, f"train/{rank}/{step}", (batch, seq + 1), vocab,
                  device)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def prompt_lengths(lengths: List[int]) -> Iterator[int]:
    """Endless cycles of ``lengths`` in the mix's order."""
    while True:
        yield from lengths


def prompt(seed: int, index: int, batch: int, length: int, vocab: int,
           device) -> torch.Tensor:
    return tokens(seed, f"prompt/{index}", (batch, length), vocab, device)
