"""Counter-based synthetic LM token streams (stateless, shardable)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


def _philox_tokens(seed: int, stream: int, n: int, vocab: int) -> np.ndarray:
    """Deterministic tokens from a counter-based RNG (no sequential state)."""
    gen = np.random.Generator(np.random.Philox(key=seed, counter=[stream, 0, 0, 0]))
    return gen.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32)


@dataclass
class SyntheticLMStream:
    """Markov-flavoured synthetic LM data: tokens with local structure so a
    model can actually reduce loss (pure uniform noise cannot be learned).

    token[t] = (token[t-1] + 1 + token[t-1] mod 7) mod vocab with sparse
    random resets — the next token is a DETERMINISTIC function of the
    previous one except at resets (P ≈ 1/97), so the achievable loss is
    ≈ ln(vocab)/97 ≈ 0.1 and a small model's curve visibly plunges within
    tens of steps (examples/train_delta_sync.py).
    """

    vocab: int
    seq: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, rank: int = 0) -> Dict[str, np.ndarray]:
        stream = (step << 16) | rank
        raw = _philox_tokens(self.seed, stream,
                             self.batch * (self.seq + 1), self.vocab)
        raw = raw.reshape(self.batch, self.seq + 1)
        reset = (raw % 97) == 0              # occasional random jumps
        toks = np.zeros_like(raw)
        toks[:, 0] = raw[:, 0] % self.vocab
        for t in range(1, self.seq + 1):
            prev = toks[:, t - 1]
            stepped = (prev + 1 + prev % 7) % self.vocab
            toks[:, t] = np.where(reset[:, t], raw[:, t] % self.vocab, stepped)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class ShardedTokenStream:
    """Per-rank disjoint shard of a global stream: rank r of W reads
    global batch rows [r·b/W, (r+1)·b/W) — same data layout the sharded
    train_step consumes, generated locally with zero coordination."""

    base: SyntheticLMStream
    rank: int
    world: int

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        full = self.base.batch_at(step)
        b = self.base.batch
        assert b % self.world == 0
        lo = self.rank * (b // self.world)
        hi = lo + b // self.world
        return {k: v[lo:hi] for k, v in full.items()}
