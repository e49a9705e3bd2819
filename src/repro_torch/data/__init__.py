"""Deterministic synthetic data pipeline: pure numpy, the JAX package's
``repro.data`` kept as its own copy, so both packages read byte-identical
batches.

Stateless token generation (counter-based hashing): batch ``i`` of a
stream is a pure function of ``(seed, i, rank)``, so

* every data-parallel rank reads a disjoint shard with no coordination;
* exact resume after crash/restart needs only the step counter already
  carried by the checkpoint (the paper's durable ``cᵢ``) — no loader
  state to persist;
* duplicated replays (at-least-once delivery after recovery) reproduce
  byte-identical batches, keeping replayed training deterministic.
"""

from .synthetic import ShardedTokenStream, SyntheticLMStream

__all__ = ["ShardedTokenStream", "SyntheticLMStream"]
