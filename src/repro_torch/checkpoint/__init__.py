"""Delta-interval incremental checkpointing (Algorithm 2 semantics on disk).

The checkpoint directory plays the role of the paper's durable storage
(§2: "durable state is written atomically at each state transition"):
a full ``TensorState`` snapshot at sequence ``c₀`` plus a log of delta
files ``c₀+1 .. c``; restore is ``snapshot ⊔ d₁ ⊔ … ⊔ dₖ`` — joins are
idempotent, so replaying a suffix after a partial restore is harmless,
and a crash mid-write leaves only an ignored temp file (atomic rename).
A directory written by the JAX package restores here, and the reverse.
"""

from .store import (DeltaCheckpointStore, pytree_from_state, pytree_spec,
                    state_from_pytree)

__all__ = ["DeltaCheckpointStore", "pytree_from_state", "pytree_spec",
           "state_from_pytree"]
