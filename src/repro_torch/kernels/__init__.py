"""Hand-written CUDA kernels for the δ-CRDT hot loops and for attention,
with their plain PyTorch versions.

* ``delta_join``   — the four kernels' wrappers (``csrc/delta_join.cu``):
  versioned-chunk join, fused join + digest, scatter ingest, chunk digest.
* ``flash_attention`` — the two attention kernels' wrappers
  (``csrc/flash_attention.cu``): causal prefill and ring-cache decode.
* ``ops``          — the public wrappers with launch/transfer accounting.
* ``ref``          — the plain versions: the CPU path and the yardstick.
* ``resident``     — device-resident store columns built on the kernels.

Nothing is compiled at import: ``_build`` runs ``nvcc`` on first launch.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
