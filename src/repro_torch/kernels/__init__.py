"""Hand-written CUDA kernels for the δ-CRDT hot loops, with their plain
PyTorch versions.

* ``delta_join``   — the four kernels' wrappers (``csrc/delta_join.cu``):
  versioned-chunk join, fused join + digest, scatter ingest, chunk digest.
* ``ops``          — the public wrappers with launch/transfer accounting.
* ``ref``          — the plain versions: the CPU path and the yardstick.
* ``resident``     — device-resident store columns built on the kernels.

Nothing is compiled at import: ``_build`` runs ``nvcc`` on first launch.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
