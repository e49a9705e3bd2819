"""PyTorch + CUDA port of the δ-CRDT system (the JAX package ``repro`` is
its reference).

Subpackages mirror the JAX package's layout: ``core`` (lattices, keyed
store, digests, replica engine, simulator), ``kernels`` (hand-written
CUDA kernels, their plain versions, device-resident columns), ``wire``
(byte-identical frames and codec), ``lifecycle``, ``models`` and
``configs`` (the decoder stack and its architectures, serving path) and
``launch`` (``launch.serve``). ``convert`` carries store state, model
parameters and KV caches across from plain numpy data.

Entry points that place tensors take ``device`` (default ``"cuda"``);
pass ``device="cpu"`` to run the plain versions on the host.
"""
