"""Public kernel wrappers with launch and transfer accounting.

Each wrapper records the launch and calls :mod:`.delta_join` or
:mod:`.flash_attention` (the δ-CRDT wrappers first stage their operands
onto one device), which pick the route from the tensors' device: the
card launches the hand-written kernel (or raises), the CPU runs the
plain version. Nothing here asks whether a card exists.

:data:`counters` is process-wide accounting of wrapper-level launches
(one fused pipeline == one launch, whichever route ran) and of bytes
staged host→device. A numpy operand always counts as staged — it is
host memory by construction — and so does a CPU tensor handed to a
launch on the card. An operand already on the launch's device costs
nothing: that is what makes the device-resident store measurable, since
its steady-state rounds launch O(1) kernels over columns that never
leave the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import delta_join as _dj
from . import flash_attention as _fa
from . import ref
from ..dtypes import common_device, to_torch


class KernelCounters:
    """Process-wide kernel-launch and host↔device byte accounting.

    ``launches`` counts wrapper-level dispatches, ``h2d_bytes`` bytes
    staged host→device (see the module docstring), ``d2h_bytes`` bytes
    explicitly pulled back to the host (:meth:`count_d2h` — spills,
    ranking results).

    The counters are monotone for the process lifetime and are read by
    **snapshot-and-diff only** (:meth:`snapshot` / :meth:`since`): a
    global reset would race every other measurement window sharing the
    process, so there deliberately is no ``reset()``.
    """

    __slots__ = ("launches", "h2d_bytes", "d2h_bytes")

    def __init__(self):
        self.launches = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def snapshot(self) -> dict:
        return {"launches": self.launches, "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes}

    def since(self, snap: dict) -> dict:
        return {k: getattr(self, k) - v for k, v in snap.items()}

    def count_h2d(self, *arrays, device: Optional[torch.device] = None
                  ) -> None:
        """Record host→device staging: every numpy operand, and every
        CPU tensor bound for a ``device`` other than the CPU."""
        off_host = device is not None and torch.device(device).type != "cpu"
        for a in arrays:
            if isinstance(a, np.ndarray):
                self.h2d_bytes += a.nbytes
            elif (off_host and isinstance(a, torch.Tensor)
                  and a.device.type == "cpu"):
                self.h2d_bytes += a.numel() * a.element_size()

    def count_d2h(self, *arrays) -> None:
        """Record an explicit device→host fetch of each array."""
        for a in arrays:
            if isinstance(a, torch.Tensor):
                self.d2h_bytes += a.numel() * a.element_size()
            elif isinstance(a, np.ndarray):
                self.d2h_bytes += a.nbytes


counters = KernelCounters()

# optional process-wide launch observer: called (op_name,
# h2d_bytes_this_launch) after the counters update
_launch_hook: Optional[Callable[[str, int], None]] = None


def set_launch_hook(fn: Optional[Callable[[str, int], None]]) -> None:
    """Install (or clear, with None) the process-wide launch observer."""
    global _launch_hook
    _launch_hook = fn


def record_launch(name: str, *operands,
                  device: Optional[torch.device] = None) -> None:
    """Account one named dispatch: bump the counters and notify the
    launch hook. Every wrapper (and out-of-module launch sites such as
    the resident store's ranking epilogue) routes through here."""
    counters.launches += 1
    before = counters.h2d_bytes
    counters.count_h2d(*operands, device=device)
    if _launch_hook is not None:
        _launch_hook(name, counters.h2d_bytes - before)


def _stage(name: str, operands: Sequence) -> Tuple[torch.Tensor, ...]:
    """Record the launch and move every operand onto the launch device
    (the first device among them that is not the CPU, else the CPU)."""
    dev = common_device(*operands)
    record_launch(name, *operands, device=dev)
    return tuple(to_torch(x, dev) for x in operands)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _no_grad_operands(name: str, *operands) -> None:
    """The flash kernels have no backward (nor do the JAX package's):
    refuse operands that need a gradient rather than return a result
    that silently has none."""
    if any(isinstance(t, torch.Tensor) and t.requires_grad
           for t in operands):
        raise RuntimeError(f"{name} has no backward: an operand requires "
                           "grad (training runs the plain attention)")


def _local_operands(name: str, *operands) -> None:
    """The kernels run on one rank's shards: refuse a ``DTensor`` (under a
    mesh the model calls them inside ``local_map``, on plain tensors)
    rather than let it reach a plain version."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in operands):
        raise TypeError(f"{name} got a DTensor: call it on local shards "
                        "(models.hints.on_shards / local_map)")


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Causal flash attention. q [b,h,s,hd]; k,v [b,kv,s,hd] (views with
    any batch/head/seq strides)."""
    _local_operands("flash_attention", q, k, v)
    _no_grad_operands("flash_attention", q, k, v)
    record_launch("flash_attention", q, k, v)
    return _fa.flash_attention(q, k, v, scale=scale, window=window,
                               softcap=softcap)


def flash_decode(q, k, v, q_pos, k_pos, *, scale: Optional[float] = None,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode against a (ring) KV cache with slot positions.
    q [b,h,1,hd]; k,v [b,kv,C,hd]; q_pos [b,1], k_pos [b,C] int32."""
    _local_operands("flash_decode", q, k, v, q_pos, k_pos)
    _no_grad_operands("flash_decode", q, k, v)
    record_launch("flash_decode", q, k, v, q_pos, k_pos)
    return _fa.flash_decode(q, k, v, q_pos, k_pos, scale=scale,
                            window=window, softcap=softcap)


# ---------------------------------------------------------------------------
# δ-CRDT joins and digests
# ---------------------------------------------------------------------------

def delta_join(a_vals, a_vers, b_vals, b_vers
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Versioned-chunk LWW merge (the δ-CRDT tensor join hot loop)."""
    return _dj.delta_join(*_stage("delta_join",
                                  (a_vals, a_vers, b_vals, b_vers)))


def batched_delta_join(segments):
    """Stacked merge over many objects' chunks: segments sharing a
    (chunk width, dtype, device) signature run as ONE launch. Returns
    ``(out_vals, out_vers)`` per segment."""
    return _dj.batched_delta_join(segments, join_fn=delta_join)


def chunk_digest(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk (max|x|, Σx²) in one pass — delta-selection digests."""
    return _dj.chunk_digest(*_stage("chunk_digest", (x,)))


def fused_join_digest(a_vals, a_vers, b_vals, b_vers):
    """Join + digest of the merge in ONE launch: ``(out_vals, out_vers,
    max|out| per chunk, Σout² per chunk)``."""
    return _dj.fused_join_digest(*_stage(
        "fused_join_digest", (a_vals, a_vers, b_vals, b_vers)))


def scatter_join(vals, vers, maxabs, sumsq, idx, d_vals, d_vers):
    """Scatter-merge sparse delta rows into resident stacked columns and
    refresh the touched rows' digest — the one-launch ingest behind
    ``kernels.resident``. ``idx`` (int32) and the delta rows may be host
    numpy (counted as staging). ``idx`` empty is a no-op (no launch)."""
    if int(idx.shape[0]) == 0:
        return vals, vers, maxabs, sumsq
    return _dj.scatter_join(*_stage(
        "scatter_join", (vals, vers, maxabs, sumsq, idx, d_vals, d_vers)))


# re-export the plain versions
attention_ref = ref.attention_ref
decode_ref = ref.decode_ref
delta_join_ref = ref.delta_join_ref
batched_delta_join_ref = ref.batched_delta_join_ref
chunk_digest_ref = ref.chunk_digest_ref
fused_join_digest_ref = ref.fused_join_digest_ref
scatter_join_ref = ref.scatter_join_ref
