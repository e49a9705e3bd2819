"""Host columns ⇄ torch tensors, bf16 included.

Host-side columns (wire bodies, index columns, live-row extracts) are
numpy arrays, as in the JAX package. numpy has no bfloat16, so a bf16
host column is held as raw 2-byte void elements (``|V2``) — exactly the
dtype string the JAX package's encoder writes for an ``ml_dtypes``
bfloat16 column, so frames stay byte-identical — and is viewed as int16
on its way to and from torch.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

BF16_NP = np.dtype("V2")

_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
    BF16_NP: torch.bfloat16,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (``V2`` is bfloat16)."""
    dt = np.dtype(np_dtype)
    if dt.kind == "V":
        dt = BF16_NP
    return _TO_TORCH[dt]


def to_torch(a, device=None) -> torch.Tensor:
    """A numpy column as a tensor (zero-copy on the CPU when ``device``
    is None or the CPU); tensors pass through, moved to ``device``."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if a.dtype.kind == "V":
        t = _from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = _from_numpy(a)
    return t if device is None else t.to(device)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.flags.writeable:
        return torch.from_numpy(a)
    # wire columns alias read-only frame bytes; the port never writes
    # through them (joins allocate their outputs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def to_numpy(t) -> np.ndarray:
    """A tensor's values as a host numpy array (bf16 as ``V2``); numpy
    arrays pass through."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_NP)
    return t.numpy()


def common_device(*tensors) -> torch.device:
    """Where an operation over ``tensors`` runs: the first accelerator
    device among them, else the CPU."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            return t.device
    return torch.device("cpu")
