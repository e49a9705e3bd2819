"""Flash attention: the wrappers of the hand-written CUDA kernels in
``csrc/flash_attention.cu``.

The two kernels are the Hopper counterparts of the Pallas TPU kernels of
the JAX package's ``kernels/flash_attention.py``:

* ``flash_attention`` — causal online-softmax attention over
  q ``[b, h, sq, hd]`` and k, v ``[b, kv, sk, hd]`` (query and key
  positions are the row and column indices), with GQA (query head ``i``
  reads KV head ``i // (h // kv)``), an optional sliding window and an
  optional tanh softcap.
* ``flash_decode``    — one query token ``[b, h, 1, hd]`` against a ring
  KV cache ``[b, kv, C, hd]`` whose slots carry explicit positions
  ``k_pos [b, C]``: a slot is valid iff ``0 <= k_pos <= q_pos`` (and
  ``q_pos - k_pos < window``); a row with no valid slot gives zeros.

Operands are taken as views with any batch, head and sequence strides
(the head dimension must be contiguous), so the model passes its
``[b, s, H, hd]`` activations and ``[b, C, KV, hd]`` cache transposed, with
no copy. The output is allocated like q (same memory order), so it comes
back in the caller's layout. Any length is taken: the kernels mask the
ragged tails themselves.

Dispatch is by the tensors' device, never by a fallback: tensors on the
card launch the kernel (or raise), tensors on the CPU run the plain
version in ``ref``. ``launches`` counts kernel launches by name; the CPU
route adds nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import ref
from ._build import library
from .delta_join import VALUE_DTYPES, _kernel_route, _raise_on, _stream

MAX_HEAD_DIM = 256
NO_WINDOW = 2 ** 31 - 1      # the kernels' "no window"

launches: Dict[str, int] = {"flash_attention": 0, "flash_decode": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _options(hd: int, scale, window, softcap):
    """Scale, window and softcap as the kernels take them."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    return (scale, NO_WINDOW if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [b, h, s, hd] and k, v [b, kv, t, hd] "
                         f"alike; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError("q, k and v must agree on batch and head_dim")
    kv = k.shape[1]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")


def _kernel_operands(*tensors: torch.Tensor) -> None:
    if tensors[0].dtype not in VALUE_DTYPES:
        raise TypeError(f"no kernel for {tensors[0].dtype}; have "
                        f"{sorted(map(str, VALUE_DTYPES))}")
    hd = tensors[0].shape[-1]
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"no kernel for head_dim {hd} (1..{MAX_HEAD_DIM})")
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("the head dimension must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention. q [b, h, sq, hd]; k, v [b, kv, sk, hd]; returns
    [b, h, sq, hd] in q's dtype and memory order."""
    _check_qkv(q, k, v)
    b, h, sq, hd = q.shape
    scale_, window_, softcap_ = _options(hd, scale, window, softcap)
    if not _kernel_route(q, k, v):
        return ref.attention_ref(q, k, v, scale=scale, window=window,
                                 softcap=softcap)
    _kernel_operands(q, k, v)
    o = torch.empty_like(q)      # q's memory order (its hd is contiguous)
    kv, sk = k.shape[1], k.shape[2]
    if b and sq and h:
        rc = library("flash_attention").rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, kv, sq, sk, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], scale_, window_, softcap_,
            VALUE_DTYPES[q.dtype], _stream(q))
        _raise_on(rc, "flash_attention")
        launches["flash_attention"] += 1
    return o


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                 scale: Optional[float] = None,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode. q [b, h, 1, hd]; k, v [b, kv, C, hd];
    q_pos [b, 1] and k_pos [b, C] int32. Returns [b, h, 1, hd] in q's
    dtype and memory order."""
    _check_qkv(q, k, v)
    b, h, one, hd = q.shape
    C = k.shape[2]
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if q_pos.shape != (b, 1) or k_pos.shape != (b, C):
        raise ValueError(f"q_pos must be [{b}, 1] and k_pos [{b}, {C}]; got "
                         f"{tuple(q_pos.shape)}, {tuple(k_pos.shape)}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("q_pos and k_pos must be int32")
    scale_, window_, softcap_ = _options(hd, scale, window, softcap)
    if not _kernel_route(q, k, v, q_pos, k_pos):
        return ref.decode_ref(q, k, v, q_pos, k_pos, scale=scale,
                              window=window, softcap=softcap)
    _kernel_operands(q, k, v)
    o = torch.empty_like(q)      # q's memory order (its hd is contiguous)
    if b and h:
        rc = library("flash_attention").rt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), o.data_ptr(), b, h, k.shape[1], C, hd,
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            q_pos.stride(0), *k_pos.stride(), *o.stride()[:2], scale_,
            window_, softcap_, VALUE_DTYPES[q.dtype], _stream(q))
        _raise_on(rc, "flash_decode")
        launches["flash_decode"] += 1
    return o
