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
version in ``ref``. ``launches`` counts kernel launches by name and
``routes`` the prefill launches by route; the CPU route adds to neither.

Prefill takes one of two kernels by one rule of dtype and head_dim
(:func:`prefill_route`): bf16 or f16 at head_dim 64 or 128 runs on the
tensor cores (``"tc"``: ``wgmma``, which also needs 16-byte aligned bases
and (batch, head, seq) strides that are multiples of 8 elements; operands
that are not so aligned take the CUDA-core kernel); f32 and every other
head_dim run on the CUDA cores (``"simt"``). Decode splits the cache into
:func:`decode_splits` ranges, one block per (range, KV head, row), scores
each slot with :func:`decode_threads_per_slot` threads and merges the
ranges in order. Both rules take the card's SM count (the wrapper reads
it from the device; the default is an H100 SXM's 132).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import ref
from ._build import library
from .delta_join import VALUE_DTYPES, _kernel_route, _raise_on, _stream

MAX_HEAD_DIM = 256
NO_WINDOW = 2 ** 31 - 1      # the kernels' "no window"
TC_DTYPES = (torch.bfloat16, torch.float16)
TC_HEAD_DIMS = (64, 128)
SMS = 132                    # streaming multiprocessors of an H100 SXM
DECODE_SLOTS = 128           # slots of a decode tile at most
DECODE_STAGE_BYTES = 72 * 1024   # K and V of one decode tile at most

launches: Dict[str, int] = {"flash_attention": 0, "flash_decode": 0}
routes: Dict[str, int] = {"flash_attention_tc": 0, "flash_attention_simt": 0}
# per (device, stream): the decode kernel's merge counters, zero between
# launches (each launch leaves them zero)
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (launches, routes):
        for k in counts:
            counts[k] = 0


def prefill_route(dtype: torch.dtype, hd: int) -> str:
    """The prefill kernel for ``dtype`` and head_dim ``hd``: ``"tc"``
    (tensor cores) for bf16 / f16 at head_dim 64 or 128, else ``"simt"``
    (f32 FMA on the CUDA cores). The wrapper also sends ``"tc"`` operands
    that are not 16-byte aligned (:func:`_aligned16`) to ``"simt"``."""
    return "tc" if dtype in TC_DTYPES and hd in TC_HEAD_DIMS else "simt"


def decode_tile(hd: int, elem: int) -> int:
    """Slots a decode tile holds: one per thread (128), halved (down to
    32) while its K and V rows — ``hd`` elements of ``elem`` bytes,
    padded to whole 16-byte chunks plus one — exceed
    ``DECODE_STAGE_BYTES``."""
    row = (-(-hd * elem // 16) + 1) * 16
    tile = DECODE_SLOTS
    while tile > 32 and 2 * tile * row > DECODE_STAGE_BYTES:
        tile //= 2
    return tile


@functools.lru_cache(maxsize=256)
def decode_splits(b: int, kv: int, C: int, tile: int,
                  sms: int = SMS) -> Tuple[int, int]:
    """``(splits, slots per split)`` of the decode grid (splits, kv, b):
    two blocks per SM of ``sms`` (the split count rounded up to a power
    of two) where the cache allows, each split a whole number of
    ``tile``-slot tiles (rounded down, at least one); only the last split
    is short."""
    want = 1 << (-(-2 * sms // max(1, b * kv)) - 1).bit_length()
    n = max(1, min(want, -(-C // tile)))
    per = max(1, -(-C // n) // tile) * tile
    return max(1, -(-C // per)), per


def decode_threads_per_slot(group: int, hd: int, blocks: int,
                            sms: int = SMS) -> int:
    """Threads that score one cache slot in a decode block: 4 when its
    ``group`` query heads' dots are long (``group >= 3`` and
    ``group * hd >= 512``) and the grid's ``blocks`` leave SMs idle (fewer
    than ``sms``), so each block's work is spread over 512 threads; else
    1 (128 threads a block, several blocks an SM)."""
    return 4 if group >= 3 and group * hd >= 512 and blocks < sms else 1


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned16(*tensors: torch.Tensor) -> bool:
    """Every base 16-byte aligned, and every (batch, head, seq) stride of
    an axis longer than 1 a whole number of 16-byte units."""
    return all(t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)
        for t in tensors)


def _decode_counters(device: torch.device, stream: int,
                     n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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
    [b, h, sq, hd] in q's dtype and memory order. On the card the kernel
    is :func:`prefill_route`'s: bf16 / f16 at head_dim 64 or 128 on the
    tensor cores when the operands are 16-byte aligned, everything else
    on the CUDA cores."""
    _check_qkv(q, k, v)
    b, h, sq, hd = q.shape
    scale_, window_, softcap_ = _options(hd, scale, window, softcap)
    if not _kernel_route(q, k, v):
        return ref.attention_ref(q, k, v, scale=scale, window=window,
                                 softcap=softcap)
    _kernel_operands(q, k, v)
    o = torch.empty_like(q)      # q's memory order (its hd is contiguous)
    route = prefill_route(q.dtype, hd)
    if route == "tc" and not _aligned16(q, k, v, o):
        route = "simt"           # wgmma's copies need 16-byte alignment
    kv, sk = k.shape[1], k.shape[2]
    if b and sq and h:
        lib = library("flash_attention")
        fn = lib.rt_flash_attention_tc if route == "tc" \
            else lib.rt_flash_attention
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, h, kv, sq, sk, hd, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *o.stride()[:3], scale_, window_, softcap_,
                VALUE_DTYPES[q.dtype], _stream(q))
        _raise_on(rc, "flash_attention")
        launches["flash_attention"] += 1
        routes[f"flash_attention_{route}"] += 1
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
        kv = k.shape[1]
        tile = decode_tile(hd, q.element_size())
        sms = sm_count(q.device)
        splits, per = decode_splits(b, kv, C, tile, sms)
        stream = _stream(q)
        # f32 partials of every split and query head: acc[hd], then
        # (from a multiple of four floats) m and l
        n = b * h * splits
        part = torch.empty(-(-n * hd // 4) * 4 + 2 * n, dtype=torch.float32,
                           device=q.device)
        rc = library("flash_attention").rt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), o.data_ptr(), part.data_ptr(),
            _decode_counters(q.device, stream, b * kv).data_ptr(), b, h, kv,
            C, hd, splits, per, tile,
            decode_threads_per_slot(h // kv, hd, splits * kv * b, sms),
            int(_aligned16(k, v)),
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            q_pos.stride(0), *k_pos.stride(), *o.stride()[:2], scale_,
            window_, softcap_, VALUE_DTYPES[q.dtype], stream)
        _raise_on(rc, "flash_decode")
        launches["flash_decode"] += 1
    return o
