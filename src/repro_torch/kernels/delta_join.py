"""δ-CRDT versioned-chunk join and chunk digest: the wrappers of the
hand-written CUDA kernels in ``csrc/delta_join.cu``.

The four kernels are the Hopper counterparts of the Pallas TPU kernels
of the JAX package's ``kernels/delta_join.py``:

* ``delta_join``        — out[i] = b[i] if b_ver[i] > a_ver[i] else a[i];
                          out_ver = max(a_ver, b_ver). Values may also be
                          int32 or int16: the kernel moves bits only.
* ``fused_join_digest`` — the join plus max|x| and Σx² (f32) of each
                          merged row, in the same pass.
* ``scatter_join``      — merge ``r`` delta rows at rows ``idx`` into the
                          resident columns and refresh those rows' digest;
                          the caller's columns are left intact.
* ``chunk_digest``      — per row max|x| and Σx² in f32.

Dispatch is by the tensors' device, never by a fallback: a tensor on the
card launches the kernel (or raises), a tensor on the CPU runs the plain
version in ``ref``. Every wrapper checks shapes and version dtype; the
kernel route also checks value dtype and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and raises
when the launch is refused. ``launches`` counts kernel launches by name —
the CPU route and empty inputs add nothing.

``batched_delta_join`` is the grouping glue: segments sharing (chunk
width, value dtype, version dtype, device) are stacked with one
``torch.cat`` and joined in one launch, then split back as views.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from . import ref
from ._build import library

VALUE_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# delta_join only moves bits (a select per row), so it also takes the
# 4- and 2-byte integer leaves of a checkpoint (the optimizer's int32
# step); the digests are float sums and keep VALUE_DTYPES
JOIN_VALUE_DTYPES = frozenset(VALUE_DTYPES) | {torch.int32, torch.int16}
VERSION_DTYPE = torch.int32

launches: Dict[str, int] = {"delta_join": 0, "fused_join_digest": 0,
                            "scatter_join": 0, "chunk_digest": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lives where the CUDA kernels run."""
    return t.device.type == "cuda"


def _kernel_route(*tensors: torch.Tensor) -> bool:
    """True → launch the kernel, False → the plain version. All operands
    must share one device; a device that is neither the card nor the CPU
    is refused."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {dev} and "
                             f"{t.device}")
    if on_card(tensors[0]):
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {dev}")


def _check_rows(vals: torch.Tensor, vers: torch.Tensor, what: str) -> None:
    if vals.dim() != 2:
        raise ValueError(f"{what} values must be [rows, chunk], got "
                         f"{tuple(vals.shape)}")
    if vers.dim() != 1 or vers.shape[0] != vals.shape[0]:
        raise ValueError(f"{what} versions must be [{vals.shape[0]}], got "
                         f"{tuple(vers.shape)}")
    if vers.dtype != VERSION_DTYPE:
        raise TypeError(f"{what} versions must be int32, got {vers.dtype}")


def _kernel_operands(*tensors: torch.Tensor,
                     dtypes=VALUE_DTYPES) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    if tensors[0].dtype not in dtypes:
        raise TypeError(f"no kernel for {tensors[0].dtype} values; have "
                        f"{sorted(map(str, dtypes))}")


def _vec(row_bytes: int, *tensors: torch.Tensor) -> int:
    """1 when every row is whole 16-byte units at 16-byte aligned bases
    (the kernels then move uint4s), else 0 (element loads)."""
    return int(row_bytes % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def delta_join(a_vals: torch.Tensor, a_vers: torch.Tensor,
               b_vals: torch.Tensor, b_vers: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_vals, b_vals [n, chunk] (f32, f16, bf16, int32 or int16);
    a_vers, b_vers [n] int32."""
    _check_rows(a_vals, a_vers, "a")
    _check_rows(b_vals, b_vers, "b")
    if b_vals.shape != a_vals.shape or b_vals.dtype != a_vals.dtype:
        raise ValueError("a and b must have the same shape and dtype")
    if not _kernel_route(a_vals, a_vers, b_vals, b_vers):
        return ref.delta_join_ref(a_vals, a_vers, b_vals, b_vers)
    _kernel_operands(a_vals, a_vers, b_vals, b_vers,
                     dtypes=JOIN_VALUE_DTYPES)
    n, chunk = a_vals.shape
    ov, over = torch.empty_like(a_vals), torch.empty_like(a_vers)
    if n and chunk:
        es = a_vals.element_size()
        rc = library().rt_delta_join(
            a_vals.data_ptr(), a_vers.data_ptr(), b_vals.data_ptr(),
            b_vers.data_ptr(), ov.data_ptr(), over.data_ptr(), n, chunk, es,
            _vec(chunk * es, a_vals, b_vals, ov), _stream(a_vals))
        _raise_on(rc, "delta_join")
        launches["delta_join"] += 1
    return ov, over


def fused_join_digest(a_vals: torch.Tensor, a_vers: torch.Tensor,
                      b_vals: torch.Tensor, b_vers: torch.Tensor):
    """:func:`delta_join` and :func:`chunk_digest` of the merged rows in
    one pass: ``(out_vals, out_vers, max|out| [n] f32, Σout² [n] f32)``."""
    _check_rows(a_vals, a_vers, "a")
    _check_rows(b_vals, b_vers, "b")
    if b_vals.shape != a_vals.shape or b_vals.dtype != a_vals.dtype:
        raise ValueError("a and b must have the same shape and dtype")
    if not _kernel_route(a_vals, a_vers, b_vals, b_vers):
        return ref.fused_join_digest_ref(a_vals, a_vers, b_vals, b_vers)
    _kernel_operands(a_vals, a_vers, b_vals, b_vers)
    n, chunk = a_vals.shape
    ov, over = torch.empty_like(a_vals), torch.empty_like(a_vers)
    ma = torch.empty((n,), dtype=torch.float32, device=a_vals.device)
    ss = torch.empty_like(ma)
    if n and chunk:
        rc = library().rt_fused_join_digest(
            a_vals.data_ptr(), a_vers.data_ptr(), b_vals.data_ptr(),
            b_vers.data_ptr(), ov.data_ptr(), over.data_ptr(), ma.data_ptr(),
            ss.data_ptr(), n, chunk, VALUE_DTYPES[a_vals.dtype],
            _vec(chunk * a_vals.element_size(), a_vals, b_vals, ov),
            _stream(a_vals))
        _raise_on(rc, "fused_join_digest")
        launches["fused_join_digest"] += 1
    return ov, over, ma, ss


def chunk_digest(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, chunk] → (max|x| per row [n], Σx² per row [n]), both f32."""
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, chunk], got {tuple(x.shape)}")
    if not _kernel_route(x):
        return ref.chunk_digest_ref(x)
    _kernel_operands(x)
    n, chunk = x.shape
    ma = torch.empty((n,), dtype=torch.float32, device=x.device)
    ss = torch.empty_like(ma)
    if n and chunk:
        rc = library().rt_chunk_digest(
            x.data_ptr(), ma.data_ptr(), ss.data_ptr(), n, chunk,
            VALUE_DTYPES[x.dtype], _vec(chunk * x.element_size(), x),
            _stream(x))
        _raise_on(rc, "chunk_digest")
        launches["chunk_digest"] += 1
    return ma, ss


def scatter_join(vals: torch.Tensor, vers: torch.Tensor,
                 maxabs: torch.Tensor, sumsq: torch.Tensor,
                 idx: torch.Tensor, d_vals: torch.Tensor,
                 d_vers: torch.Tensor):
    """Merge ``r`` delta rows ``d_vals [r, chunk]`` / ``d_vers [r]`` into
    the resident columns at rows ``idx [r] int32`` and refresh those
    rows' digest. Returns NEW columns; the inputs stay valid (old
    snapshots keep their values). Duplicate positions are allowed only
    when their merged content is identical (⊥-versioned pad rows)."""
    _check_rows(vals, vers, "resident")
    _check_rows(d_vals, d_vers, "delta")
    n, chunk = vals.shape
    r = int(idx.shape[0])
    if idx.dim() != 1 or d_vals.shape[0] != r or d_vals.shape[1] != chunk:
        raise ValueError("idx [r] and delta rows [r, chunk] must agree")
    if d_vals.dtype != vals.dtype:
        raise TypeError(f"delta dtype {d_vals.dtype} != {vals.dtype}")
    for col in (maxabs, sumsq):
        if col.shape != (n,) or col.dtype != torch.float32:
            raise ValueError("digest columns must be [n] float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if r == 0:
        return vals, vers, maxabs, sumsq
    if bool(((idx < 0) | (idx >= n)).any()):
        raise IndexError(f"scatter rows out of range [0, {n})")
    operands = (vals, vers, maxabs, sumsq, idx, d_vals, d_vers)
    if not _kernel_route(*operands):
        return ref.scatter_join_ref(*operands)
    _kernel_operands(*operands)
    # outputs start as copies of the resident columns; the kernel reads
    # the old buffers and writes only the targeted rows of the new ones
    ov, over = torch.empty_like(vals), torch.empty_like(vers)
    oma, oss = torch.empty_like(maxabs), torch.empty_like(sumsq)
    for dst, src in ((ov, vals), (over, vers), (oma, maxabs),
                     (oss, sumsq)):
        dst.copy_(src)
    if chunk:
        rc = library().rt_scatter_join(
            vals.data_ptr(), vers.data_ptr(), idx.data_ptr(),
            d_vals.data_ptr(), d_vers.data_ptr(), ov.data_ptr(),
            over.data_ptr(), oma.data_ptr(), oss.data_ptr(), r, chunk,
            VALUE_DTYPES[vals.dtype],
            _vec(chunk * vals.element_size(), vals, d_vals, ov),
            _stream(vals))
        _raise_on(rc, "scatter_join")
        launches["scatter_join"] += 1
    return ov, over, oma, oss


def batched_delta_join(segments: Sequence[Tuple[torch.Tensor, ...]],
                       join_fn: Callable = delta_join
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Join many ``(a_vals, a_vers, b_vals, b_vers)`` segments in as few
    launches as possible: segments sharing (chunk width, value dtype,
    version dtype, device) are concatenated along the row axis, joined
    in ONE ``join_fn`` call — the merge is pointwise per row, so stacking
    rows of many tensors is exact — and split back as views, in input
    order."""
    results: List[Tuple[torch.Tensor, torch.Tensor]] = [None] * len(segments)
    groups: Dict[tuple, List[int]] = {}
    for i, (av, avr, _bv, _bvr) in enumerate(segments):
        sig = (av.shape[1], av.dtype, avr.dtype, av.device)
        groups.setdefault(sig, []).append(i)
    for idxs in groups.values():
        if len(idxs) == 1:
            results[idxs[0]] = join_fn(*segments[idxs[0]])
            continue
        cat = [torch.cat([segments[i][j] for i in idxs]) for j in range(4)]
        ov, over = join_fn(*cat)
        start = 0
        for i in idxs:
            n_s = segments[i][0].shape[0]
            results[i] = (ov[start:start + n_s], over[start:start + n_s])
            start += n_s
    return results
