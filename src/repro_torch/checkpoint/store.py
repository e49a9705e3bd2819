"""Durable delta-interval checkpoint store.

Layout (one directory per replica), the JAX package's:

    snapshot-<seq>.npz     full TensorState as of sequence <seq>
    delta-<seq>.npz        the delta joined at sequence <seq>
    manifest.json          {"seq": c, "snapshots": [...], "meta": {...}}

Every write is write-temp + ``os.replace`` (atomic on POSIX), mirroring the
paper's atomic durable transitions; the manifest is rewritten last, so a
crash at ANY point leaves a consistent prefix:

* crash before manifest update → the orphan snapshot/delta file is ignored;
* restore = latest manifest'd snapshot ⊔ subsequent deltas (in sequence
  order). Joins are idempotent, so an operator re-running a restore, or a
  restore that races a replay, cannot corrupt state (same argument that
  lets Algorithm 2 re-send delta-intervals).

The files hold the JAX package's arrays member for member: ``v::<name>``
values (bf16 as 2-byte voids under the ``<V2`` descr ``ml_dtypes`` writes),
``s::<name>`` versions as int64 and ``__lamport__``. The port keeps int32
versions on the device, so it widens them on the way to disk and narrows
them, range-checked, on the way back. ``restore(device=...)`` loads every
column onto ``device``, where the joins run (the ``delta_join`` kernel on
the card).

``state_from_pytree``/``pytree_from_state`` bridge model/optimizer pytrees
to the chunked ``TensorState`` lattice, naming each leaf by its
``jax.tree_util.keystr`` path.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import tree as tu
from ..core.tensor_lattice import (ChunkedTensor, TensorState, chunk_tensor,
                                   make_version, unchunk)
from ..dtypes import to_numpy, to_torch

_INT32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# pytree <-> TensorState
# ---------------------------------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def pytree_spec(tree: Any) -> Dict[str, Any]:
    """The shapes and dtypes of ``tree``'s leaves by name, and its
    structure: what :func:`pytree_from_state` needs to rebuild it."""
    pairs, treedef = tu.flatten_with_path(tree)
    return {"treedef": treedef,
            "leaves": {name: (tuple(leaf.shape), _dtype_name(leaf))
                       for name, leaf in pairs}}


def state_from_pytree(tree: Any, chunk_size: int, rank: int,
                      lamport: int = 1) -> Tuple[TensorState, Dict[str, Any]]:
    """Chunk every leaf on its own device; returns (state, spec) where
    spec records shapes/dtypes for reconstruction. A leaf whose size is
    a whole number of chunks is chunked as a view: the state shares its
    storage (the port's train step never writes a tensor in place)."""
    pairs, _ = tu.flatten_with_path(tree)
    version = make_version(lamport, rank)
    chunks: Dict[str, ChunkedTensor] = {}
    for name, leaf in pairs:
        leaf = leaf.detach()
        chunks[name] = chunk_tensor(leaf, chunk_size, version=version,
                                    device=leaf.device)
    return TensorState.of(chunks, lamport=lamport), pytree_spec(tree)


def pytree_from_state(state: TensorState, spec: Dict[str, Any]) -> Any:
    leaves = []
    d = state.as_dict()
    for name, (shape, dtype) in spec["leaves"].items():
        leaves.append(unchunk(d[name], tuple(shape), getattr(torch, dtype)))
    return tu.unflatten(spec["treedef"], leaves)


# ---------------------------------------------------------------------------
# npz (de)serialization of TensorState
# ---------------------------------------------------------------------------

def _state_to_arrays(state: TensorState) -> Iterator[Tuple[str, np.ndarray]]:
    """The file's members one at a time (each column leaves the device
    only when it is written)."""
    yield "__lamport__", np.asarray(state.lamport, dtype=np.int64)
    for name, ct in state.chunks:
        yield f"v::{name}", to_numpy(ct.values)
        yield f"s::{name}", to_numpy(ct.versions).astype(np.int64)


def _write_npz(f, members) -> None:
    """``np.savez`` of ``members``, except that a bf16 column (2-byte
    voids) is described as ``<V2``, as ``ml_dtypes.bfloat16`` is."""
    fmt = np.lib.format
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in members:
            arr = np.asarray(arr, order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype.kind == "V":
                    header = fmt.header_data_from_array_1_0(arr)
                    header["descr"] = "<V2"
                    fmt.write_array_header_1_0(fid, header)
                    fid.write(arr.tobytes())
                else:
                    fmt.write_array(fid, arr, allow_pickle=False)


def _narrow_versions(vers: np.ndarray, name: str) -> np.ndarray:
    if vers.size and (int(vers.min()) < 0 or int(vers.max()) > _INT32_MAX):
        raise ValueError(f"{name}: versions outside the int32 range the "
                         "port keeps on the device")
    return vers.astype(np.int32)


def _state_from_npz(path: str, device) -> TensorState:
    chunks: Dict[str, ChunkedTensor] = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("v::"):
                name = key[3:]
                vers = _narrow_versions(z[f"s::{name}"], name)
                chunks[name] = ChunkedTensor(to_torch(z[key], device),
                                             to_torch(vers, device))
        lamport = int(z["__lamport__"])
    return TensorState.of(chunks, lamport=lamport)


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)  # atomic durable transition
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class DeltaCheckpointStore:
    """Algorithm-2-shaped durable store: (X at snapshot, delta log, seq c)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    # -- manifest ----------------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def _read_manifest(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"seq": -1, "snapshots": [], "deltas": [], "meta": {}}

    def _write_manifest(self, m: Dict[str, Any]) -> None:
        _atomic_write(self._manifest_path(),
                      lambda f: f.write(json.dumps(m).encode()))

    @property
    def seq(self) -> int:
        return self._read_manifest()["seq"]

    # -- writes ---------------------------------------------------------------
    def save_snapshot(self, state: TensorState, seq: int,
                      meta: Optional[Dict[str, Any]] = None) -> None:
        path = os.path.join(self.dir, f"snapshot-{seq:08d}.npz")
        _atomic_write(path, lambda f: _write_npz(f, _state_to_arrays(state)))
        m = self._read_manifest()
        m["snapshots"] = sorted(set(m["snapshots"]) | {seq})
        m["seq"] = max(m["seq"], seq)
        if meta:
            m["meta"].update(meta)
        self._write_manifest(m)

    def append_delta(self, delta: TensorState, seq: int) -> None:
        m = self._read_manifest()
        assert seq == m["seq"] + 1, (
            f"delta log must be contiguous (got {seq}, have {m['seq']}) — "
            "the causal delta-merging condition on disk")
        path = os.path.join(self.dir, f"delta-{seq:08d}.npz")
        _atomic_write(path, lambda f: _write_npz(f, _state_to_arrays(delta)))
        m["deltas"] = sorted(set(m.get("deltas", [])) | {seq})
        m["seq"] = seq
        self._write_manifest(m)

    # -- restore ---------------------------------------------------------------
    def restore(self, device="cuda") -> Tuple[TensorState, int]:
        """Latest snapshot ⊔ subsequent deltas, joined on ``device``.
        Idempotent by construction."""
        m = self._read_manifest()
        if not m["snapshots"]:
            return TensorState.bottom(), m["seq"]
        snap_seq = max(m["snapshots"])
        state = _state_from_npz(
            os.path.join(self.dir, f"snapshot-{snap_seq:08d}.npz"), device)
        for seq in sorted(m.get("deltas", [])):
            if seq <= snap_seq:
                continue
            delta = _state_from_npz(
                os.path.join(self.dir, f"delta-{seq:08d}.npz"), device)
            state = state.join(delta)
            del delta        # free the delta's columns before the next load
        return state, m["seq"]

    # -- GC ------------------------------------------------------------------
    def gc(self, keep_snapshots: int = 1) -> None:
        """Drop snapshots older than the newest ``keep_snapshots`` and any
        delta at/below the oldest kept snapshot (acked-by-disk prefix)."""
        m = self._read_manifest()
        snaps = sorted(m["snapshots"])
        keep = snaps[-keep_snapshots:] if snaps else []
        horizon = keep[0] if keep else -1
        for s in snaps:
            if s not in keep:
                _try_unlink(os.path.join(self.dir, f"snapshot-{s:08d}.npz"))
        kept_deltas = []
        for d in sorted(m.get("deltas", [])):
            if d <= horizon:
                _try_unlink(os.path.join(self.dir, f"delta-{d:08d}.npz"))
            else:
                kept_deltas.append(d)
        m["snapshots"] = keep
        m["deltas"] = kept_deltas
        self._write_manifest(m)


def _try_unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
