"""Stacked binary codec for :class:`~repro_torch.core.store.LatticeStore`
deltas — byte for byte the JAX package's store, value and digest bodies.

One store delta — any subset of keys, each holding any lattice value —
packs into one contiguous byte payload:

* Every ``TensorState`` chunk tensor contributes only its **live** rows
  (version > 0). Rows from *all* keys and tensors are grouped by
  ``(chunk-width, value-dtype, version-dtype)`` signature and laid out as
  one stacked values column + one versions column + one chunk-index
  column per group — the same grouping the batched join launches over.
* A columnar index maps rows back to tensors: a key table, a tensor
  descriptor table ``(key, name, n_chunks)``, and per group a
  ``(descriptor, row-count)`` run-length list.
* Other lattice values ride as tagged opaque pickle bodies per key.
  Causal dot-store bodies are part of the format but arrive with the
  dot-store slice of the port (slice B): encoding or decoding one raises.
* Per-key lifecycle state rides in a trailing life table.
* Each signature group's columns may be zlib-deflated behind a per-group
  flag byte (``compress=True``).

Decoding is **zero-copy for the columns**: each tensor comes back as a
:class:`~repro_torch.core.tensor_lattice.SparseChunks` whose host numpy
``idx``/``vals``/``vers`` are views into the frame buffer.
``decode_store(to_device=True)`` additionally uploads each group's
columns once, so a resident receiver scatter-ingests them with no
further staging. bf16 columns carry the dtype string ``<V2``, as the
JAX package writes them.
"""

from __future__ import annotations

import pickle
import struct
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.digest import (CAUSAL_TYPE_NAMES, StoreDigest, life_diff,
                           opaque_hash)
from ..core.store import LatticeStore
from ..core.tensor_lattice import SparseChunks, TensorState, live_rows
from ..dtypes import to_torch
from ..lifecycle.lattice import LIFE_BOTTOM, Life

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_II = struct.Struct("<II")
_LIFE = struct.Struct("<Id")     # (epoch u32, expiry f64) per life entry

_KIND_TENSOR = 0
_KIND_OPAQUE = 1

# payload tags for encode_value/decode_value
_TAG_STORE = 0
_TAG_TENSORSTATE = 1
_TAG_OPAQUE = 2

_SINGLE = "\x00single"    # wrapper key for bare-TensorState payloads


def _dotstore_unported(what: str):
    return NotImplementedError(
        f"{what}: causal dot-store bodies arrive with slice B of the port")


def _pad8(buf: bytearray) -> None:
    buf.extend(b"\x00" * ((-len(buf)) % 8))


def _put_str(buf: bytearray, s: str, width=_U16) -> None:
    raw = s.encode("utf-8")
    buf += width.pack(len(raw))
    buf += raw


def _put_array(buf: bytearray, a: np.ndarray) -> None:
    """Append an array's raw bytes (one copy, straight from its buffer)."""
    buf += np.ascontiguousarray(a).reshape(-1).view(np.uint8).data


def _dtype_str(dt: np.dtype) -> str:
    """The column dtype string on the wire: numpy's, except bf16 rows
    (held as 2-byte voids) carry ``<V2`` like ``ml_dtypes.bfloat16``."""
    dt = np.dtype(dt)
    return "<V2" if dt.kind == "V" else dt.str


class _Cursor:
    """Sequential reader over a memoryview with aligned array views."""

    __slots__ = ("buf", "off")

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.off = 0

    def unpack(self, st: struct.Struct):
        vals = st.unpack_from(self.buf, self.off)
        self.off += st.size
        return vals if len(vals) > 1 else vals[0]

    def get_str(self, width=_U16) -> str:
        n = self.unpack(width)
        s = bytes(self.buf[self.off:self.off + n]).decode("utf-8")
        self.off += n
        return s

    def get_blob(self) -> memoryview:
        n = self.unpack(_U32)
        blob = self.buf[self.off:self.off + n]
        self.off += n
        return blob

    def align8(self) -> None:
        self.off += (-self.off) % 8

    def array(self, dtype, count: int, shape=None) -> np.ndarray:
        self.align8()
        dt = np.dtype(dtype)
        arr = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.off)
        self.off += count * dt.itemsize
        return arr.reshape(shape) if shape is not None else arr


def encode_store(store: LatticeStore,
                 known_versions: Optional[Mapping[Tuple[str, str],
                                                  np.ndarray]] = None,
                 known_opaque: Optional[Mapping[str, bytes]] = None,
                 known_life: Optional[Mapping[str, Life]] = None,
                 known_causal: Optional[Mapping[str, Any]] = None,
                 compress: bool = False) -> bytes:
    """Pack a whole store delta into one stacked, columnar byte payload.

    ``known_versions`` / ``known_opaque`` / ``known_life`` are the
    sections of a peer's :class:`~repro_torch.core.digest.StoreDigest`
    and turn the encoder into the responder of a digest exchange: chunk
    rows whose version the digest already covers are dropped while the
    columns are built, opaque keys with a matching content hash are
    dropped whole, and a key none of whose rows survive is elided.
    Lifecycle-aware: life entries ship iff strictly above the peer's, a
    key the peer has tombstoned *past* contributes nothing, and
    version/hash filters only compare within one incarnation.
    ``compress`` zlib-compresses each signature group's columns.
    """
    return bytes(_emit_store(bytearray(), store, known_versions,
                             known_opaque, known_life, known_causal,
                             compress))


def _emit_store(out: bytearray, store: LatticeStore, known_versions=None,
                known_opaque=None, known_life=None, known_causal=None,
                compress: bool = False) -> bytearray:
    """:func:`encode_store` appending to ``out`` (frames build their
    whole body in one buffer)."""
    if known_causal:
        raise _dotstore_unported("encode_store(known_causal=...)")
    base = len(out)            # column alignment is relative to the body
    life_map = dict(store.life)

    def peer_epoch(key: str) -> int:
        return known_life.get(key, LIFE_BOTTOM)[0] if known_life else 0

    def pad8() -> None:
        out.extend(b"\x00" * ((base - len(out)) % 8))

    # -- filter pass: surviving rows per tensor, surviving keys -----------------
    entries: List[Tuple[str, int, Any]] = []    # (key, kind, value)
    rows_of: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for key, val in store.entries:
        epoch = life_map.get(key, LIFE_BOTTOM)[0]
        if known_life is not None and peer_epoch(key) > epoch:
            continue                # peer's tombstone absorbs this key
        same_epoch = peer_epoch(key) == epoch
        if isinstance(val, TensorState):
            key_rows = []
            for name, ct in val.chunks:
                known = (known_versions.get((key, name))
                         if known_versions is not None and same_epoch
                         else None)
                key_rows.append(live_rows(ct, known))
            if (known_versions is not None
                    and not any(r[0].size for r in key_rows)):
                continue            # peer covers every row: elide the key
            entries.append((key, _KIND_TENSOR, val))
            rows_of.extend(key_rows)
        else:
            if type(val).__name__ in CAUSAL_TYPE_NAMES:
                raise _dotstore_unported(f"encode_store of key {key!r}")
            if (known_opaque is not None and same_epoch
                    and known_opaque.get(key) == opaque_hash(val)):
                continue            # peer holds this exact value
            entries.append((key, _KIND_OPAQUE, val))

    life_out = life_diff(store.life, [k for k, _, _ in entries],
                         known_life)

    # -- key table ------------------------------------------------------------
    out += _U32.pack(len(entries))
    tensor_descs: List[Tuple[int, str, Any]] = []   # (key_i, name, ct)
    opaque: List[Tuple[int, Any]] = []
    for key_i, (key, kind, val) in enumerate(entries):
        _put_str(out, key)
        if kind == _KIND_TENSOR:
            out += bytes([_KIND_TENSOR])
            out += _U64.pack(int(val.lamport))
            for name, ct in val.chunks:
                tensor_descs.append((key_i, name, ct))
        else:
            out += bytes([_KIND_OPAQUE])
            opaque.append((key_i, val))

    # -- opaque bodies ----------------------------------------------------------
    out += _U32.pack(len(opaque))
    for key_i, val in opaque:
        blob = pickle.dumps(val, protocol=4)
        out += _U32.pack(key_i)
        out += _U32.pack(len(blob))
        out += blob

    # -- dot-store bodies (none until slice B) ---------------------------------
    out += _U32.pack(0)

    # -- tensor descriptors -------------------------------------------------------
    out += _U32.pack(len(tensor_descs))
    for key_i, name, ct in tensor_descs:
        out += _U32.pack(key_i)
        _put_str(out, name)
        out += _U32.pack(int(ct.shape[0]))

    # -- signature groups: stacked columns ----------------------------------------
    groups: Dict[Tuple[int, str, str], List[int]] = {}
    for desc_i, (_, _, ct) in enumerate(tensor_descs):
        _idx, vals, vers = rows_of[desc_i]
        sig = (int(ct.shape[1]), _dtype_str(vals.dtype),
               _dtype_str(vers.dtype))
        groups.setdefault(sig, []).append(desc_i)

    out += _U16.pack(len(groups))
    for (chunk_w, dstr, vstr), members in sorted(groups.items()):
        _put_str(out, dstr, width=_U16)
        _put_str(out, vstr, width=_U16)
        out += _U32.pack(chunk_w)
        out += _U32.pack(len(members))
        total = 0
        for desc_i in members:
            rows = int(rows_of[desc_i][0].shape[0])
            out += _U32.pack(desc_i)
            out += _U32.pack(rows)
            total += rows
        out += _U32.pack(total)
        out += _U8.pack(1 if compress else 0)
        if compress:
            # the three columns laid out as the plain format but relative
            # to their own buffer, deflated as one zlib stream
            col = bytearray()
            _emit_columns(col, 0, members, rows_of)
            blob = zlib.compress(bytes(col))
            out += _U32.pack(len(blob))
            out += blob
        else:
            pad8()
            _emit_columns(out, base, members, rows_of)

    # -- life table: (key, epoch, expiry) triples ---------------------------------
    out += _U32.pack(len(life_out))
    for key, (epoch, expiry) in life_out:
        _put_str(out, key)
        out += _LIFE.pack(int(epoch), float(expiry))
    return out


def _emit_columns(out: bytearray, base: int, members, rows_of) -> None:
    """The three stacked columns of one signature group, each 8-aligned
    relative to offset ``base`` of ``out``."""
    def pad8() -> None:
        out.extend(b"\x00" * ((base - len(out)) % 8))

    for desc_i in members:                           # chunk-index column
        _put_array(out, np.asarray(rows_of[desc_i][0], dtype=np.int32))
    pad8()
    for desc_i in members:                           # versions column
        _put_array(out, rows_of[desc_i][2])
    pad8()
    for desc_i in members:                           # stacked values column
        _put_array(out, rows_of[desc_i][1])
    pad8()


def store_body_is_empty(body) -> bool:
    """True iff a store payload carries nothing at all — no keys and no
    lifecycle entries (parsed structurally from the counts)."""
    view = memoryview(body)
    if len(view) < 4 or _U32.unpack_from(view, 0)[0]:
        return False                 # malformed-short or has keys
    # with zero keys the opaque/dot-store/descriptor/group tables are
    # empty and the life count sits at a fixed offset
    off = 4 + 4 + 4 + 4 + 2
    return len(view) < off + 4 or _U32.unpack_from(view, off)[0] == 0


class _DeviceGroup:
    """One signature group's decoded columns, uploaded at decode time
    (``decode_store(..., to_device=True)``) so the resident scatter
    ingest (``kernels.resident._device_plan``) launches over device
    operands and stages nothing more. ``members`` resolves the
    run-length list to ``(key, name, n_chunks, rows)``."""

    __slots__ = ("chunk_w", "dstr", "vstr", "members", "idx_col",
                 "vals_dev", "vers_dev")

    def __init__(self, chunk_w, dstr, vstr, members, idx_col,
                 vals_dev, vers_dev):
        self.chunk_w = chunk_w
        self.dstr = dstr
        self.vstr = vstr
        self.members = members
        self.idx_col = idx_col
        self.vals_dev = vals_dev
        self.vers_dev = vers_dev


def decode_store(buf, to_device: bool = False,
                 device="cuda") -> LatticeStore:
    """Open a stacked payload back into a :class:`LatticeStore` whose
    tensor values are :class:`SparseChunks` of zero-copy views into
    ``buf``. ``to_device=True`` additionally uploads each signature
    group's values/versions columns to ``device`` once (counted as
    host→device staging) and attaches them as the store's
    ``_device_cols``."""
    cur = _Cursor(buf)
    n_keys = cur.unpack(_U32)
    keys: List[str] = []
    kinds: List[int] = []
    lamports: List[int] = []
    for _ in range(n_keys):
        keys.append(cur.get_str())
        kind = cur.unpack(_U8)
        kinds.append(kind)
        lamports.append(cur.unpack(_U64) if kind == _KIND_TENSOR else 0)

    values: Dict[int, Any] = {}
    tensor_chunks: Dict[int, Dict[str, Any]] = {
        i: {} for i, k in enumerate(kinds) if k == _KIND_TENSOR}

    n_opaque = cur.unpack(_U32)
    for _ in range(n_opaque):
        key_i = cur.unpack(_U32)
        values[key_i] = pickle.loads(cur.get_blob())

    if cur.unpack(_U32):
        raise _dotstore_unported("decode_store")

    n_descs = cur.unpack(_U32)
    descs: List[Tuple[int, str, int]] = []
    for _ in range(n_descs):
        key_i = cur.unpack(_U32)
        name = cur.get_str()
        n_chunks = cur.unpack(_U32)
        descs.append((key_i, name, n_chunks))

    n_groups = cur.unpack(_U16)
    dev_groups: List[_DeviceGroup] = []
    for _ in range(n_groups):
        dstr = cur.get_str(width=_U16)
        vstr = cur.get_str(width=_U16)
        chunk_w = cur.unpack(_U32)
        n_members = cur.unpack(_U32)
        members = [cur.unpack(_II) for _ in range(n_members)]
        total = cur.unpack(_U32)
        if cur.unpack(_U8):          # per-group compression flag
            gcur = _Cursor(zlib.decompress(cur.get_blob()))
        else:
            gcur = cur
        idx_col = gcur.array(np.int32, total)
        vers_col = gcur.array(np.dtype(vstr), total)
        vals_col = gcur.array(np.dtype(dstr), total * chunk_w,
                              shape=(total, chunk_w))
        if gcur is cur:
            cur.align8()             # the encoder's trailing column pad
        row = 0
        for desc_i, rows in members:
            key_i, name, n_chunks = descs[desc_i]
            tensor_chunks[key_i][name] = SparseChunks(
                n_chunks, idx_col[row:row + rows],
                vals_col[row:row + rows], vers_col[row:row + rows])
            row += rows
        if to_device:
            from ..kernels import ops
            ops.counters.count_h2d(vals_col, vers_col)
            dev_groups.append(_DeviceGroup(
                chunk_w, dstr, vstr,
                [(keys[descs[d][0]], descs[d][1], descs[d][2], rows)
                 for d, rows in members],
                np.asarray(idx_col), to_torch(vals_col, device),
                to_torch(vers_col, device)))

    life: List[Tuple[str, Life]] = []
    n_life = cur.unpack(_U32)
    for _ in range(n_life):
        key = cur.get_str()
        epoch, expiry = cur.unpack(_LIFE)
        life.append((key, (int(epoch), float(expiry))))

    for key_i, chunks in tensor_chunks.items():
        values[key_i] = TensorState.of(chunks, lamport=lamports[key_i])
    store = LatticeStore(tuple(sorted((keys[i], v)
                                      for i, v in values.items())),
                         tuple(sorted(life)))
    if dev_groups:
        object.__setattr__(store, "_device_cols", tuple(dev_groups))
    return store


# ---------------------------------------------------------------------------
# Generic payload bodies (what frames carry)
# ---------------------------------------------------------------------------

def encode_value(value: Any, compress: bool = False) -> bytes:
    """Tagged payload body for any lattice value the engine ships: stores
    and bare TensorStates take the stacked columnar path; every other
    lattice rides opaque."""
    return bytes(_emit_value(bytearray(), value, compress))


def _emit_value(out: bytearray, value: Any, compress: bool) -> bytearray:
    if isinstance(value, LatticeStore):
        out += bytes([_TAG_STORE])
        return _emit_store(out, value, compress=compress)
    if isinstance(value, TensorState):
        out += bytes([_TAG_TENSORSTATE])
        return _emit_store(out, LatticeStore.key_delta(_SINGLE, value),
                           compress=compress)
    out += bytes([_TAG_OPAQUE])
    out += pickle.dumps(value, protocol=4)
    return out


def decode_value(buf, to_device: bool = False, device="cuda") -> Any:
    view = memoryview(buf)
    tag = view[0]
    if tag == _TAG_STORE:
        return decode_store(view[1:], to_device=to_device, device=device)
    if tag == _TAG_TENSORSTATE:
        # bare TensorStates unwrap from the one-key store, which would
        # drop the device columns with the wrapper — no to_device here
        return decode_store(view[1:], device=device).get(_SINGLE,
                                                         TensorState)
    if tag == _TAG_OPAQUE:
        return pickle.loads(view[1:])
    raise ValueError(f"unknown payload tag {tag}")


# ---------------------------------------------------------------------------
# Digest summaries (the 'what do you hold' half of request/response sync)
# ---------------------------------------------------------------------------

def encode_digest(digest) -> bytes:
    """Binary body of a :class:`~repro_torch.core.digest.StoreDigest`:
    per (key, tensor) the dense chunk-version column, per opaque key the
    16-byte content hash, the life section, and the (empty) causal
    section. A :class:`LatticeStore` is summarized first."""
    if isinstance(digest, LatticeStore):
        from ..core.digest import store_digest
        digest = store_digest(digest)
    if digest.causal:
        raise _dotstore_unported("encode_digest")
    out = bytearray()
    out += _U32.pack(len(digest.tensors))
    for (key, name), vers in digest.tensors.items():
        vers = np.asarray(vers)
        _put_str(out, key)
        _put_str(out, name)
        _put_str(out, _dtype_str(vers.dtype), width=_U16)
        out += _U32.pack(len(vers))
        _pad8(out)
        _put_array(out, vers)
    out += _U32.pack(len(digest.opaque))
    for key, h in digest.opaque.items():
        _put_str(out, key)
        out += _U8.pack(len(h))
        out += h
    out += _U32.pack(len(digest.life))
    for key, (epoch, expiry) in digest.life.items():
        _put_str(out, key)
        out += _LIFE.pack(int(epoch), float(expiry))
    out += _U32.pack(0)               # causal section (slice B)
    return bytes(out)


def decode_digest(buf) -> StoreDigest:
    cur = _Cursor(buf)
    out = StoreDigest()
    n_tensor = cur.unpack(_U32)
    for _ in range(n_tensor):
        key = cur.get_str()
        name = cur.get_str()
        vstr = cur.get_str(width=_U16)
        count = cur.unpack(_U32)
        out.tensors[(key, name)] = cur.array(np.dtype(vstr), count)
    n_opaque = cur.unpack(_U32)
    for _ in range(n_opaque):
        key = cur.get_str()
        hlen = cur.unpack(_U8)
        out.opaque[key] = bytes(cur.buf[cur.off:cur.off + hlen])
        cur.off += hlen
    n_life = cur.unpack(_U32)
    for _ in range(n_life):
        key = cur.get_str()
        epoch, expiry = cur.unpack(_LIFE)
        out.life[key] = (int(epoch), float(expiry))
    if cur.unpack(_U32):
        raise _dotstore_unported("decode_digest")
    return out
