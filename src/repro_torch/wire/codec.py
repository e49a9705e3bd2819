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
* Causal dot-store lattices (AWORSet, RWORSet, MVRegister, flags, flat
  ORMaps) ride as **dot-column bodies**: a rid table, the causal
  context's dense vv column + sorted cloud column, and the store's packed
  int64 dot column (plus key table and group offsets for maps), decoded
  zero-copy into the :mod:`repro_torch.core.dotcols` columns. Keys and
  values are pickled tuples of plain Python objects, so these bodies are
  byte-identical to the JAX package's.
* Other lattice values (counters, nested maps, …) ride as tagged opaque
  pickle bodies per key. A pickle names the value's class and module, so
  opaque bodies differ between the two packages by design.
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

import copyreg
import io
import pickle
import struct
import sys
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core import dotcols
from ..core.crdts import CAUSAL_WIRE_TYPES
from ..core.digest import StoreDigest, life_diff, opaque_hash
from ..core.dotcols import (CausalContextCols, CausalDigest, DotFunCols,
                            DotMapCols, DotSetCols)
from ..core.store import LatticeStore
from ..core.tensor_lattice import SparseChunks, TensorState, live_rows
from ..dtypes import to_numpy, to_torch
from ..lifecycle.lattice import LIFE_BOTTOM, Life

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_II = struct.Struct("<II")
_LIFE = struct.Struct("<Id")     # (epoch u32, expiry f64) per life entry

_KIND_TENSOR = 0
_KIND_OPAQUE = 1
_KIND_DOTSTORE = 2               # causal CRDT on dot-column encoding

# payload tags for encode_value/decode_value
_TAG_STORE = 0
_TAG_TENSORSTATE = 1
_TAG_OPAQUE = 2

_SINGLE = "\x00single"    # wrapper key for bare-TensorState payloads


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


def _causal_wire_value(val):
    """(type-id, columnar value) when ``val`` takes the dot-column
    encoding; None otherwise (non-causal lattices, or store shapes the
    columnar form does not model — those stay on the opaque path)."""
    for tid, cls in enumerate(CAUSAL_WIRE_TYPES):
        if type(val) is cls:
            cv = dotcols.value_to_cols(val)
            return None if cv is None else (tid, cv)
    return None


def encode_store(store: LatticeStore,
                 known_versions: Optional[Mapping[Tuple[str, str],
                                                  np.ndarray]] = None,
                 known_opaque: Optional[Mapping[str, bytes]] = None,
                 known_life: Optional[Mapping[str, Life]] = None,
                 known_causal: Optional[Mapping[str, CausalDigest]] = None,
                 compress: bool = False) -> bytes:
    """Pack a whole store delta into one stacked, columnar byte payload.

    ``known_versions`` / ``known_opaque`` / ``known_life`` /
    ``known_causal`` are the sections of a peer's
    :class:`~repro_torch.core.digest.StoreDigest` and turn the encoder
    into the responder of a digest exchange: chunk rows whose version the
    digest already covers are dropped while the columns are built, opaque
    keys with a matching content hash are dropped whole, causal keys are
    narrowed to the exact missing-dot response
    (:func:`~repro_torch.core.dotcols.causal_diff_cols`), and a key none
    of whose rows or dots survive is elided.
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
            cw = _causal_wire_value(val)
            if cw is not None:
                tid, cv = cw
                g = (known_causal.get(key)
                     if known_causal is not None and same_epoch else None)
                if g is not None:
                    # the per-dot filter runs at encode time: only the
                    # dots the requester's context lacks, plus the exact
                    # removal context
                    cv = dotcols.causal_diff_cols(cv, g)
                    if cv is None:
                        continue    # requester lacks nothing: elide key
                entries.append((key, _KIND_DOTSTORE, (tid, cv)))
                continue
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
    dotstores: List[Tuple[int, int, Any]] = []      # (key_i, type_id, value)
    for key_i, (key, kind, val) in enumerate(entries):
        _put_str(out, key)
        if kind == _KIND_TENSOR:
            out += bytes([_KIND_TENSOR])
            out += _U64.pack(int(val.lamport))
            for name, ct in val.chunks:
                tensor_descs.append((key_i, name, ct))
        elif kind == _KIND_DOTSTORE:
            out += bytes([_KIND_DOTSTORE])
            dotstores.append((key_i, *val))
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

    # -- dot-store bodies: dot columns + vv summary per causal key ------------
    out += _U32.pack(len(dotstores))
    for key_i, tid, cv in dotstores:
        out += _U32.pack(key_i)
        out += _U8.pack(tid)
        body = bytearray()
        _emit_dotstore(body, cv)
        if compress:
            blob = zlib.compress(bytes(body))
            out += _U8.pack(1)
            out += _U32.pack(len(blob))
            out += blob
        else:
            out += _U8.pack(0)
            out += _U32.pack(len(body))
            pad8()                  # the body starts 8-aligned: zero-copy
            out += body

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


_SHAPE_BY_CLS = {DotSetCols: dotcols.SHAPE_SET, DotFunCols: dotcols.SHAPE_FUN,
                 DotMapCols: dotcols.SHAPE_MAP}


def _emit_dotstore(body: bytearray, cv) -> None:
    """One causal value's dot-column body, 8-aligned relative to
    ``body``'s start (which the caller places 8-aligned in the payload,
    or at offset 0 of a zlib stream): a shared rid table, the context's
    dense vv column + sorted cloud column, then the store's dot column
    (and, for maps, the key table + per-key group offsets). Values are
    one pickled tuple — dots are the dominant bytes and stay raw."""
    S, C = cv.store, cv.ctx
    rids, (ms, mc) = dotcols._union_rids(S.rids, C.rids)
    body += _U16.pack(len(rids))
    for r in rids:
        _put_str(body, r)
    body += _U8.pack(_SHAPE_BY_CLS[type(S)])
    _pad8(body)
    _put_array(body, dotcols._dense_vv(len(rids), mc, C.vvcol))
    cloud = dotcols._remap(C.cloudcol, mc)
    body += _U32.pack(cloud.size)
    _pad8(body)
    _put_array(body, cloud)
    if isinstance(S, DotMapCols):
        body += _U32.pack(len(S.map_keys))
        kblob = pickle.dumps(S.map_keys, protocol=4)
        body += _U32.pack(len(kblob))
        body += kblob
        body += S.shapes
        _pad8(body)
        _put_array(body, np.asarray(S.offsets, dtype=np.int64))
    dots = dotcols._remap(S.packed, ms)
    body += _U64.pack(dots.size)
    _pad8(body)
    _put_array(body, dots)
    if isinstance(S, DotSetCols):
        body += _U8.pack(0)
    else:
        body += _U8.pack(1)
        vblob = pickle.dumps(tuple(S.vals), protocol=4)
        body += _U32.pack(len(vblob))
        body += vblob


def _read_dotstore(cur: "_Cursor", tid: int):
    """Decode one dot-column body at the cursor into a causal CRDT value
    on the columnar representation (dot, offset and vv columns are
    zero-copy views when the body was not compressed)."""
    n_rids = cur.unpack(_U16)
    rids = tuple(cur.get_str() for _ in range(n_rids))
    shape = cur.unpack(_U8)
    vv = cur.array(np.int64, n_rids)
    n_cloud = cur.unpack(_U32)
    cloud = cur.array(np.int64, n_cloud)
    ctx = CausalContextCols(rids, vv, cloud)
    if shape == dotcols.SHAPE_MAP:
        n_keys = cur.unpack(_U32)
        map_keys = pickle.loads(cur.get_blob())
        shapes = bytes(cur.buf[cur.off:cur.off + n_keys])
        cur.off += n_keys
        offsets = cur.array(np.int64, n_keys + 1)
    n_dots = cur.unpack(_U64)
    dots = cur.array(np.int64, n_dots)
    if cur.unpack(_U8):
        vals_t = pickle.loads(cur.get_blob())
        vals = np.empty(len(vals_t), object)
        for j, v in enumerate(vals_t):
            vals[j] = v
    else:
        vals = np.full(n_dots, None, object)
    if shape == dotcols.SHAPE_SET:
        store = DotSetCols(rids, dots)
    elif shape == dotcols.SHAPE_FUN:
        store = DotFunCols(rids, dots, vals)
    else:
        store = DotMapCols(rids, map_keys, shapes, offsets, dots, vals)
    return CAUSAL_WIRE_TYPES[tid](store, ctx)


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

    n_dotstores = cur.unpack(_U32)
    for _ in range(n_dotstores):
        key_i = cur.unpack(_U32)
        tid = cur.unpack(_U8)
        if cur.unpack(_U8):          # per-body compression flag
            blob = cur.get_blob()
            values[key_i] = _read_dotstore(_Cursor(zlib.decompress(blob)),
                                           tid)
        else:
            blen = cur.unpack(_U32)
            cur.align8()
            start = cur.off
            values[key_i] = _read_dotstore(cur, tid)
            cur.off = start + blen   # the body length is explicit

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
# Top-k sparsified updates (sync.compression payloads)
# ---------------------------------------------------------------------------
#
# The JAX package's topk body opens with ``pickle.dumps`` of a jax
# ``PyTreeDef`` (protocol 4). The port writes and reads that same pickle
# without jax: a stand-in class pickles under jaxlib's global names with
# jax's state — the default registry and the post-order node list
# ``(kind, arity, dict keys, None, num_leaves, num_nodes)`` — through
# pickle's pure-Python pickler (whose output equals the C pickler's), and
# a restricted unpickler maps exactly those two globals back.

_JAX_TREEDEF = ("jaxlib._jax.pytree", "PyTreeDef")
_JAX_REGISTRY = ("jax._src.tree_util", "default_registry")


class _JaxTreeDef:
    """Stand-in for ``jaxlib._jax.pytree.PyTreeDef`` in topk pickles."""

    __slots__ = ("nodes",)

    def __init__(self, nodes=()):
        self.nodes = nodes

    def __reduce_ex__(self, protocol):
        return copyreg.__newobj__, (type(self),), (_REGISTRY, self.nodes)

    def __setstate__(self, state):
        self.nodes = state[1]


class _JaxRegistry:
    """Stand-in for ``jax._src.tree_util.default_registry``."""

    def __reduce_ex__(self, protocol):
        return "default_registry"


_REGISTRY = _JaxRegistry()


class _TreeDefPickler(pickle._Pickler):
    def save_global(self, obj, name=None):
        where = (_JAX_TREEDEF if obj is _JaxTreeDef
                 else _JAX_REGISTRY if obj is _REGISTRY else None)
        if where is None:
            return super().save_global(obj, name)
        self.save(where[0])
        self.save(where[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _TreeDefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_TREEDEF:
            return _JaxTreeDef
        if (module, name) == _JAX_REGISTRY:
            return _REGISTRY
        raise pickle.UnpicklingError(
            f"unexpected global {module}.{name} in a topk treedef")


def _treedef_pickle(treedef) -> bytes:
    nodes = [(n.kind, n.arity,
              None if n.keys is None else [
                  sys.intern(k) if isinstance(k, str) else k
                  for k in n.keys],
              None, n.num_leaves, n.num_nodes) for n in treedef.nodes]
    buf = io.BytesIO()
    _TreeDefPickler(buf, protocol=4).dump(_JaxTreeDef(nodes))
    return buf.getvalue()


def _treedef_unpickle(blob):
    from ..tree import Node, TreeDef
    stand_in = _TreeDefUnpickler(io.BytesIO(bytes(blob))).load()
    return TreeDef(tuple(
        Node(kind, arity, None if keys is None else tuple(keys), n_leaves,
             n_nodes)
        for kind, arity, keys, _custom, n_leaves, n_nodes in stand_in.nodes))


def _is_topk_leaf(t) -> bool:
    return isinstance(t, dict) and "idx" in t


def encode_topk(sparse: Any) -> bytes:
    """Body encoding for a ``TopKCompressor.compress`` result: per leaf,
    raw little-endian index/value columns (the dominant bytes); the
    pytree structure rides as a tiny pickled preamble, the JAX package's
    ``PyTreeDef`` pickle byte for byte."""
    from ..tree import flatten

    leaves, treedef = flatten(sparse, is_leaf=_is_topk_leaf)
    tdef = _treedef_pickle(treedef)
    out = bytearray()
    out += _U32.pack(len(tdef))
    out += tdef
    out += _U32.pack(len(leaves))
    for leaf in leaves:
        idx = np.ascontiguousarray(to_numpy(leaf["idx"]), dtype=np.int32)
        vals = np.ascontiguousarray(to_numpy(leaf["vals"]))
        shape = tuple(int(s) for s in leaf["shape"])
        out += _U8.pack(len(shape))
        for dim in shape:
            out += _U32.pack(dim)
        _put_str(out, _dtype_str(vals.dtype), width=_U16)
        out += _U32.pack(int(idx.size))
        _pad8(out)
        out += idx.tobytes()
        _pad8(out)
        out += vals.tobytes()
        _pad8(out)
    return bytes(out)


def decode_topk(buf) -> Any:
    """The sparse pytree of a topk body: per leaf host numpy ``idx``
    (int32) and ``vals`` views into ``buf``, and the ``shape`` tuple."""
    cur = _Cursor(buf)
    treedef = _treedef_unpickle(cur.get_blob())
    n_leaves = cur.unpack(_U32)
    leaves = []
    for _ in range(n_leaves):
        rank = cur.unpack(_U8)
        shape = tuple(cur.unpack(_U32) for _ in range(rank))
        dtype = np.dtype(cur.get_str(width=_U16))
        k = cur.unpack(_U32)
        idx = cur.array(np.int32, k)
        vals = cur.array(dtype, k)
        leaves.append({"idx": idx, "vals": vals, "shape": shape})
    return treedef.unflatten(leaves)


# ---------------------------------------------------------------------------
# Digest summaries (the 'what do you hold' half of request/response sync)
# ---------------------------------------------------------------------------

def encode_digest(digest) -> bytes:
    """Binary body of a :class:`~repro_torch.core.digest.StoreDigest`:
    per (key, tensor) the dense chunk-version column, per opaque key the
    16-byte content hash, the life section, and per causal key the vv +
    cloud summary and flat store dot column. A :class:`LatticeStore` is
    summarized first."""
    if isinstance(digest, LatticeStore):
        from ..core.digest import store_digest
        digest = store_digest(digest)
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
    # causal section: per dot-store key, the vv + cloud summary and the
    # flat store dot column, delta-encoded (per-replica dots are
    # near-contiguous) and always deflated — a digest is read once to
    # filter, never ingested zero-copy
    out += _U32.pack(len(digest.causal))
    for key, g in digest.causal.items():
        _put_str(out, key)
        inner = bytearray()
        inner += _U16.pack(len(g.rids))
        for r in g.rids:
            _put_str(inner, r)
        _pad8(inner)
        _put_array(inner, np.asarray(g.vvcol, dtype=np.int64))
        inner += _U32.pack(g.cloudcol.size)
        _pad8(inner)
        _put_array(inner, np.asarray(g.cloudcol, dtype=np.int64))
        inner += _U64.pack(g.dotcol.size)
        _pad8(inner)
        dots = np.asarray(g.dotcol, dtype=np.int64)
        if dots.size:
            _put_array(inner, np.diff(dots, prepend=np.int64(0)))
        blob = zlib.compress(bytes(inner))
        out += _U32.pack(len(blob))
        out += blob
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
    n_causal = cur.unpack(_U32)
    for _ in range(n_causal):
        key = cur.get_str()
        icur = _Cursor(zlib.decompress(cur.get_blob()))
        n_rids = icur.unpack(_U16)
        rids = tuple(icur.get_str() for _ in range(n_rids))
        vv = icur.array(np.int64, n_rids)
        n_cloud = icur.unpack(_U32)
        cloud = icur.array(np.int64, n_cloud)
        n_dots = icur.unpack(_U64)
        deltas = icur.array(np.int64, n_dots)
        dots = np.cumsum(deltas, dtype=np.int64) if n_dots else deltas
        out.causal[key] = CausalDigest(rids, vv, cloud, dots)
    return out
