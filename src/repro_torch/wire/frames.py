"""Typed, versioned, checksummed binary envelopes for δ-wire traffic.

Every payload kind the :class:`~repro_torch.core.propagation.Replica` engine
ships — store delta-intervals, full-state fallbacks, acks, digest
summaries, membership gossip (``ClusterState``), rebalance handoffs, top-k compression
payloads — travels as one frame::

    offset  size  field
    0       2     magic  0xD4 0x57  ("δW")
    2       1     wire-format version (see VERSION; decoders reject
                  frames from a newer major format instead of guessing)
    3       1     kind   (FRAME_KINDS)
    4       4     payload length, little-endian u32
    8       4     CRC-32 over header (with this field zeroed) + payload —
                  covering the header too, so a flipped kind/length byte
                  cannot silently misroute an otherwise-valid payload
    12      n     payload

The payload of delta/state/handoff frames is the
:mod:`repro_torch.wire.codec` stacked store encoding; other non-tensor
lattices ride as tagged opaque bodies. Frames are byte-identical to the
JAX package's. ``decode_frame`` validates magic, version, length,
and checksum before any byte of the payload is interpreted, and returns a
zero-copy ``memoryview`` of the payload so the codec's columnar arrays
can alias the frame buffer straight into the store's ingest path.

``FrameBytes`` (a ``bytes`` subclass carrying ``.kind``) is what the
encoder returns: the network simulator reads the attribute to classify
traffic for byte accounting (``NetStats``) without parsing the frame,
and ``len(frame)`` *is* the measured wire size — byte reports in the
benchmarks are frame lengths, not structural estimates.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

MAGIC = b"\xd4W"
# v2: store bodies carry a key-lifecycle table (epoch, expiry per key —
# the key lifecycle) and a per-group column-compression flag; digest bodies
# carry a life section; reap/reap-ack control frames added.
# v3: causal dot-store lattices ride as dot-column bodies (rid table +
# vv/cloud columns + packed dot column) instead of opaque pickle, and
# digest bodies carry a per-dot causal section (vv + cloud + store dot
# column per key), enabling exact missing-dot pull responses.
VERSION = 3

_HEADER = struct.Struct("<2sBBII")
HEADER_SIZE = _HEADER.size

# kind byte → the traffic-class name NetStats accounts under
FRAME_KINDS = {
    1: "delta",        # delta-interval / delta-group payload
    2: "state",        # full-state fallback payload
    3: "ack",          # cumulative ack (control traffic)
    4: "handoff",      # rebalance handoff push (payload traffic)
    5: "membership",   # cluster-view gossip payload
    6: "digest",       # anti-entropy pull request: chunk-version summary
    7: "topk",         # top-k sparsified update payload
    8: "digest-resp",  # pull response: rows the digest's owner lacks
    9: "reap",         # lifecycle: owner's reap proposal (control)
    10: "reap-ack",    # lifecycle: replica-set agreement vote (control)
}
_KIND_BYTES = {name: byte for byte, name in FRAME_KINDS.items()}


class FrameError(ValueError):
    """Raised when a frame fails structural validation (bad magic,
    unsupported version, truncation, length mismatch, or CRC failure)."""


class FrameBytes(bytes):
    """Encoded frame: raw bytes plus the traffic-class ``kind`` tag."""

    kind: str = "frame"

    def __new__(cls, data: bytes, kind: str) -> "FrameBytes":
        obj = super().__new__(cls, data)
        obj.kind = kind
        return obj


def _frame_crc(header_no_crc: bytes, payload) -> int:
    return zlib.crc32(payload, zlib.crc32(header_no_crc)) & 0xFFFFFFFF


def encode_frame(kind: str, payload: bytes) -> FrameBytes:
    """Wrap ``payload`` in a checksummed envelope of the given kind."""
    return _seal(bytearray(HEADER_SIZE) + payload, kind)


def _seal(buf: bytearray, kind: str) -> FrameBytes:
    """Fill in the header of ``buf`` — a frame whose first
    ``HEADER_SIZE`` bytes were reserved and whose payload follows — and
    return it as one :class:`FrameBytes` (bodies are built in place, so a
    large payload is copied once)."""
    kind_byte = _KIND_BYTES.get(kind)
    if kind_byte is None:
        raise FrameError(f"unknown frame kind {kind!r}; "
                         f"have {sorted(_KIND_BYTES)}")
    length = len(buf) - HEADER_SIZE
    bare = _HEADER.pack(MAGIC, VERSION, kind_byte, length, 0)
    crc = _frame_crc(bare, memoryview(buf)[HEADER_SIZE:])
    _HEADER.pack_into(buf, 0, MAGIC, VERSION, kind_byte, length, crc)
    return FrameBytes(buf, kind)


def decode_frame(buf) -> Tuple[str, memoryview]:
    """Validate and open a frame; returns ``(kind, payload_view)``.

    The returned payload is a zero-copy view into ``buf`` — the codec's
    column decoders alias it directly. Raises :class:`FrameError` on any
    structural defect; a corrupted frame is rejected before one payload
    byte is interpreted.
    """
    view = memoryview(buf)
    if len(view) < HEADER_SIZE:
        raise FrameError(f"truncated frame: {len(view)} bytes "
                         f"< {HEADER_SIZE}-byte header")
    magic, version, kind_byte, length, crc = _HEADER.unpack_from(view, 0)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r}")
    if version != VERSION:
        raise FrameError(f"unsupported wire version {version} "
                         f"(this decoder speaks {VERSION})")
    kind = FRAME_KINDS.get(kind_byte)
    if kind is None:
        raise FrameError(f"unknown frame kind byte {kind_byte}")
    payload = view[HEADER_SIZE:]
    if len(payload) != length:
        raise FrameError(f"length mismatch: header says {length}, "
                         f"frame carries {len(payload)}")
    bare = _HEADER.pack(magic, version, kind_byte, length, 0)
    if _frame_crc(bare, payload) != crc:
        raise FrameError("checksum mismatch: frame corrupted in flight")
    return kind, payload


def peek_kind(buf) -> Optional[str]:
    """The frame kind without validating the payload (None if not a
    frame) — cheap classification for stats/routing layers."""
    view = memoryview(buf)
    if len(view) < HEADER_SIZE or bytes(view[:2]) != MAGIC:
        return None
    return FRAME_KINDS.get(view[3])


class FrameStream:
    """Incremental frame decoder: feed byte chunks, collect whole frames.

    The frame header is self-delimiting (magic + length + CRC over header
    and payload), so one decoder serves every byte-stream shape the
    transports produce: TCP reads split at arbitrary points, several
    frames batched into one UDP datagram, or a reassembled oversized
    frame. ``feed`` appends bytes and returns every frame that completed,
    as :class:`FrameBytes` (so ``.kind`` drives stats without re-parsing).

    Corruption policy is *skip and resync*: a frame whose CRC fails — or
    bytes that are not a frame at all — are discarded up to the next
    magic, and decoding continues from there. A dropped frame is safe by
    construction (δ-joins are idempotent; digest-sync re-pulls anything a
    drop lost), so the stream never stalls on a damaged link. Counters:

    * ``frames``  — complete frames yielded;
    * ``corrupt`` — frames that parsed but failed CRC / structural check;
    * ``resyncs`` — times the scanner skipped garbage to find a magic;
    * ``skipped_bytes`` — total bytes discarded by resyncs.

    ``max_frame`` bounds the buffer: a header announcing a payload above
    it is treated as corruption (resync) instead of waiting on — and
    allocating for — bytes that may never arrive.
    """

    def __init__(self, max_frame: int = 64 * 1024 * 1024):
        self._buf = bytearray()
        self.max_frame = max_frame
        self.frames = 0
        self.corrupt = 0
        self.resyncs = 0
        self.skipped_bytes = 0

    @property
    def pending(self) -> int:
        """Bytes buffered awaiting a frame completion."""
        return len(self._buf)

    def reset(self) -> None:
        """Drop buffered bytes (a closed connection's partial frame)."""
        self._buf.clear()

    def _skip_past_magic(self) -> None:
        """Discard the bogus frame start at offset 0 and rescan."""
        del self._buf[:len(MAGIC)]
        self.skipped_bytes += len(MAGIC)
        self.resyncs += 1

    def feed(self, data) -> list:
        self._buf += data
        out = []
        while True:
            # align buffer start to the next magic
            idx = self._buf.find(MAGIC)
            if idx < 0:
                # no magic: discard all but a possible split-magic tail
                keep = (1 if self._buf
                        and self._buf[-1] == MAGIC[0] else 0)
                dropped = len(self._buf) - keep
                if dropped:
                    del self._buf[:dropped]
                    self.skipped_bytes += dropped
                    self.resyncs += 1
                return out
            if idx > 0:
                del self._buf[:idx]
                self.skipped_bytes += idx
                self.resyncs += 1
            if len(self._buf) < HEADER_SIZE:
                return out            # wait for the rest of the header
            magic, version, kind_byte, length, _crc = _HEADER.unpack_from(
                self._buf, 0)
            if (version != VERSION or kind_byte not in FRAME_KINDS
                    or length > self.max_frame):
                self.corrupt += 1     # structurally impossible header
                self._skip_past_magic()
                continue
            total = HEADER_SIZE + length
            if len(self._buf) < total:
                return out            # wait for the rest of the payload
            candidate = bytes(self._buf[:total])
            try:
                kind, _payload = decode_frame(candidate)
            except FrameError:
                self.corrupt += 1     # CRC failure: flip inside the frame
                self._skip_past_magic()
                continue
            del self._buf[:total]
            self.frames += 1
            out.append(FrameBytes(candidate, kind))


# ---------------------------------------------------------------------------
# Engine message codec: Replica tuples ⇄ frames
# ---------------------------------------------------------------------------

_DELTA_BASIC = struct.Struct("<BI")          # mode=0, payload len
_DELTA_CAUSAL = struct.Struct("<BQBI")       # mode=1, counter, ghost?, len
_ACK = struct.Struct("<Q")
_REAP = struct.Struct("<IdB")                # epoch, expiry, ok(+key utf8)



class WireCodec:
    """Encodes the propagation engine's messages as binary frames.

    Plug an instance into ``Replica(wire=WireCodec())`` and every message
    the engine ships — delta-intervals, full-state fallbacks, acks,
    handoffs, digest exchanges, lifecycle reap votes — leaves as one
    :class:`FrameBytes`; ``on_receive`` feeds incoming frames back
    through :meth:`decode_msg`, with store payloads decoded into sparse
    columnar form. Stateless and shareable across replicas.

    ``compress=True`` zlib-compresses every store payload's columns.
    ``to_device=True`` decodes every incoming store payload with
    ``codec.decode_store(to_device=True, device=device)``: the stacked
    columns are uploaded once at decode time, so a device-resident
    receiver (``kernels.resident``) scatter-ingests them with zero extra
    staging.
    """

    def __init__(self, compress: bool = False, to_device: bool = False,
                 device="cuda"):
        self.compress = compress
        self.to_device = to_device
        self.device = device

    def encode_msg(self, msg: Tuple, *, full_state: bool = False
                   ) -> Optional[FrameBytes]:
        from .codec import (_emit_store, _emit_value, encode_digest,
                            store_body_is_empty)

        mkind = msg[0]
        if mkind == "ack":
            return encode_frame("ack", _ACK.pack(int(msg[1])))
        if mkind in ("reap", "reap-ack"):
            key, epoch, expiry = msg[1], msg[2], msg[3]
            ok = int(msg[4]) if mkind == "reap-ack" else 0
            return encode_frame(mkind, _REAP.pack(int(epoch), float(expiry),
                                                  ok)
                                + key.encode("utf-8"))
        if mkind == "handoff":
            buf = _emit_value(bytearray(HEADER_SIZE), msg[1], self.compress)
            return _seal(buf, "handoff")
        if mkind == "digest":
            return encode_frame("digest", encode_digest(msg[1]))
        if mkind == "digest-resp":
            # (store, requester digest): the digest filter runs AT ENCODE
            # TIME and a response that carries nothing is no frame at all
            _, store, digest = msg
            buf = _emit_store(bytearray(HEADER_SIZE), store,
                              known_versions=digest.tensors,
                              known_opaque=digest.opaque,
                              known_life=digest.life,
                              known_causal=digest.causal,
                              compress=self.compress)
            if store_body_is_empty(memoryview(buf)[HEADER_SIZE:]):
                return None
            return _seal(buf, "digest-resp")
        if mkind != "delta":  # pragma: no cover - engine ships no others
            raise FrameError(f"unframeable message kind {mkind!r}")
        buf = bytearray(HEADER_SIZE)
        if len(msg) == 2:                      # basic-mode delta-group
            buf += bytes(_DELTA_BASIC.size)
            _emit_value(buf, msg[1], self.compress)
            _DELTA_BASIC.pack_into(buf, HEADER_SIZE, 0,
                                   len(buf) - HEADER_SIZE - _DELTA_BASIC.size)
        else:                                  # causal delta-interval
            _, d, n, ghost = msg
            buf += bytes(_DELTA_CAUSAL.size)
            _emit_value(buf, d, self.compress)
            _DELTA_CAUSAL.pack_into(
                buf, HEADER_SIZE, 1, int(n), int(ghost is not None),
                len(buf) - HEADER_SIZE - _DELTA_CAUSAL.size)
            if ghost is not None:
                _emit_value(buf, ghost, self.compress)
        return _seal(buf, self._payload_kind(msg[1], full_state))

    @staticmethod
    def _payload_kind(value, full_state: bool) -> str:
        from ..sync.membership import ClusterState   # lazy: sync imports core
        if isinstance(value, ClusterState):
            return "membership"
        return "state" if full_state else "delta"

    def decode_msg(self, frame) -> Tuple:
        from .codec import decode_digest, decode_store, decode_value

        dev = dict(to_device=self.to_device, device=self.device)
        kind, payload = decode_frame(frame)
        if kind == "ack":
            return ("ack", _ACK.unpack_from(payload, 0)[0])
        if kind in ("reap", "reap-ack"):
            epoch, expiry, ok = _REAP.unpack_from(payload, 0)
            key = bytes(payload[_REAP.size:]).decode("utf-8")
            if kind == "reap":
                return ("reap", key, int(epoch), float(expiry))
            return ("reap-ack", key, int(epoch), float(expiry), int(ok))
        if kind == "handoff":
            return ("handoff", decode_value(payload, **dev))
        if kind == "digest":
            return ("digest", decode_digest(payload))
        if kind == "digest-resp":
            return ("digest-resp", decode_store(payload, **dev))
        if kind in ("delta", "state", "membership"):
            mode = payload[0]
            if mode == 0:
                _, plen = _DELTA_BASIC.unpack_from(payload, 0)
                off = _DELTA_BASIC.size
                return ("delta", decode_value(payload[off:off + plen],
                                              **dev))
            _, n, has_ghost, plen = _DELTA_CAUSAL.unpack_from(payload, 0)
            off = _DELTA_CAUSAL.size
            d = decode_value(payload[off:off + plen], **dev)
            ghost = (decode_value(payload[off + plen:]) if has_ghost
                     else None)
            return ("delta", d, n, ghost)
        raise FrameError(f"engine cannot route frame kind {kind!r}")
