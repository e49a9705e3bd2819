"""Binary δ-wire subsystem: what actually crosses the network, byte for
byte the JAX package's format.

* ``frames`` — versioned, CRC-checksummed typed envelopes, plus
  :class:`WireCodec`, the engine-pluggable message codec
  (``Replica(wire=WireCodec())``).
* ``codec``  — the stacked store codec: live chunk rows of all keys
  grouped by (chunk-width, dtype) into stacked columns with a columnar
  index; decoding yields zero-copy sparse row views, optionally uploaded
  to the device at decode time.

Membership (``ClusterState``) frames ride as opaque bodies under frame
kind ``membership``; top-k sparsified updates ride as ``topk`` frames,
byte-identical to the JAX package's.
"""

from .codec import (decode_digest, decode_store, decode_topk, decode_value,
                    encode_digest, encode_store, encode_topk, encode_value,
                    store_body_is_empty)
from .frames import (FRAME_KINDS, FrameBytes, FrameError, FrameStream,
                     HEADER_SIZE, MAGIC, VERSION, WireCodec, decode_frame,
                     encode_frame, peek_kind)

__all__ = [
    "decode_digest", "decode_store", "decode_topk", "decode_value",
    "encode_digest", "encode_store", "encode_topk", "encode_value",
    "store_body_is_empty",
    "FRAME_KINDS", "FrameBytes", "FrameError", "FrameStream",
    "HEADER_SIZE", "MAGIC", "VERSION", "WireCodec", "decode_frame",
    "encode_frame", "peek_kind",
]
