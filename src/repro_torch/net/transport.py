"""Socket transports: δ-wire frames over real UDP and TCP.

One :class:`Transport` interface, two channel disciplines:

* :class:`UdpTransport` — fire-and-forget datagrams. Small frames are
  *batched*: consecutive queued frames pack into one datagram up to the
  MTU budget (frames are self-delimiting, so the receiver just feeds the
  datagram through a :class:`~repro_torch.wire.frames.FrameStream`). A frame
  larger than the MTU is *split* into shard datagrams carrying a
  ``(frame-id, index, count)`` header and reassembled at the receiver
  with **drop-whole-frame** semantics: lose any shard and the whole
  frame is discarded (δ-joins are idempotent and digest-sync is the
  repair path, so a dropped frame costs latency, never correctness).
  Loss / duplication / reordering injection hooks on the send path make
  the §2 fault model reproducible over loopback.

* :class:`TcpTransport` — connected streams. Frames need no extra
  length prefix (the frame header *is* one); each connection feeds a
  ``FrameStream``, so short reads, frames split across segments, and a
  peer dying mid-frame all resolve by construction — the per-connection
  stream state dies with the connection, and the dialer reconnects with
  capped exponential backoff. A connection opens with a tiny hello
  preamble announcing the dialer's logical node id (replica ids are
  logical names, not addresses — the same id space the simulator uses,
  which is what makes object-mode ≡ socket-mode replays possible).

Both ends of a link bind one socket: a node sends *from* its listening
UDP socket, so the datagram source address identifies the sender, and
TCP senders identify themselves in the hello. Receivers hand up
``(src_node_id, FrameBytes)``; everything above this layer is
transport-agnostic.
"""

from __future__ import annotations

import asyncio
import random
import struct
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from ..wire.frames import FrameBytes, FrameStream
from .stats import LinkStats

Receiver = Callable[[str, FrameBytes], None]


def parse_addr(addr: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)``; raises ValueError on junk."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"address {addr!r} is not HOST:PORT")
    try:
        p = int(port)
    except ValueError:
        raise ValueError(f"address {addr!r} has a non-integer port")
    if not 0 <= p <= 65535:
        raise ValueError(f"address {addr!r} port out of range")
    return host, p


def format_addr(addr: Tuple[str, int]) -> str:
    return f"{addr[0]}:{addr[1]}"


class Transport:
    """What :class:`~repro_torch.net.node.GossipNode` drives: bind a listening
    socket, send batches of frames to peer addresses, deliver inbound
    frames (with the sender's node id) to a receiver callback."""

    def __init__(self, stats: Optional[LinkStats] = None):
        self.stats = stats if stats is not None else LinkStats()
        self._receiver: Optional[Receiver] = None
        self.addr: Optional[str] = None      # bound "host:port" after start
        self.closed = False

    def set_receiver(self, cb: Receiver) -> None:
        self._receiver = cb

    def _deliver(self, src: str, frame: FrameBytes) -> None:
        if self._receiver is not None and not self.closed:
            self._receiver(src, frame)

    async def start(self, listen: str) -> str:
        raise NotImplementedError

    async def send_frames(self, peer_addr: str, frames) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        self.closed = True


# ---------------------------------------------------------------------------
# UDP
# ---------------------------------------------------------------------------

# shard header for frames larger than the MTU:
#   magic "δF", version, flags, frame-id u32, shard index u16, count u16
_SHARD_MAGIC = b"\xd5F"
_SHARD = struct.Struct("<2sBBIHH")
SHARD_VERSION = 1


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, owner: "UdpTransport"):
        self.owner = owner

    def datagram_received(self, data: bytes, addr) -> None:
        self.owner._datagram_received(data, addr)

    def error_received(self, exc) -> None:  # pragma: no cover - ICMP noise
        pass


class UdpTransport(Transport):
    """Datagram channel; see module docstring.

    ``loss`` / ``dup`` / ``reorder`` are *send-path* fault injection for
    loopback tests and benches (a real deployment leaves them 0 and lets
    the network be the network): each outgoing datagram is independently
    dropped with probability ``loss``, sent twice with probability
    ``dup``, or held back one datagram with probability ``reorder`` —
    seeded, so a lossy-mesh test is reproducible.

    ``max_partial`` bounds reassembly memory per source: at most that
    many oversized frames may be in flight from one peer; starting one
    more evicts the oldest partial (drop-whole-frame).
    """

    def __init__(self, mtu: int = 1400, *, loss: float = 0.0,
                 dup: float = 0.0, reorder: float = 0.0, seed: int = 0,
                 max_partial: int = 8,
                 max_frame: int = 64 * 1024 * 1024,
                 stats: Optional[LinkStats] = None):
        super().__init__(stats)
        if mtu <= _SHARD.size:
            raise ValueError(f"mtu {mtu} smaller than the shard header")
        self.mtu = mtu
        self.loss, self.dup, self.reorder = loss, dup, reorder
        self.rng = random.Random(seed)
        self.max_partial = max_partial
        self.max_frame = max_frame
        self.injected_losses = 0
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._frame_id = 0
        self._held: Optional[Tuple[bytes, Tuple[str, int]]] = None
        # per-source decode state: FrameStream + partial reassemblies
        self._streams: Dict[str, FrameStream] = {}
        self._partials: Dict[str, OrderedDict] = {}

    async def start(self, listen: str) -> str:
        loop = asyncio.get_running_loop()
        host, port = parse_addr(listen)
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpProtocol(self), local_addr=(host, port))
        self.addr = format_addr(
            self._transport.get_extra_info("sockname")[:2])
        return self.addr

    # -- send path -----------------------------------------------------------
    def _emit(self, datagram: bytes, addr: Tuple[str, int]) -> None:
        """One datagram onto the wire, through the fault hooks."""
        assert self._transport is not None
        if self.loss and self.rng.random() < self.loss:
            self.injected_losses += 1
            return
        copies = 2 if self.dup and self.rng.random() < self.dup else 1
        if self.reorder and self._held is None \
                and self.rng.random() < self.reorder:
            self._held = (datagram, addr)     # swap with the next datagram
            return
        for _ in range(copies):
            self.stats.datagrams_sent += 1
            self._transport.sendto(datagram, addr)
        if self._held is not None:
            held, haddr = self._held
            self._held = None
            self.stats.datagrams_sent += 1
            self._transport.sendto(held, haddr)

    async def send_frames(self, peer_addr: str, frames) -> None:
        addr = parse_addr(peer_addr)
        batch: list = []
        size = 0
        for frame in frames:
            if len(frame) > self.mtu:
                if batch:
                    self._emit(b"".join(batch), addr)
                    batch, size = [], 0
                self._send_sharded(bytes(frame), addr)
                continue
            if size + len(frame) > self.mtu and batch:
                self._emit(b"".join(batch), addr)
                batch, size = [], 0
            batch.append(bytes(frame))
            size += len(frame)
        if batch:
            self._emit(b"".join(batch), addr)

    def _send_sharded(self, frame: bytes, addr: Tuple[str, int]) -> None:
        body = self.mtu - _SHARD.size
        count = (len(frame) + body - 1) // body
        if count > 0xFFFF:
            raise ValueError(f"frame of {len(frame)} bytes exceeds the "
                             f"shard space at mtu={self.mtu}")
        fid = self._frame_id = (self._frame_id + 1) & 0xFFFFFFFF
        for i in range(count):
            chunk = frame[i * body:(i + 1) * body]
            self.stats.chunks_sent += 1
            self._emit(_SHARD.pack(_SHARD_MAGIC, SHARD_VERSION, 0,
                                   fid, i, count) + chunk, addr)

    # -- receive path ----------------------------------------------------------
    def _stream_for(self, src: str) -> FrameStream:
        s = self._streams.get(src)
        if s is None:
            s = self._streams[src] = FrameStream(max_frame=self.max_frame)
        return s

    def _datagram_received(self, data: bytes, addr) -> None:
        self.stats.datagrams_recv += 1
        src = format_addr(addr[:2])
        if data[:2] == _SHARD_MAGIC and len(data) >= _SHARD.size:
            data = self._reassemble(src, data)
            if data is None:
                return
        stream = self._stream_for(src)
        for frame in stream.feed(data):
            self._deliver(src, frame)
        if stream.pending:
            # datagrams are atomic: leftover bytes mean a frame was
            # truncated (a lost shard slipped through, or junk) —
            # drop-whole-frame, never smear bytes across datagrams
            stream.reset()
            self.stats.reassembly_drops += 1
        self.stats.resyncs = sum(s.resyncs for s in self._streams.values())

    def _reassemble(self, src: str, data: bytes) -> Optional[bytes]:
        magic, version, _flags, fid, index, count = _SHARD.unpack_from(
            data, 0)
        if version != SHARD_VERSION or count == 0 or index >= count:
            self.stats.reassembly_drops += 1
            return None
        partials = self._partials.setdefault(src, OrderedDict())
        entry = partials.get(fid)
        if entry is None:
            entry = partials[fid] = {}
            while len(partials) > self.max_partial:
                partials.popitem(last=False)     # evict oldest partial
                self.stats.reassembly_drops += 1
        entry[index] = data[_SHARD.size:]
        if len(entry) < count:
            return None
        del partials[fid]
        return b"".join(entry[i] for i in range(count))

    async def close(self) -> None:
        await super().close()
        if self._transport is not None:
            self._transport.close()


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

_HELLO_MAGIC = b"\xd4H"
_HELLO = struct.Struct("<2sH")     # magic + id length


class TcpTransport(Transport):
    """Stream channel; see module docstring.

    ``node_id`` is announced in the hello preamble of every outbound
    connection; inbound frames are attributed to the id the dialer
    announced. Each peer gets one cached outbound connection;
    ``send_frames`` dials on demand with capped exponential backoff
    (``reconnect_min``→``reconnect_max``) and *blocks* while the peer is
    down — the caller's bounded queue is the admission valve, shedding
    oldest frames while the dialer waits.
    """

    def __init__(self, node_id: str, *,
                 reconnect_min: float = 0.05, reconnect_max: float = 1.0,
                 max_frame: int = 64 * 1024 * 1024,
                 stats: Optional[LinkStats] = None):
        super().__init__(stats)
        self.node_id = node_id
        self.reconnect_min = reconnect_min
        self.reconnect_max = reconnect_max
        self.max_frame = max_frame
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: Dict[str, asyncio.StreamWriter] = {}
        self._reader_tasks: set = set()

    async def start(self, listen: str) -> str:
        host, port = parse_addr(listen)
        self._server = await asyncio.start_server(self._on_conn, host, port)
        self.addr = format_addr(
            self._server.sockets[0].getsockname()[:2])
        return self.addr

    # -- inbound ---------------------------------------------------------------
    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._reader_tasks.add(task)
            task.add_done_callback(self._reader_tasks.discard)
        stream = FrameStream(max_frame=self.max_frame)
        src: Optional[str] = None
        try:
            head = await reader.readexactly(_HELLO.size)
            magic, idlen = _HELLO.unpack(head)
            if magic != _HELLO_MAGIC:
                return                       # not one of ours
            src = (await reader.readexactly(idlen)).decode("utf-8")
            while not self.closed:
                data = await reader.read(65536)
                if not data:
                    break                    # EOF: peer closed / crashed
                for frame in stream.feed(data):
                    self._deliver(src, frame)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass                             # mid-frame death: stream state
        finally:                             # dies with the connection
            self.stats.resyncs += stream.resyncs
            writer.close()

    # -- outbound --------------------------------------------------------------
    async def _dial(self, peer_addr: str) -> asyncio.StreamWriter:
        host, port = parse_addr(peer_addr)
        backoff = self.reconnect_min
        first = True
        while not self.closed:
            try:
                _reader, writer = await asyncio.open_connection(host, port)
                ident = self.node_id.encode("utf-8")
                writer.write(_HELLO.pack(_HELLO_MAGIC, len(ident)) + ident)
                await writer.drain()
                return writer
            except OSError:
                if not first:
                    self.stats.reconnects += 1
                first = False
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.reconnect_max)
        raise ConnectionError("transport closed while dialing")

    async def _writer_for(self, peer_addr: str) -> asyncio.StreamWriter:
        w = self._writers.get(peer_addr)
        if w is not None and not w.is_closing():
            return w
        if w is not None:
            self.stats.reconnects += 1
        w = await self._dial(peer_addr)
        self._writers[peer_addr] = w
        return w

    async def send_frames(self, peer_addr: str, frames) -> None:
        w = await self._writer_for(peer_addr)
        try:
            w.write(b"".join(bytes(f) for f in frames))
            await w.drain()                  # TCP backpressure, for real
        except (ConnectionError, OSError):
            w.close()                        # frames lost with the link —
            self._writers.pop(peer_addr, None)   # digest-sync repairs

    async def inject_raw(self, peer_addr: str, data: bytes) -> None:
        """Test hook: push raw bytes (e.g. half a frame) down the
        connection without framing — how the mid-frame-crash tests put
        a torn frame on a real socket deterministically."""
        w = await self._writer_for(peer_addr)
        w.write(data)
        await w.drain()

    def abort_connections(self) -> None:
        """Abruptly kill every outbound connection (crash simulation)."""
        for w in self._writers.values():
            t = w.transport
            if t is not None:
                t.abort()
        self._writers.clear()

    async def close(self) -> None:
        await super().close()
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except asyncio.CancelledError:  # pragma: no cover
                pass
        self.abort_connections()
        for task in list(self._reader_tasks):
            task.cancel()


def make_transport(kind: str, node_id: str, *, mtu: int = 1400,
                   loss: float = 0.0, dup: float = 0.0,
                   reorder: float = 0.0, seed: int = 0,
                   stats: Optional[LinkStats] = None) -> Transport:
    """Transport factory behind ``serve.py --transport``."""
    if kind == "udp":
        return UdpTransport(mtu=mtu, loss=loss, dup=dup, reorder=reorder,
                            seed=seed, stats=stats)
    if kind == "tcp":
        if loss or dup or reorder:
            raise ValueError("loss/dup/reorder injection is UDP-only "
                             "(TCP retransmits under the socket)")
        return TcpTransport(node_id, stats=stats)
    raise ValueError(f"unknown transport {kind!r}; have udp, tcp")
