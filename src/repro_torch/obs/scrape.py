"""Live scrape surface: a sidecar HTTP endpoint over one registry.

A gossip process is only debuggable mid-run if its counters are
reachable *while it is stuck* — after the fact, a wedged quorum and a
partitioned link look identical. :class:`MetricsServer` is a deliberately
tiny asyncio HTTP/1.0 responder (stdlib only, runs on the same event
loop as the gossip tasks, binds an ephemeral loopback sidecar port by
default) serving two read-only views of a :class:`~repro_torch.obs.registry.Registry`:

* ``GET /metrics``       — Prometheus text exposition (``text/plain``)
* ``GET /metrics.json``  — the JSON snapshot (``application/json``)

``GossipNode.serve_metrics()`` wires a node's :class:`LinkStats`,
replica probes, and kernel counters into a registry and serves it;
``serve.py --metrics`` does the same per process and advertises the
sidecar address in its status-file heartbeat, so the 3-process
``bench_net`` cluster is scrapeable by pid, port, or status file.

:func:`scrape` / :func:`scrape_json` are the matching clients (stdlib
``http.client``) used by tests and the ``obs-smoke`` CI job.
"""

from __future__ import annotations

import asyncio
import http.client
import json
from typing import Any, Dict, Optional, Tuple

from .registry import Registry

_CONTENT_TYPES = {
    "/metrics": "text/plain; version=0.0.4; charset=utf-8",
    "/metrics.json": "application/json; charset=utf-8",
}


class MetricsServer:
    """Serve one registry's scrape views on a loopback sidecar port."""

    def __init__(self, registry: Registry, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.registry = registry
        self.host = host
        self.port = port
        self.addr: Optional[str] = None
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> str:
        """Bind and serve; returns the resolved ``host:port``."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        host, port = self._server.sockets[0].getsockname()[:2]
        self.addr = f"{host}:{port}"
        return self.addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _respond(self, path: str) -> Tuple[int, str, str]:
        if path in ("/metrics", "/"):
            return 200, _CONTENT_TYPES["/metrics"], \
                self.registry.render_prometheus()
        if path in ("/metrics.json", "/json"):
            return 200, _CONTENT_TYPES["/metrics.json"], \
                self.registry.render_json()
        return 404, "text/plain; charset=utf-8", "not found\n"

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = line.decode("latin-1", "replace").split()
            path = parts[1].split("?", 1)[0] if len(parts) >= 2 else "/"
            # drain request headers (clients send them; we need none)
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if h in (b"\r\n", b"\n", b""):
                    break
            status, ctype, body = self._respond(path)
            reason = {200: "OK", 404: "Not Found"}[status]
            payload = body.encode("utf-8")
            writer.write(
                f"HTTP/1.0 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n".encode("latin-1"))
            writer.write(payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            writer.close()


def scrape(addr: str, path: str = "/metrics", *,
           timeout: float = 5.0) -> str:
    """Fetch one scrape view from ``host:port`` (raises on non-200)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode("utf-8")
        if resp.status != 200:
            raise RuntimeError(f"scrape {addr}{path}: HTTP {resp.status}")
        return body
    finally:
        conn.close()


def scrape_json(addr: str, *, timeout: float = 5.0) -> Dict[str, Any]:
    return json.loads(scrape(addr, "/metrics.json", timeout=timeout))


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Parse a Prometheus text exposition into
    ``{metric_name: {label_string: value}}`` (label_string "" for
    label-less samples) — enough for assertions; not a full parser."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_labels, _, value = line.rpartition(" ")
        if "{" in name_labels:
            name, _, rest = name_labels.partition("{")
            labels = rest.rstrip("}")
        else:
            name, labels = name_labels, ""
        try:
            v = float(value)
        except ValueError:
            v = float("nan")
        out.setdefault(name, {})[labels] = v
    return out
