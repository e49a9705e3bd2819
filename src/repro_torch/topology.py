"""Topology: zones, link classes, and per-class link profiles.

The δ-CRDT anti-entropy machinery is topology-agnostic — deltas join
correctly over any channel (Def. 6: any join-equivalent routing of
deltas preserves convergence) — but a production deployment is not a
flat, uniform-cost full mesh. Workers live in **zones** (failure
domains: an availability zone, a datacenter), zones group into
**regions**, and the links between workers fall into three classes with
wildly different latency, loss, and byte cost:

* ``intra`` — same zone: fast, cheap, effectively lossless;
* ``inter`` — different zones of one region: slower, still cheap;
* ``wan``   — across regions: slow, lossy, and the bytes are the bill.

This module is the ONE place those facts live. Every layer that used to
assume the flat mesh refactors against :class:`Topology`:

* ``core.sim``          — per-link-class delay/loss/dup and per-class
                          byte accounting (``Simulator(topology=...)``);
* ``sync.membership``   — zone-spreading rendezvous ownership (a key's
                          write set crosses ≥2 failure domains; read
                          replicas prefer zone-local coverage);
* ``core.hiergossip``   — the ``HierarchicalGossip`` shipping policy:
                          push gossip stays intra-zone, elected per-zone
                          relays batch cross-zone repair as digest-sync;
* ``net``               — ``id@host:port@zone`` peer annotations and
                          per-link-class ``LinkStats`` byte columns on
                          real sockets;
* ``benchmarks.bench_topology`` — WAN bytes and convergence of
                          hierarchical vs flat gossip under zone
                          partitions, in sim and socket mode.

Zone names are strings, optionally ``"region/zone"``: two distinct
zones sharing a region prefix are ``inter``; distinct zones with no
shared region (including bare un-prefixed names) are ``wan``. Everything
here is deterministic and dependency-free — the simulator's seeded RNG
is the only source of randomness in a topology-aware run.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Mapping, Optional, Tuple,
                    Union)

# the three link classes, cheapest first
INTRA = "intra"
INTER = "inter"
WAN = "wan"
LINK_CLASSES = (INTRA, INTER, WAN)

DEFAULT_ZONE = "z0"          # unannotated workers share one zone


def zone_region(zone: str) -> str:
    """The region a zone belongs to: the ``"region/"`` prefix when the
    name has one, else the zone name itself (a bare zone is its own
    region, so distinct bare zones are WAN apart)."""
    region, sep, _ = zone.rpartition("/")
    return region if sep else zone


def link_class(zone_a: str, zone_b: str) -> str:
    """Class of the link between two zones: ``intra`` within a zone,
    ``inter`` across zones of one region, ``wan`` across regions."""
    if zone_a == zone_b:
        return INTRA
    if zone_region(zone_a) == zone_region(zone_b):
        return INTER
    return WAN


@dataclass(frozen=True)
class LinkProfile:
    """Per-class link behaviour the simulator applies to a message and
    the cost model weighs its bytes with. ``loss``/``dup`` are per-
    transmission probabilities; delays are uniform jitter bounds (the
    reordering of the §2 model falls out of random delays); ``byte_cost``
    is the relative price of a byte on this class of link (what
    ``NetStats.link_cost`` accumulates — WAN egress is billed, a
    top-of-rack hop is not)."""

    min_delay: float = 0.05
    max_delay: float = 1.0
    loss: float = 0.0
    dup: float = 0.0
    byte_cost: float = 1.0


#: Default per-class profiles: an intra-zone hop is ~RTT-free and free;
#: inter-zone adds latency; WAN adds latency, loss, and a 10x byte bill.
DEFAULT_PROFILES: Dict[str, LinkProfile] = {
    INTRA: LinkProfile(min_delay=0.01, max_delay=0.05, loss=0.0,
                       byte_cost=1.0),
    INTER: LinkProfile(min_delay=0.05, max_delay=0.25, loss=0.01,
                       byte_cost=4.0),
    WAN: LinkProfile(min_delay=0.2, max_delay=1.0, loss=0.02,
                     byte_cost=10.0),
}


def hrw_score(member: str, key: str) -> int:
    """Deterministic, process-independent highest-random-weight score of
    ``member`` for ``key`` (blake2b, not ``hash()`` — the builtin is
    salted per process). The same hash rendezvous ownership uses, so
    relay election and key placement share one minimal-disruption
    argument."""
    h = hashlib.blake2b(f"{member}\x00{key}".encode("utf-8"),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def relay_for(zone: str, members: Iterable[str],
              zone_of: Callable[[str], str]) -> Optional[str]:
    """The zone's elected relay/aggregator: the HRW-highest member of
    ``zone`` within ``members``. Pure function of (zone, live member
    set), so every replica that agrees on the membership view agrees on
    the relay — and when the relay dies, its departure from the live set
    IS the failover election."""
    local = [m for m in members if zone_of(m) == zone]
    if not local:
        return None
    return max(local, key=lambda m: (hrw_score(m, f"relay:{zone}"), m))


class Topology:
    """Zone annotations + per-class link profiles for a worker set.

    ``zones`` maps worker id → zone name; workers absent from the map
    sit in ``default_zone``. ``profiles`` maps link class → a
    :class:`LinkProfile` override — classes without an entry fall back
    to whatever the consuming layer's flat-mesh defaults are (the
    simulator's ``NetConfig``), so ``Topology({})`` composed anywhere is
    byte-for-byte the old flat behaviour. Pass ``profiles=DEFAULT_PROFILES``
    (or your own) to opt into per-class link conditions.
    """

    def __init__(self, zones: Mapping[str, str],
                 profiles: Optional[Mapping[str, LinkProfile]] = None,
                 default_zone: str = DEFAULT_ZONE):
        self.zones: Dict[str, str] = dict(zones)
        self.default_zone = default_zone
        self.profiles: Dict[str, LinkProfile] = dict(profiles or {})
        for cls in self.profiles:
            if cls not in LINK_CLASSES:
                raise ValueError(f"unknown link class {cls!r}; "
                                 f"have {LINK_CLASSES}")

    # -- zones -----------------------------------------------------------------
    def zone(self, node_id: str) -> str:
        return self.zones.get(node_id, self.default_zone)

    def zone_names(self, workers: Optional[Iterable[str]] = None
                   ) -> Tuple[str, ...]:
        """Distinct zones, sorted — of ``workers`` when given, else of
        every annotated worker."""
        ids = self.zones.keys() if workers is None else workers
        return tuple(sorted({self.zone(w) for w in ids}))

    def members(self, zone: str, workers: Iterable[str]) -> Tuple[str, ...]:
        return tuple(sorted(w for w in workers if self.zone(w) == zone))

    def by_zone(self, workers: Iterable[str]) -> Dict[str, Tuple[str, ...]]:
        out: Dict[str, list] = {}
        for w in sorted(workers):
            out.setdefault(self.zone(w), []).append(w)
        return {z: tuple(ws) for z, ws in out.items()}

    # -- links -----------------------------------------------------------------
    def link_class(self, a: str, b: str) -> str:
        """Class of the a↔b link from the two endpoints' zones."""
        return link_class(self.zone(a), self.zone(b))

    def profile(self, a: str, b: str) -> Optional[LinkProfile]:
        """The link's profile override, or None (fall back to flat
        defaults)."""
        return self.profiles.get(self.link_class(a, b))

    def byte_cost(self, a: str, b: str) -> float:
        prof = self.profile(a, b)
        return prof.byte_cost if prof is not None else 1.0

    # -- relays ----------------------------------------------------------------
    def relay(self, zone: str, members: Iterable[str]) -> Optional[str]:
        """The zone's elected relay among ``members`` (see
        :func:`relay_for`)."""
        return relay_for(zone, members, self.zone)

    def is_relay(self, node_id: str, members: Iterable[str]) -> bool:
        return self.relay(self.zone(node_id), members) == node_id

    # -- construction helpers ----------------------------------------------------
    @classmethod
    def flat(cls, workers: Iterable[str],
             zone: str = DEFAULT_ZONE) -> "Topology":
        """Everyone in one zone — the old world, spelled explicitly."""
        return cls({w: zone for w in workers})

    @classmethod
    def zoned(cls, workers: Iterable[str], n_zones: int,
              profiles: Optional[Mapping[str, LinkProfile]] = None,
              zone_fmt: str = "z{}") -> "Topology":
        """Round-robin ``workers`` over ``n_zones`` zones — the standard
        N-zone test/bench cluster shape, deterministic in worker order."""
        if n_zones < 1:
            raise ValueError(f"need at least one zone, got {n_zones}")
        zones = {w: zone_fmt.format(i % n_zones)
                 for i, w in enumerate(sorted(workers))}
        return cls(zones, profiles=profiles)

    def __repr__(self) -> str:
        zs = self.zone_names()
        return f"Topology(zones={len(zs)}:{list(zs)}, workers={len(self.zones)})"


def parse_zone_map(spec: Union[str, Mapping[str, str], None]
                   ) -> Dict[str, str]:
    """``"gw0=eu/a,gw1=eu/b"`` (CLI form) or a mapping → ``{id: zone}``."""
    if spec is None:
        return {}
    if isinstance(spec, Mapping):
        return dict(spec)
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        wid, sep, zone = part.partition("=")
        if not sep or not wid or not zone:
            raise ValueError(f"zone spec {part!r} is not ID=ZONE")
        out[wid] = zone
    return out


__all__ = [
    "DEFAULT_PROFILES", "DEFAULT_ZONE", "INTER", "INTRA", "LINK_CLASSES",
    "LinkProfile", "Topology", "WAN", "hrw_score", "link_class",
    "parse_zone_map", "relay_for", "zone_region",
]
