"""Hierarchical gossip: intra-zone push, relay-batched cross-zone pull.

On a flat mesh every replica pushes delta-intervals to every neighbor,
so a Z-zone cluster pays O(members²) cross-zone traffic — the regime
where delta sync stops beating state sync on the WAN bill. The
:class:`HierarchicalGossip` shipping policy restructures the same
anti-entropy engine around the topology:

* **push gossip stays intra-zone** — a replica's broadcast targets only
  its zone-mates (fast, cheap links);
* **one elected relay per zone** (:func:`repro_torch.topology.relay_for`: the
  HRW-highest live member, so election is a pure function of the
  membership view and failover is automatic when the relay leaves the
  live set) additionally targets the *other zones' relays*;
* **the cross-zone channel is digest-sync only** — a relay ships the
  remote relay a compact :class:`~repro_torch.core.digest.StoreDigest` and
  gets back exactly the rows it lacks; raw delta fanout never crosses a
  zone boundary. Both relays digest each other, so rows flow both ways,
  and each relay re-buffers what it pulls (``_receive_digest_response``
  records the response) so the next intra-zone push round spreads it to
  zone-mates.

Correctness is the paper's Def. 6 (causal delta-merging condition):
a digest response is join-equivalent to the responder's full state for
the requester, and joining a full state is always permitted — so
routing all cross-zone repair through relayed, aggregated digest
exchanges is just another join-equivalent delivery order, and every
replica still converges to the join of all operations (see DESIGN.md
§6 and §11). What changes is only *where* bytes travel: O(zones²)
digest pairs cross the WAN instead of O(members²) delta streams.

Composes with the existing policies: ``bp+rr`` sharpen the intra-zone
pushes, ``ShardByKey`` restricts both push and pull traffic to owned
keys, and an extra ``DigestExchange(every=k)`` adds periodic intra-zone
pull repair. The policy never forces basic mode and works with or
without the wire codec.
"""

from __future__ import annotations

from typing import List, Optional

from ..topology import Topology
from .propagation import Compose, ShippingPolicy, make_policy


class HierarchicalGossip(ShippingPolicy):
    """Zone-aware target selection + cross-zone digest routing.

    ``inter_every=k`` throttles the relay's cross-zone exchanges to
    every k-th round (k=1: every round). Throttling happens in
    :meth:`targets` — on an off round the cross-zone relays are simply
    not addressed — so a cross-zone destination, whenever it *is*
    addressed, always gets a digest request (:meth:`pull_round` is true
    for any cross-zone link), never raw fanout.
    """

    pull_exchange = True
    pure_pull = False

    def __init__(self, topology: Topology, *, inter_every: int = 1):
        if not isinstance(inter_every, int) or inter_every <= 0:
            raise ValueError(f"inter_every must be a positive int, "
                             f"got {inter_every!r}")
        self.topology = topology
        self.inter_every = inter_every
        self.name = "hier" if inter_every == 1 else f"hier:{inter_every}"

    # -- helpers ---------------------------------------------------------------
    def _members(self, replica, neighbors: List[str]) -> List[str]:
        """The live membership view this replica acts on: itself plus
        its current neighbor list (elastic membership keeps that list
        pruned to live workers, which is what makes relay election
        self-healing)."""
        return sorted({replica.id, *neighbors})

    def intra_peers(self, replica, neighbors: List[str]) -> List[str]:
        me = self.topology.zone(replica.id)
        return [j for j in neighbors if self.topology.zone(j) == me]

    def relay_targets(self, replica, neighbors: List[str]) -> List[str]:
        """Other zones' relays — addressed only when this replica is its
        own zone's relay. A zone with no live member has no relay and is
        skipped (its keys are repaired when it comes back)."""
        members = self._members(replica, neighbors)
        me = self.topology.zone(replica.id)
        if self.topology.relay(me, members) != replica.id:
            return []
        out = []
        for zone in self.topology.zone_names(members):
            if zone == me:
                continue
            r = self.topology.relay(zone, members)
            if r is not None and r in neighbors:
                out.append(r)
        return out

    # -- policy hooks ------------------------------------------------------------
    def targets(self, replica, neighbors: List[str]) -> List[str]:
        out = self.intra_peers(replica, neighbors)
        if self.inter_every == 1 or replica.rounds % self.inter_every == 0:
            out += self.relay_targets(replica, neighbors)
        return out

    def pull_round(self, replica, dst: Optional[str] = None) -> bool:
        """Any cross-zone destination is a digest exchange; intra-zone
        destinations stay push (``dst=None`` — a destination-free probe,
        e.g. ``BasicNode.choose`` previews — reads as local)."""
        if dst is None:
            return False
        return self.topology.zone(dst) != self.topology.zone(replica.id)

    def ack_peers(self, replica, neighbors: List[str]) -> List[str]:
        """Only zone-mates gate buffer GC: cross-zone relays are reached
        by digest pull and never ack. (A single-member zone therefore
        has *no* ack peers — the engine clears its buffer and relies on
        digest-sync, which computes responses from ``X``.)"""
        return self.intra_peers(replica, neighbors)


def hierarchical_policy(topology: Topology, base: Optional[str] = "bp+rr",
                        *, inter_every: int = 1) -> ShippingPolicy:
    """The standard zoned-cluster policy stack: ``base`` (a
    :func:`make_policy` spec sharpening intra-zone pushes, or None for
    plain ship-all) composed with :class:`HierarchicalGossip`."""
    hier = HierarchicalGossip(topology, inter_every=inter_every)
    if not base:
        return hier
    return Compose(make_policy(base), hier)


__all__ = ["HierarchicalGossip", "hierarchical_policy"]
