"""Owner-driven reaper: acked tombstone GC for expired keys.

Dropping a key from a replicated store is the one operation a join
cannot express — so it must be *agreed*, not gossiped. The protocol
keeps the agreement surface as small as possible:

1. **Propose.** The key's rendezvous owner (``KeyOwnership.owner``)
   notices the key's expiry has passed (plus a ``grace`` slack for clock
   skew and in-flight touches) and sends a ``reap`` frame
   ``(key, epoch, expiry)`` to every *other* member of the key's write
   replica set. Read replicas subscribe to the key's gossip but are
   **not** in the quorum — they never gate a reap.
2. **Ack.** A member acks (``reap-ack … ok=1``) iff its own lifecycle
   state agrees the incarnation is dead: same epoch, no extension beyond
   the proposed expiry, and the expiry has passed on its clock too. A
   member that has seen a *later* epoch acks as well (the reap is
   already moot — committing ``epoch+1 ≤`` its epoch is absorbed). A
   member holding a fresher expiry nacks, which cancels the proposal
   until the new deadline passes.
3. **Commit.** Once the owner holds acks from the whole current replica
   set (re-derived every step, so departed workers never wedge the
   quorum), it re-checks its own agreement and commits the tombstone —
   ``LatticeStore.life_delta(key, (epoch+1, expiry))`` — as an ordinary
   δ-mutation through the engine. From there the tombstone propagates
   by the normal push/pull anti-entropy machinery, idempotently, and
   ⊥-absorbs every straggler delta still at the reaped epoch.

The quorum is what makes the drop safe under the paper's network model:
an un-acked member might hold (or later receive and forward) a write
the owner never saw; with its ack in hand, any such write is provably
bounded by the acked expiry, so absorbing it loses nothing the TTL
contract had promised to keep. A write that races the commit *after*
acking is the inherent TTL race — the ack window narrows it to the
commit round-trip, and a revived key starts a fresh incarnation above
the tombstone (``StoreReplica`` bumps the epoch on writes to a
tombstoned key), so late reaps can never kill a revival.

All protocol state is volatile (proposals restart after a crash — the
durable expiry makes them re-derivable), and per-peer ack state is
registered with the replica's peer-state registry so departed peers are
pruned in the same place as every other per-peer map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Optional, Set, Tuple

from .lattice import expired, tombstone


@dataclass
class _Proposal:
    """One in-flight reap: the (epoch, expiry) snapshot it is valid for,
    the peers that acked it, the retransmit clock, and whether a member
    vetoed it (uncommittable until the next throttled retransmit)."""

    epoch: int
    expiry: float
    acks: Set[str] = field(default_factory=set)
    last_sent: float = float("-inf")
    nacked: bool = False


class ReaperProtocol:
    """The proposer half of acked tombstone GC, attached to one replica.

    Construction wires the protocol into the engine: ``replica.reaper``
    routes incoming ``reap``/``reap-ack`` messages here,
    ``Replica.on_periodic`` drives :meth:`step` every anti-entropy
    round, and the ack sets join the replica's per-peer state registry
    (pruned with departed peers, reset on crash recovery).

    Only the write replica set participates: proposals go to
    ``ownership.owners(key)``, and only the primary owner proposes.
    Replicas that merely *read* a key (``ownership.reads``) see the
    tombstone arrive through gossip like any other delta.
    """

    def __init__(self, replica: Any, ownership: Any, *,
                 grace: float = 0.0, retry: float = 3.0,
                 evict_foreign: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        from ..core.store import LatticeStore   # lazy: core imports us

        if not isinstance(replica.X, LatticeStore):
            raise TypeError("ReaperProtocol needs a keyed replica "
                            "(StoreReplica / LatticeStore bottom)")
        self.replica = replica
        self.ownership = ownership
        self.grace = grace
        self.retry = retry
        self.evict_foreign = evict_foreign
        self._clock = clock
        self._pending: Dict[str, _Proposal] = {}
        self.reaped = 0                  # committed tombstones (stats)
        self.evicted = 0                 # dropped foreign copies (stats)
        replica.reaper = self
        replica.track_peer_state(self._prune_peers)

    # -- clock ------------------------------------------------------------------
    def now(self) -> float:
        return self._clock() if self._clock is not None else self.replica.now()

    # -- the periodic drive (from Replica.on_periodic) ---------------------------
    def step(self) -> int:
        """Scan for reap-eligible keys this replica owns, retransmit
        outstanding proposals, commit fully-acked ones, and drop
        *foreign* expired copies (keys this replica neither write- nor
        read-replicates — e.g. an ingress gateway's local copy of a
        session it forwarded to the owners; the tombstone never routes
        here, so without local eviction those copies linger forever).
        Foreign eviction is purely local and best-effort: the key's
        convergence obligations rest entirely on its replica set, and
        the causal delta buffer — not ``X`` — is what re-ships an
        undelivered write. Returns the number of tombstones committed
        this step."""
        store = self.replica.X
        # one dict materialization for the whole scan (life_of/tombstoned
        # per key would rebuild these tuples O(keys) times per round)
        life = dict(store.life)
        values = store.as_dict()
        now = self.now()
        committed = 0
        evict = []
        for key in sorted(store.all_keys()):
            epoch, expiry = life.get(key, (0, float("-inf")))
            tombstoned = epoch > 0 and key not in values
            if tombstoned or not expired((epoch, expiry),
                                         now - self.grace):
                self._pending.pop(key, None)
                if tombstoned and self.evict_foreign and self._foreign(key):
                    evict.append(key)    # someone else's tombstone: shed
                continue
            if self.replica.id not in self.ownership.owners(key):
                self._pending.pop(key, None)
                if self.evict_foreign and self._foreign(key):
                    evict.append(key)    # expired ingress copy: shed
                continue
            if self.ownership.owner(key) != self.replica.id:
                self._pending.pop(key, None)   # member, but not proposer
                continue
            prop = self._pending.get(key)
            if prop is None or (prop.epoch, prop.expiry) != (epoch, expiry):
                # fresh proposal (or the key was touched: start over —
                # stale acks must not commit against a newer expiry)
                prop = _Proposal(epoch, expiry)
                self._pending[key] = prop
            members = self._quorum(key)
            if not prop.nacked and members <= prop.acks:
                if self._commit(key, prop):
                    committed += 1
                continue
            if now - prop.last_sent >= self.retry:
                prop.nacked = False      # give the nacker a fresh vote
                for dst in members - prop.acks:
                    self.replica._post(dst, ("reap", key, epoch, expiry))
                prop.last_sent = now
        if evict:
            # restrict the CURRENT X, not the loop-entry snapshot: a
            # commit above already advanced it, and assigning the stale
            # snapshot back would discard the just-committed tombstone
            cur = self.replica.X
            self.replica.X = cur.restrict(cur.all_keys() - set(evict))
            self.evicted += len(evict)
        return committed

    def _foreign(self, key: str) -> bool:
        """Neither in the key's write set nor its read set (and the key
        *has* a live replica set to carry it) — safe to shed locally."""
        owners = self.ownership.owners(key)
        return (bool(owners) and self.replica.id not in owners
                and not self.ownership.reads(self.replica.id, key))

    def _quorum(self, key: str) -> FrozenSet[str]:
        """The acks a commit needs: every *current* write-set member but
        this replica — recomputed per step, so a departed worker leaves
        the quorum instead of wedging it."""
        return frozenset(self.ownership.owners(key)) - {self.replica.id}

    def _commit(self, key: str, prop: _Proposal) -> bool:
        from ..core.store import LatticeStore

        self._pending.pop(key, None)
        epoch, expiry = self.replica.X.life_of(key)
        if (epoch, expiry) != (prop.epoch, prop.expiry):
            return False             # touched between final ack and commit
        self.replica.operation(lambda S: LatticeStore.life_delta(
            key, tombstone((prop.epoch, prop.expiry), prop.expiry)))
        self.reaped += 1
        tracer = getattr(self.replica, "tracer", None)
        if tracer is not None:
            tracer.emit("reap_commit", key=key, epoch=prop.epoch,
                        acks=len(prop.acks))
        return True

    # -- message plane (routed from Replica.on_receive) ---------------------------
    def on_ack(self, src: str, msg: Tuple) -> None:
        """Fold one ``reap-ack`` into its proposal. (The request side —
        agreeing to someone *else's* proposal — lives on the engine
        itself, ``Replica._reap_agree``: a member votes from its own
        lifecycle state and clock and needs no reaper of its own.)"""
        _, key, epoch, expiry, ok = msg
        prop = self._pending.get(key)
        if prop is None or (prop.epoch, prop.expiry) != (epoch, expiry):
            return                   # stale ack for a superseded proposal
        if ok:
            prop.acks.add(src)
        else:
            # a member holds a fresher expiry / unseen incarnation: hold
            # the proposal open but uncommittable, keeping its retransmit
            # clock — popping it here would recreate it next step with a
            # fresh clock and bypass the retry throttle entirely. Gossip
            # converges the lifecycle state, after which either the
            # (epoch, expiry) snapshot changes (proposal restarts) or a
            # throttled retransmit collects the vote.
            prop.acks.discard(src)
            prop.nacked = True

    # -- registry hooks ------------------------------------------------------------
    def _prune_peers(self, live: FrozenSet[str]) -> None:
        """Departed peers leave every proposal's ack set (the quorum
        itself re-derives from live ownership each step)."""
        for prop in self._pending.values():
            prop.acks &= set(live)

    def reset(self) -> None:
        """Crash recovery: proposals are volatile (durable expiries make
        them re-derivable); stats survive for the process lifetime."""
        self._pending.clear()

    def pending_keys(self) -> FrozenSet[str]:
        return frozenset(self._pending)
