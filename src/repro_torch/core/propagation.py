"""Unified delta-propagation runtime: one replica engine, pluggable
shipping policies.

The paper leaves ``chooseᵢ(Xᵢ, Dᵢ)`` — *what* to ship each anti-entropy
round — as an open policy. The seed hard-coded two answers in two separate
node classes; this module extracts the shared send/receive/ack/GC machinery
into a single :class:`Replica` engine and makes the choice a first-class
:class:`ShippingPolicy` value:

* ``ShipAll``              — the paper-faithful baseline: ship every
                             buffered delta the receiver has not acked
                             (Algorithm 2) or the whole delta-group
                             (Algorithm 1).
* ``ShipStateEveryK``      — Algorithm 1's loss-protection: every k-th
                             round ship the full state instead of the
                             delta-group.
* ``AvoidBackPropagation`` — BP of Enes et al. (Efficient Synchronization
                             of State-based CRDTs): delta-buffer entries
                             are tagged with the replica they arrived
                             from; never echo a delta back to its origin.
* ``RemoveRedundant``      — RR: drop delta-interval entries already ≤ a
                             tracked lower bound of the receiver's state
                             (maintained from cumulative acks), so
                             redundant state never enters a delta-group.
* ``DigestBudget``         — byte-budgeted tensor shipping: use the
                             ``kernels.ops.chunk_digest`` one-pass digest
                             to keep only the top-magnitude chunks of a
                             ``TensorState`` payload (Algorithm-1 mode
                             only; see the class docstring).
* ``DigestExchange``       — the first *pull*-shaped exchange: instead of
                             pushing deltas, a replica ships a compact
                             digest of what it holds (chunk-version
                             columns + opaque content hashes) and the
                             peer replies with exactly the rows the
                             digest lacks (Enes et al.'s digest-driven
                             sync; see the class docstring).
* ``Compose``              — AND/OR composition of the above (``bp+rr``).

Both paper algorithms run on the same engine:

* *basic* mode (``causal=False``) is Algorithm 1 — the delta buffer is a
  volatile delta-group, cleared after every broadcast, no acks; convergence
  under loss relies on periodic full-state shipping.
* *causal* mode (``causal=True``) is Algorithm 2 — the buffer is a
  sequence of delta-intervals under a durable counter ``c``; a sender
  ships Δᵢᵃ'ᵇ from the receiver's acked index (the causal delta-merging
  condition, Def. 6), acked entries are garbage-collected.

Filtering never violates the merging condition: BP removes entries whose
origin *is* the receiver and RR removes entries provably ≤ the receiver's
state, so the receiver's post-join state still covers the full interval
and its ack stays truthful. When a policy filters an interval down to
nothing, the engine ships the ⊥ payload anyway — structurally tiny — so
acks keep advancing and the GC horizon moves (the bookkeeping Enes et al.
note naive BP forgets). The ``ghost_check`` machinery (Prop. 2) runs
unchanged under every policy and operationally verifies exactly this.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence

from ..obs.trace import spanned
from .digest import StoreDigest, digest_diff, store_digest
from .sim import Node, structural_size
from .store import LatticeStore


def stable_seed(node_id: str) -> int:
    """Deterministic per-replica seed. ``hash(str)`` is salted per process
    (PYTHONHASHSEED), so seeding from it makes "reproducible" runs
    irreproducible across processes; CRC32 is stable everywhere."""
    return zlib.crc32(node_id.encode("utf-8")) & 0xFFFF


@dataclass
class DeltaEntry:
    """One delta-buffer slot: the delta plus where it came from.

    ``origin is None`` means the delta was generated by a local δ-mutation;
    otherwise it is the neighbor id the delta arrived from (what BP needs).
    """

    delta: Any
    origin: Optional[str] = None


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

class ShippingPolicy:
    """chooseᵢ(Xᵢ, Dᵢ) as an object. Subclasses override any hook:

    * ``include``         — keep this buffered entry in the payload to
                            ``dst``? (per-entry filter; AND-composed)
    * ``want_full_state`` — force shipping the full state this round?
                            (OR-composed)
    * ``finalize``        — last-touch transform of the joined payload
                            (e.g. byte-budget trimming; chained)
    * ``credit``          — what of an acked buffered entry may enter the
                            receiver's known-state lower bound (chained).
                            The default (everything) is sound for BP/RR,
                            whose filters only drop state the receiver
                            *already holds*; a policy that withholds
                            state the receiver does NOT hold (ShardByKey
                            restricting to the destination's shard) must
                            narrow the credit the same way, or the bound
                            over-approximates and RR would forever trim
                            state the receiver genuinely misses (e.g.
                            keys that move into its shard on rebalance).

    ``requires_known_state`` asks the engine to maintain, per neighbor, a
    monotone lower bound of that neighbor's state from cumulative acks.
    ``pull_exchange`` / ``pure_pull`` / ``pull_round`` are the pull-mode
    contract (all-off by default): a pull policy sets ``pull_exchange``
    and decides per round via ``pull_round`` whether the broadcast ships
    digest requests instead of pushes; ``pure_pull`` additionally tells
    the engine the delta buffer is never shipped (cleared each round).
    """

    name = "all"
    requires_known_state = False
    pull_exchange = False
    pure_pull = False

    def pull_round(self, replica: "Replica",
                   dst: Optional[str] = None) -> bool:
        return False

    def targets(self, replica: "Replica",
                neighbors: List[str]) -> List[str]:
        """Which neighbors this round's broadcast addresses at all
        (chained; fanout sampling applies after). The topology hook:
        ``HierarchicalGossip`` restricts a non-relay to its own zone so
        cross-zone links never see raw fanout. Default: everyone."""
        return neighbors

    def ack_peers(self, replica: "Replica",
                  neighbors: List[str]) -> List[str]:
        """Which neighbors gate delta-buffer GC (chained). The horizon
        waits on acks/watermarks only from peers this policy actually
        *pushes* to — a peer reached purely by digest pull never acks,
        and letting it gate GC would grow the buffer forever. Default:
        everyone (every neighbor is a push target on a flat mesh)."""
        return neighbors

    def include(self, replica: "Replica", dst: str, index: int,
                entry: DeltaEntry) -> bool:
        return True

    def want_full_state(self, replica: "Replica", dst: str) -> bool:
        return False

    def finalize(self, replica: "Replica", dst: str, payload: Any) -> Any:
        return payload

    def credit(self, replica: "Replica", dst: str, delta: Any) -> Any:
        return delta

    def restrict_pull(self, replica: "Replica", dst: str,
                      store: Any) -> Any:
        """Shape a digest-exchange response for ``dst`` (chained). A
        policy may only drop state ``dst`` does not *replicate* (a
        routing restriction — ShardByKey); it must never trim rows the
        requester genuinely lacks within its shard. Pull correctness
        rests on the response being join-equivalent to the responder's
        full state for the requester, and pure pull has no full-state
        fallback rounds to rescue a trimmed tail (which is why this is a
        separate hook and responses do NOT pass through ``finalize`` —
        a composed DigestBudget would re-trim every response to the same
        top-energy chunks forever). Default: ship the whole diff."""
        return store

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


class ShipAll(ShippingPolicy):
    """Paper-faithful baseline: every unacked entry ships."""

    name = "all"


class ShipStateEveryK(ShippingPolicy):
    """Every k-th round ship the full state (Algorithm 1's loss cover)."""

    def __init__(self, k: int):
        if not isinstance(k, int) or k <= 0:
            raise ValueError(f"ship-state-every period must be a positive "
                             f"int, got {k!r}")
        self.k = k
        self.name = f"every:{k}"

    def want_full_state(self, replica: "Replica", dst: str) -> bool:
        return replica.rounds % self.k == 0


class AvoidBackPropagation(ShippingPolicy):
    """BP: never ship a delta back to the replica it came from."""

    name = "bp"

    def include(self, replica: "Replica", dst: str, index: int,
                entry: DeltaEntry) -> bool:
        return entry.origin != dst


class RemoveRedundant(ShippingPolicy):
    """RR: remove state the receiver provably holds from outgoing payloads.

    The engine maintains ``replica.known_state(dst)`` — the join of
    everything ``dst`` has acknowledged (acked payloads + buffered entries
    below the cumulative ack) — a sound under-approximating lower bound of
    the receiver's state, so filtering against it can only remove state the
    receiver already has. Two granularities:

    * whole entries: an entry ≤ known never enters the delta-group;
    * parts: when the lattice value implements ``decompose()`` (GCounter,
      PNCounter, DotSumStore, TensorState, …), ``finalize`` re-joins only
      the join-irreducible atoms **not** covered by the receiver — this is
      what trims a re-gossiped full-state entry (e.g. a crash-recovery
      fallback another replica buffered) down to the part the receiver is
      actually missing.
    """

    name = "rr"
    requires_known_state = True

    def include(self, replica: "Replica", dst: str, index: int,
                entry: DeltaEntry) -> bool:
        known = replica.known_state(dst)
        if known is None:
            return True
        return not entry.delta.leq(known)

    def finalize(self, replica: "Replica", dst: str, payload: Any) -> Any:
        known = replica.known_state(dst)
        atoms = getattr(payload, "decompose", None)
        if known is None or atoms is None:
            return payload
        fresh = [a for a in atoms() if not a.leq(known)]
        trimmed = replica.bottom
        for a in fresh:
            trimmed = trimmed.join(a)
        return trimmed


class DigestBudget(ShippingPolicy):
    """Byte-budgeted ``TensorState`` shipping via the chunk-digest kernel.

    ``finalize`` replaces a ``TensorState`` payload with its top-magnitude
    chunks under ``budget_bytes`` (``tensor_lattice.digest_select``, fed by
    ``kernels.ops.chunk_digest`` — one pass over the tensor on the card).

    Algorithm-1 (basic) mode only: trimming a payload means the receiver
    saw a strict subset, which is indistinguishable from partial message
    loss — exactly what Algorithm 1 already tolerates via periodic
    full-state shipping (compose with ``ShipStateEveryK``; full-state
    rounds ship whole, otherwise the deterministic energy ranking would
    re-pick the same top chunks forever and the tail would never
    propagate). In causal mode the receiver's ack would claim coverage of
    chunks that were trimmed away, corrupting the GC horizon, so the
    engine rejects the combination at construction.
    """

    requires_basic_mode = True

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError(f"digest budget must be positive, got "
                             f"{budget_bytes!r}")
        self.budget_bytes = budget_bytes
        self.name = f"digest:{budget_bytes}"

    def finalize(self, replica: "Replica", dst: str, payload: Any) -> Any:
        from .tensor_lattice import TensorState, digest_select
        from .store import digest_select_store
        if isinstance(payload, TensorState):
            return digest_select(payload, self.budget_bytes)
        if isinstance(payload, LatticeStore):
            # keyed mode: one budget across the whole store — the energy
            # ranking picks which *keys'* chunks ship, not just which
            # chunks within one object
            return digest_select_store(payload, self.budget_bytes)
        return payload


class DigestExchange(ShippingPolicy):
    """Digest-driven request/response anti-entropy — the pull exchange.

    On a pull round the replica does NOT push deltas: it ships each
    target a compact :class:`~repro_torch.core.digest.StoreDigest` of its own
    resident state (per-(key, tensor) chunk-version columns + per-key
    content hashes for opaque lattices). The receiver diffs the digest
    against its state and replies with a delta containing **only the
    rows the requester provably lacks** — under the wire codec the
    filter runs at ``encode_store`` time and the response decodes into
    ``SparseChunks`` row sets that join in O(shipped chunks).

    ``every=1`` (the default, spec ``"digest-sync"``) is *pure pull*:
    every round is a digest round. Responses are computed from the
    responder's full resident state, never from its delta buffer, so the
    buffer serves no purpose and the engine clears it after each round —
    which is also what keeps causal-mode memory bounded despite no acks
    flowing (no pushes ⇒ no acks ⇒ the ack-driven GC horizon would never
    advance).

    ``every=k`` (spec ``"digest-sync:k"``, typically composed with a
    push policy, e.g. ``"bp+rr+digest-sync:8"``) is the *hybrid*: normal
    push rounds carry delta-intervals and keep the ack/GC machinery
    moving, and every k-th round is a digest pull that repairs whatever
    push-shipping missed (loss beyond the buffer, a reconnect, a
    read-only replica that never generates deltas) without the
    full-state fallback's bytes.

    Pull-sync preserves the causal delta-merging condition because a
    digest response is *join-equivalent to the responder's full state*
    for the requester (every filtered row is one the requester's version
    dominates; every filtered opaque key is value-equal) — and joining a
    full state is always permitted (Def. 6). See DESIGN.md §6.
    """

    pull_exchange = True

    def __init__(self, every: int = 1):
        if not isinstance(every, int) or every <= 0:
            raise ValueError(f"digest-sync period must be a positive int, "
                             f"got {every!r}")
        self.every = every
        self.name = "digest-sync" if every == 1 else f"digest-sync:{every}"

    @property
    def pure_pull(self) -> bool:
        return self.every == 1

    def pull_round(self, replica: "Replica",
                   dst: Optional[str] = None) -> bool:
        return replica.rounds % self.every == 0


class Compose(ShippingPolicy):
    """AND of ``include``, OR of ``want_full_state``, chained ``finalize``."""

    def __init__(self, *policies: ShippingPolicy):
        assert policies
        self.policies = policies
        self.name = "+".join(p.name for p in policies)

    @property
    def requires_known_state(self) -> bool:  # type: ignore[override]
        return any(p.requires_known_state for p in self.policies)

    @property
    def requires_basic_mode(self) -> bool:
        return any(getattr(p, "requires_basic_mode", False)
                   for p in self.policies)

    @property
    def pull_exchange(self) -> bool:
        return any(p.pull_exchange for p in self.policies)

    @property
    def pure_pull(self) -> bool:
        return any(p.pure_pull for p in self.policies)

    def pull_round(self, replica, dst=None) -> bool:
        return any(p.pull_round(replica, dst) for p in self.policies
                   if p.pull_exchange)

    def targets(self, replica, neighbors):
        for p in self.policies:
            neighbors = p.targets(replica, neighbors)
        return neighbors

    def ack_peers(self, replica, neighbors):
        for p in self.policies:
            neighbors = p.ack_peers(replica, neighbors)
        return neighbors

    def include(self, replica, dst, index, entry) -> bool:
        return all(p.include(replica, dst, index, entry)
                   for p in self.policies)

    def want_full_state(self, replica, dst) -> bool:
        return any(p.want_full_state(replica, dst) for p in self.policies)

    def finalize(self, replica, dst, payload):
        for p in self.policies:
            payload = p.finalize(replica, dst, payload)
        return payload

    def credit(self, replica, dst, delta):
        for p in self.policies:
            delta = p.credit(replica, dst, delta)
        return delta

    def restrict_pull(self, replica, dst, store):
        for p in self.policies:
            store = p.restrict_pull(replica, dst, store)
        return store


def make_policy(spec: str) -> ShippingPolicy:
    """Parse ``"all"``, ``"bp"``, ``"rr"``, ``"every:5"``,
    ``"digest:4096"``, ``"digest-sync"`` / ``"digest-sync:8"``, or
    ``"+"``-joined combinations (``"bp+rr"``)."""

    def atom(s: str) -> ShippingPolicy:
        s = s.strip().lower()
        if s in ("all", "ship-all", "ship_all"):
            return ShipAll()
        if s in ("bp", "avoid-bp", "avoid_back_propagation"):
            return AvoidBackPropagation()
        if s in ("rr", "remove-redundant", "remove_redundant"):
            return RemoveRedundant()
        if s in ("digest-sync", "digest_sync"):
            return DigestExchange()
        if s.startswith(("digest-sync:", "digest_sync:")):
            return DigestExchange(int(s.split(":", 1)[1]))
        if s.startswith("every:"):
            return ShipStateEveryK(int(s.split(":", 1)[1]))
        if s.startswith("digest:"):
            return DigestBudget(int(s.split(":", 1)[1]))
        raise ValueError(f"unknown shipping policy {s!r}")

    parts = [p for p in spec.split("+") if p.strip()]
    if not parts:
        raise ValueError(f"empty shipping policy spec {spec!r}")
    if len(parts) == 1:
        return atom(parts[0])
    return Compose(*[atom(p) for p in parts])


def causal_policy_spec(spec: str, context: str) -> str:
    """Validate a CLI policy spec for a causal (Algorithm 2) replica and
    return it unchanged — lets argparse ``type=`` hooks fail at parse time
    instead of after expensive setup. ``context`` names the gossip the
    error message should mention."""
    p = make_policy(spec)
    if getattr(p, "requires_basic_mode", False):
        raise ValueError(f"{spec!r} is basic-mode only; {context} is "
                         "causal (Algorithm 2)")
    return spec


POLICY_SPECS = ("all", "every:5", "bp", "rr", "bp+rr", "digest-sync")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class Replica(Node):
    """The unified anti-entropy engine behind Algorithms 1 and 2.

    State (causal mode): durable ``(store, c)``; volatile delta buffer
    ``entries: {index: DeltaEntry}``, ack map ``A``, and (when a policy
    asks) per-neighbor known-state lower bounds. Basic mode keeps the same
    buffer but clears it after every broadcast and runs ack-free.

    The durable state is always a :class:`~repro_torch.core.store.LatticeStore`.
    A replica constructed with a ``LatticeStore`` bottom runs in *keyed*
    mode: ``X`` **is** the store, deltas are store deltas touching any
    subset of keys, and per-key delta-intervals aggregate into store-level
    wire messages. A replica constructed with any other lattice value runs
    in *single-object* mode: the store holds that one object under
    ``SINGLE_KEY`` and ``X`` (plus every payload, buffer entry, and
    known-state bound) presents the unwrapped object — the original
    single-object API is exactly this one-key-store view.
    """

    SINGLE_KEY = "·"     # the one-key-store wrapper key (single-object mode)
    INFLIGHT_CAP = 8     # per-destination cap on remembered in-flight payloads
    TRACE_KEY_CAP = 256  # keys per trace event before truncation flags

    def __init__(self, node_id: str, bottom: Any, neighbors: Sequence[str],
                 *, causal: bool = True,
                 policy: Optional[ShippingPolicy] = None,
                 rng: Optional[random.Random] = None,
                 ghost_check: bool = False,
                 fanout: Optional[int] = None,
                 transitive: bool = True,
                 wire: Optional[Any] = None,
                 resident: bool = False,
                 device="cuda",
                 tracer: Optional[Any] = None):
        super().__init__(node_id)
        self.bottom = bottom
        self._keyed = isinstance(bottom, LatticeStore)
        # durable state: always a store (keyed) / one-key store (wrapped)
        self.store = (bottom if self._keyed
                      else LatticeStore.of({self.SINGLE_KEY: bottom}))
        self.c = 0                           # durable in causal mode
        self.entries: Dict[int, DeltaEntry] = {}   # volatile delta buffer
        self.A: Dict[str, int] = {}                # volatile ack map
        self._known: Dict[str, Any] = {}           # volatile ack-derived
        # basic mode: per-destination counter watermark of what has been
        # broadcast to THAT neighbor. Algorithm 1 clears D after a full
        # broadcast; under fanout sampling a blanket clear would silently
        # drop deltas for every unsampled neighbor (they only ever
        # recovered via periodic full-state rounds), so the engine clears
        # per destination instead: an entry leaves the buffer only once
        # every current neighbor's watermark has passed it. (volatile)
        self._basic_sent: Dict[str, int] = {}
        # payloads awaiting ack, keyed (dst, counter-tag): lets acks credit
        # full-state fallbacks to known-state exactly (volatile, bounded)
        self._inflight: Dict[tuple, Any] = {}
        # per-peer state registry: every map keyed by a peer id (or whose
        # keys embed one) registers a pruner here, and prune_departed is
        # the ONE place departed peers are evicted — engine maps and
        # subsystem state (reaper ack sets) alike
        self._peer_pruners: List[Callable[[FrozenSet[str]], None]] = [
            self._prune_engine_maps]
        # key-lifecycle agent (a ReaperProtocol-shaped object attaches
        # itself here); driven from on_periodic, routed from on_receive
        self.reaper: Optional[Any] = None
        self._group_cache: Optional[Any] = None  # per-broadcast join reuse
        self._digest_cache: Optional[Any] = None  # per-broadcast digest
        self.neighbors = list(neighbors)
        self.causal = causal
        self.policy = policy if policy is not None else ShipAll()
        if getattr(self.policy, "requires_basic_mode", False) and causal:
            raise ValueError(
                f"policy {self.policy.name!r} trims payloads and is only "
                "sound in basic (Algorithm 1) mode — acks in causal mode "
                "would claim coverage of trimmed state")
        # wire codec (e.g. repro_torch.wire.WireCodec): when set, every message
        # ships as an encoded binary frame and byte accounting is measured
        # frame lengths; incoming frames decode to sparse columnar deltas
        # that join in O(shipped chunks)
        self.wire = wire
        # device-resident store hot path: adopt the durable store into
        # persistent stacked device columns before each anti-entropy round
        # (kernels.resident) on ``device`` — joins/digests then run in
        # O(1) launches
        self.resident = resident
        self.device = device
        # structured trace bus (a Tracer duck-typed on
        # .emit): None keeps every hot path at one attribute test
        self.tracer = tracer
        self._rx_bytes: Optional[int] = None   # current inbound msg size
        self.rng = rng or random.Random(stable_seed(node_id))
        self.ghost_check = ghost_check
        self.ghost_failures: List[str] = []
        # None ⇒ broadcast to every (possibly later-added) neighbor.
        self.fanout = fanout
        self.transitive = transitive
        self.rounds = 0

    # -- views ----------------------------------------------------------------
    @property
    def X(self):
        """The replicated object: the whole store (keyed mode) or the
        single wrapped object (single-object mode)."""
        if self._keyed:
            return self.store
        val = self.store.get(self.SINGLE_KEY)
        return val if val is not None else self.bottom

    @X.setter
    def X(self, value: Any) -> None:
        if self._keyed:
            self.store = value
        else:
            self.store = LatticeStore.of(
                {**self.store.as_dict(), self.SINGLE_KEY: value})

    @property
    def D(self):
        """The paper's ``D``: the delta-group value (basic mode) or the
        ``{index: delta}`` sequence (causal mode)."""
        if self.causal:
            return {n: e.delta for n, e in self.entries.items()}
        d = self.bottom
        for n in sorted(self.entries):
            d = d.join(self.entries[n].delta)
        return d

    def known_state(self, dst: str) -> Optional[Any]:
        """Monotone lower bound of ``dst``'s state (from cumulative acks),
        or None when the engine is not tracking it."""
        return self._known.get(dst)

    def now(self) -> float:
        """This replica's clock: simulated time when attached to the
        discrete-event simulator, wall time otherwise — what TTL touches
        and reap agreement read."""
        return self.sim.time if self.sim is not None else time.time()

    def track_peer_state(self, pruner: Callable[[FrozenSet[str]], None]
                         ) -> None:
        """Register a per-peer-state pruner with the single departed-peer
        registry (called from :meth:`prune_departed` with the live
        neighbor set). Any subsystem that keeps state keyed by peer id —
        the reaper's ack sets, a future flow-control window — registers
        here instead of growing its own cleanup path."""
        self._peer_pruners.append(pruner)

    # -- paper: on operationᵢ(mᵟ) ---------------------------------------------
    def operation(self, m_delta: Callable[[Any], Any]) -> Any:
        d = m_delta(self.X)
        self.X = self.X.join(d)
        self._record(d, origin=None)
        if self.tracer is not None:
            keys, trunc = self._trace_keys(d)
            ev = {"keys": keys, "tag": self.c - 1, "round": self.rounds}
            if trunc:
                ev["keys_truncated"] = True
            self.tracer.emit("write", **ev)
        return d

    # -- trace helpers (all behind `self.tracer is not None`) --------------------
    def _trace_keys(self, d: Any) -> tuple:
        """``(keys, truncated)`` for a payload: the touched store keys,
        capped at ``TRACE_KEY_CAP`` (events must stay small even when a
        full-state payload covers a huge store — the analyzer treats a
        truncated event as disabling key-level checks, not as ground
        truth)."""
        if isinstance(d, LatticeStore):
            ks = sorted(d.all_keys())
            if len(ks) > self.TRACE_KEY_CAP:
                return ks[:self.TRACE_KEY_CAP], True
            return ks, False
        return [self.SINGLE_KEY], False

    def _trace_join(self, src: str, d: Any, via: str,
                    rx_bytes: Optional[int], before: Any) -> None:
        """Emit ``delta_join`` for a received state-carrying payload:
        ``keys`` are the payload keys whose arrival *changed* this
        replica's state (per-key ``restrict().leq(before)`` — a multi-key
        payload can be new for one key and redundant for the rest);
        ``joined == 0`` marks a fully redundant arrival."""
        if isinstance(d, LatticeStore):
            ks = sorted(d.all_keys())
            trunc = len(ks) > self.TRACE_KEY_CAP
            changed = [k for k in ks[:self.TRACE_KEY_CAP]
                       if not d.restrict((k,)).leq(before)]
        else:
            trunc = False
            changed = [] if d.leq(before) else [self.SINGLE_KEY]
        ev = {"src": src, "via": via, "bytes": rx_bytes, "keys": changed,
              "joined": len(changed), "round": self.rounds}
        if trunc:
            ev["keys_truncated"] = True
        self.tracer.emit("delta_join", **ev)

    def _trace_post(self, dst: str, raw: tuple, shipped: Any,
                    full_state: bool) -> None:
        """Map an outbound engine message to its ship event. ``raw`` is
        the pre-encode tuple (keys are only extractable there); ``shipped``
        is what actually crosses the link (its frame length is the byte
        cost under a wire codec, the structural size otherwise — the same
        accounting the simulator and LinkStats record). Ack-class sends
        (``ack``/``reap-ack``) are deliberately not ship events: the ack
        is traced where it lands, at the payload's original sender."""
        kind = raw[0]
        size = (len(shipped) if isinstance(shipped, (bytes, bytearray))
                else structural_size(shipped))
        if kind == "delta":
            ev = {"dst": dst, "bytes": size, "full": bool(full_state),
                  "round": self.rounds}
            if self.causal and len(raw) > 2:
                ev["tag"] = raw[2]
            ev["keys"], trunc = self._trace_keys(raw[1])
            if trunc:
                ev["keys_truncated"] = True
            self.tracer.emit("delta_ship", **ev)
        elif kind == "handoff":
            keys, trunc = self._trace_keys(raw[1])
            ev = {"dst": dst, "bytes": size, "keys": keys,
                  "round": self.rounds}
            if trunc:
                ev["keys_truncated"] = True
            self.tracer.emit("handoff", **ev)
        elif kind == "digest-resp":
            # no keys: under the wire codec raw[1] is the responder's
            # pre-filter store — the rows that ship are only known at
            # encode time; the requester's delta_join names what landed
            self.tracer.emit("digest_resp", dst=dst, bytes=size,
                             round=self.rounds)
        elif kind == "reap":
            self.tracer.emit("reap_propose", dst=dst, key=raw[1],
                             epoch=raw[2], round=self.rounds)

    def _record(self, d: Any, origin: Optional[str]) -> None:
        self.entries[self.c] = DeltaEntry(d, origin)
        self.c += 1

    # -- paper: periodically ----------------------------------------------------
    @spanned("replica.periodic")
    def on_periodic(self) -> None:
        if not self.alive or not self.neighbors:
            return
        self.rounds += 1
        if self.resident:
            # (re-)adopt the durable store into resident device columns;
            # a no-op when the current store already carries the cache
            from ..kernels import resident as _resident
            _resident.ensure(self.store, self.device)
        # the policy picks which neighbors this broadcast addresses at
        # all (hierarchical gossip: intra-zone peers + relay links);
        # fanout sampling applies within that set
        targets = self.policy.targets(self, list(self.neighbors))
        if self.fanout is not None and self.fanout < len(targets):
            targets = self.rng.sample(targets, k=self.fanout)
        self._group_cache = None     # per-broadcast joined delta-group
        self._digest_cache = None    # per-broadcast encoded digest
        for j in targets:
            # pull vs push is per destination: a relay pushes intervals
            # to its own zone and trades digests across zones in the
            # same round (flat pull policies ignore dst — unchanged)
            if self.policy.pull_exchange and self.policy.pull_round(self, j):
                self._ship_digest(j)
            else:
                self._ship_to(j)
        if self.policy.pure_pull:
            # state-driven exchange: digest responses are computed from X,
            # never from the buffer, and no pushes means no acks to GC it
            self.entries = {}
        elif not self.causal:
            # Algorithm 1: an entry leaves D only once broadcast to every
            # neighbor (per-destination watermarks — see _basic_sent)
            self._gc_shipped_basic()
        if self.reaper is not None:
            # key lifecycle rides the same cadence: propose/retransmit/
            # commit reaps after the round's payloads are out
            self.reaper.step()

    # -- paper: chooseᵢ(Xᵢ, Dᵢ) + ship ------------------------------------------
    def _ship_to(self, j: str) -> None:
        if self.causal:
            self._ship_causal(j)
        else:
            self._ship_basic(j)

    def _post(self, dst: str, msg: tuple, *, full_state: bool = False
              ) -> None:
        """Ship an engine message, frame-encoding it when a wire codec is
        attached (the frame's kind drives the simulator's byte stats).
        The codec may yield ``None`` — a message that turned out to carry
        nothing (an all-filtered digest response) — which ships nothing."""
        raw = msg
        if self.wire is not None:
            msg = self.wire.encode_msg(raw, full_state=full_state)
            if msg is None:
                return
        if self.tracer is not None:
            self._trace_post(dst, raw, msg, full_state)
        self.send(dst, msg)

    def _basic_payload(self, j: str, *,
                       use_cache: bool = False) -> tuple:
        """The ``(payload, is_full_state)`` a basic-mode broadcast would
        carry to ``j`` right now, or ``(None, False)`` when ``j``
        provably needs nothing. Side-effect-free apart from the optional
        per-broadcast group cache (``use_cache`` is only safe inside one
        ``on_periodic`` broadcast, where the cache was just reset) — the
        single source of truth behind both ``_ship_basic`` and the
        paper-facing ``BasicNode.choose(dst)`` preview."""
        sent = self._basic_sent.get(j, 0)
        items = [(n, e) for n, e in sorted(self.entries.items())
                 if n >= sent]        # only what j has not been sent yet
        if self.policy.want_full_state(self, j) or not items:
            # full-state rounds are the convergence safety net and ship
            # whole: finalize (e.g. the digest budget) applies only to
            # delta-group payloads, else the low-energy tail would never
            # propagate (the budget keeps re-picking the same top chunks)
            return self.X, True
        kept = [e.delta for n, e in items
                if self.policy.include(self, j, n, e)]
        if not kept:
            return None, False       # receiver provably needs nothing
        if use_cache and len(kept) == len(self.entries):
            # the whole buffer ships to this dst (no watermark skip, no
            # policy filter): the joined group is the same for every
            # such neighbor — join once per broadcast
            if self._group_cache is None:
                m = self.bottom
                for d in kept:
                    m = m.join(d)
                self._group_cache = m
            m = self._group_cache
        else:
            m = self.bottom
            for d in kept:
                m = m.join(d)
        return self.policy.finalize(self, j, m), False

    def _ship_basic(self, j: str) -> None:
        m, full = self._basic_payload(j, use_cache=True)
        self._basic_sent[j] = self.c
        if m is not None:
            self._post(j, ("delta", m), full_state=full)

    def _gc_shipped_basic(self) -> None:
        """Basic-mode buffer GC: drop entries every current *push*
        peer's broadcast watermark has passed (the per-destination
        replacement for Algorithm 1's clear-after-broadcast). Peers the
        policy only reaches by digest pull never advance a watermark,
        so they must not gate the horizon — and with no push peers at
        all the buffer serves nobody and clears (digest-sync computes
        responses from ``X``, never the buffer)."""
        if not self.entries:
            return
        peers = self.policy.ack_peers(self, list(self.neighbors))
        horizon = (min(self._basic_sent.get(j, 0) for j in peers)
                   if peers else self.c)
        if horizon:
            depth = len(self.entries)
            self.entries = {n: e for n, e in self.entries.items()
                            if n >= horizon}
            dropped = depth - len(self.entries)
            if dropped and self.tracer is not None:
                self.tracer.emit("gc_horizon_advance", horizon=horizon,
                                 dropped=dropped, depth=len(self.entries),
                                 round=self.rounds)

    def _ship_causal(self, j: str) -> None:
        aj = self.A.get(j, 0)
        if aj >= self.c:
            return                   # receiver fully acked — nothing new
        full = (self.policy.want_full_state(self, j)
                or not self.entries or min(self.entries.keys()) > aj)
        if full:
            d = self.X               # policy-forced full state, or receiver
        else:                        # behind the GC horizon / crash
            d = self.bottom
            for n in range(aj, self.c):
                e = self.entries.get(n)
                if e is None or not self.policy.include(self, j, n, e):
                    continue         # filtered ⇒ receiver already covers it
                d = d.join(e.delta)
            # an all-filtered interval still ships as ⊥ so the ack (and
            # with it the GC horizon) advances past the covered entries
        d = self.policy.finalize(self, j, d)
        if self.policy.requires_known_state:
            self._inflight[(j, self.c)] = d
            stale = sorted(n for (dst, n) in self._inflight if dst == j)
            # bound memory per destination; acks for evicted tags fall
            # back to the buffered-entries join
            for n in stale[:-self.INFLIGHT_CAP]:
                del self._inflight[(j, n)]
        ghost = self.X if self.ghost_check else None
        self._post(j, ("delta", d, self.c, ghost), full_state=full)

    # -- digest exchange: request/response pull anti-entropy ----------------------
    def _ship_digest(self, j: str) -> None:
        """Pull round: ship ``j`` a compact summary of what this replica
        holds; ``j`` replies with exactly the rows the summary lacks.
        The digest — and under a wire codec its encoded frame — is
        destination-independent, so one broadcast builds it once. It
        gets its own cache slot (not ``_group_cache``): under a
        per-destination pull policy one broadcast can ship pushes AND
        digests, and a basic-mode joined group must never collide with
        an encoded digest."""
        if self._digest_cache is None:
            msg = ("digest", store_digest(self.store))
            if self.wire is not None:
                msg = self.wire.encode_msg(msg)
            self._digest_cache = msg
        if self.tracer is not None:
            m = self._digest_cache
            self.tracer.emit(
                "digest_req", dst=j, round=self.rounds,
                bytes=(len(m) if isinstance(m, (bytes, bytearray))
                       else structural_size(m)))
        self.send(j, self._digest_cache)

    def _receive_digest_request(self, src: str, digest: StoreDigest) -> None:
        """Respond with the sub-state ``src`` provably lacks — nothing at
        all when the digest already covers this replica (a converged mesh
        trades only digest frames, no empty responses). Keyed-mode
        responses pass through ``policy.restrict_pull`` first so
        destination-restricting policies (ShardByKey) shape pull traffic
        exactly like push traffic; under the wire codec the digest filter
        itself runs at encode time (``encode_store(known_versions=...)``).
        """
        resp = self.store
        if self._keyed:
            resp = self.policy.restrict_pull(self, src, resp)
        if self.wire is not None:
            # the codec applies the digest filter at encode time and
            # yields no frame at all when nothing survives it
            self._post(src, ("digest-resp", resp, digest))
            return
        d = digest_diff(resp, digest)
        if d.entries or d.life:
            self._post(src, ("digest-resp", d))

    def _receive_digest_response(self, src: str, d: Any) -> None:
        """Join a pull response. It is join-equivalent to the responder's
        full state (the filter only removed rows this replica dominates),
        so — like a handoff — it bypasses the interval machinery safely;
        it is buffered like any received delta so push rounds can forward
        it (skipped under pure pull, where the buffer is never shipped)."""
        if not self._keyed and isinstance(d, LatticeStore):
            d = d.get(self.SINGLE_KEY)
            if d is None:
                return               # empty response: nothing was missing
        before = self.X if self.tracer is not None else None
        if not d.leq(self.X):
            self.X = self.X.join(d)
            if not self.policy.pure_pull and (self.causal
                                              or self.transitive):
                self._record(d, origin=src)
        if self.tracer is not None:
            self._trace_join(src, d, "digest-resp", self._rx_bytes, before)

    def _reap_agree(self, key: str, epoch: int, expiry: float) -> bool:
        """May the proposed ``(key, epoch, expiry)`` reap proceed, as far
        as this replica knows? Yes iff this replica is already past that
        incarnation (the commit would be absorbed anyway), or it sits at
        the same epoch with no extension beyond the proposed expiry and
        the deadline has passed on *this* clock too. A fresher local
        expiry or an unseen incarnation nacks — the proposer cancels and
        retries once gossip converges."""
        e, x = self.store.life_of(key)
        return e > epoch or (e == epoch and x <= expiry
                             and self.now() >= expiry)

    # -- rebalance handoff: direct full-state push for moved keys -----------------
    def push_handoff(self, dst: str, payload: Any) -> None:
        """Ship ``payload`` (a full-state delta for rebalanced keys)
        directly to ``dst``, outside the ack/interval machinery: joins
        are idempotent and organic anti-entropy remains the safety net,
        so handoff needs no ack and cannot violate the merging condition."""
        self._post(dst, ("handoff", payload))

    def _receive_handoff(self, src: str, d: Any) -> None:
        before = self.X if self.tracer is not None else None
        if not d.leq(self.X):
            self.X = self.X.join(d)
            if self.causal or self.transitive:
                self._record(d, origin=src)
        if self.tracer is not None:
            self._trace_join(src, d, "handoff", self._rx_bytes, before)

    # -- paper: on receiveⱼ,ᵢ ---------------------------------------------------
    @spanned("replica.receive")
    def on_receive(self, src: str, msg: Any) -> None:
        if self.tracer is not None:
            self._rx_bytes = (len(msg)
                              if isinstance(msg, (bytes, bytearray))
                              else structural_size(msg))
        if self.wire is not None and isinstance(msg, (bytes, bytearray)):
            msg = self.wire.decode_msg(msg)
        kind = msg[0]
        if kind == "handoff":
            self._receive_handoff(src, msg[1])
            return
        if kind == "reap":
            # vote on another owner's reap proposal from local lifecycle
            # state — every keyed replica can vote, reaper attached or not
            _, key, epoch, expiry = msg
            self._post(src, ("reap-ack", key, epoch, expiry,
                             int(self._reap_agree(key, epoch, expiry))))
            return
        if kind == "reap-ack":
            if self.tracer is not None:
                self.tracer.emit("reap_ack", src=src, key=msg[1],
                                 ok=bool(msg[4]), round=self.rounds)
            if self.reaper is not None:
                self.reaper.on_ack(src, msg)
            return
        if kind == "digest":
            self._receive_digest_request(src, msg[1])
            return
        if kind == "digest-resp":
            self._receive_digest_response(src, msg[1])
            return
        if not self.causal:
            _, d = msg
            before = self.X if self.tracer is not None else None
            self.X = self.X.join(d)
            if self.transitive:
                self._record(d, origin=src)
            if self.tracer is not None:
                self._trace_join(src, d, "delta", self._rx_bytes, before)
            return
        if kind == "delta":
            _, d, n, ghost = msg
            self._receive_delta(src, d, n, ghost)
        elif kind == "ack":
            self._receive_ack(src, msg[1])
        else:  # pragma: no cover
            raise ValueError(f"unknown message kind {kind!r}")

    def _receive_delta(self, src: str, d: Any, n: int,
                       ghost: Any = None) -> None:
        before = self.X if self.tracer is not None else None
        if not d.leq(self.X):
            if self.ghost_check and ghost is not None:
                got = self.X.join(d)
                want = self.X.join(ghost)
                if got != want:
                    self.ghost_failures.append(
                        f"{src}->{self.id} delta-interval join != "
                        f"full-state join")
            self.X = self.X.join(d)
            self._record(d, origin=src)
        if self.tracer is not None:
            self._trace_join(src, d, "delta", self._rx_bytes, before)
        self._post(src, ("ack", n))

    def _receive_ack(self, src: str, n: int) -> None:
        prev = self.A.get(src, 0)
        if self.tracer is not None:
            self.tracer.emit("ack", src=src, tag=n, stale=n <= prev,
                             round=self.rounds)
        if n <= prev:
            return                   # stale / reordered ack
        if self.policy.requires_known_state:
            k = self._known.get(src, self.bottom)
            acked = self._inflight.pop((src, n), None)
            if acked is not None:
                # exact: the very payload that was shipped for this tag
                # (covers the whole acked interval, already carries any
                # per-destination restriction as of ship time — immune
                # to policy/ownership drift between ship and ack)
                k = k.join(acked)
            else:
                # in-flight record evicted (INFLIGHT_CAP): fall back to
                # the buffered entries below the ack, narrowed by the
                # policy's credit hook (a destination-restricting policy
                # must not credit state its payloads never carried)
                for idx in range(prev, n):
                    e = self.entries.get(idx)
                    if e is not None:
                        k = k.join(self.policy.credit(self, src, e.delta))
            for key in [key for key in self._inflight
                        if key[0] == src and key[1] <= n]:
                del self._inflight[key]      # superseded, never ackable
            self._known[src] = k
        self.A[src] = n

    # -- paper: periodically (garbage collect deltas) ----------------------------
    def gc_deltas(self) -> None:
        self.prune_departed()
        if not self.entries:
            return
        # The horizon ranges over *push* peers only: a peer the policy
        # reaches by digest pull alone never acks, so waiting on it
        # would pin the buffer forever. With no push peers at all the
        # buffer is useless — clear it (X holds the state; digest-sync
        # is the repair path, Def. 6 keeps that join-equivalent).
        peers = self.policy.ack_peers(self, list(self.neighbors))
        horizon = (min(self.A.get(j, 0) for j in peers)
                   if peers else self.c)
        depth = len(self.entries)
        self.entries = {n: e for n, e in self.entries.items()
                        if n >= horizon}
        dropped = depth - len(self.entries)
        if dropped and self.tracer is not None:
            self.tracer.emit("gc_horizon_advance", horizon=horizon,
                             dropped=dropped, depth=len(self.entries),
                             round=self.rounds)

    def prune_departed(self) -> None:
        """Drop ALL per-peer bookkeeping for peers no longer in
        ``self.neighbors`` — long elastic-membership runs would otherwise
        grow these maps without bound as workers come and go. One
        registry (``_peer_pruners``) covers the engine's own maps (acks,
        known-state bounds, basic-mode broadcast watermarks, in-flight
        payloads) and anything a subsystem registered via
        :meth:`track_peer_state` (e.g. the reaper's per-proposal ack
        sets), so a new per-peer map cannot silently miss cleanup."""
        live = frozenset(self.neighbors)
        for pruner in self._peer_pruners:
            pruner(live)

    def _prune_engine_maps(self, live: FrozenSet[str]) -> None:
        for m in (self.A, self._known, self._basic_sent):
            for j in [j for j in m if j not in live]:
                del m[j]
        for key in [key for key in self._inflight if key[0] not in live]:
            del self._inflight[key]

    # -- crash model: (store[, c]) durable; buffer/acks volatile ------------------
    def durable_snapshot(self) -> Any:
        return (self.store, self.c) if self.causal else self.store

    def recover(self, durable: Any) -> None:
        if self.causal:
            state, self.c = durable
        else:
            state = durable
        if isinstance(state, LatticeStore):
            self.store = state
        else:   # pre-store snapshot: re-wrap the single object
            self.store = LatticeStore.of({self.SINGLE_KEY: state})
        self.entries = {}
        # volatile per-peer maps: clear IN PLACE — registered pruners
        # alias these dicts, and reassignment would silently detach them
        self.A.clear()
        self._known.clear()
        self._inflight.clear()
        self._basic_sent.clear()
        if self.reaper is not None:
            self.reaper.reset()


# ---------------------------------------------------------------------------
# Keyed store-backed replica
# ---------------------------------------------------------------------------

class StoreReplica(Replica):
    """A replica whose durable state is a keyed :class:`LatticeStore`.

    Each key holds an independent lattice object (session table, tensor
    shard, membership view, …); deltas are store deltas touching any
    subset of keys, and the engine's delta-intervals aggregate them into
    one store-level wire message per round. Every
    :class:`ShippingPolicy` composes unchanged — ``include``/``finalize``
    see store values, and per-key decisions fall out of
    ``LatticeStore.decompose`` (RemoveRedundant) and
    ``digest_select_store`` (DigestBudget ranks chunks across all keys).

    ``ownership`` (a ``KeyOwnership``-shaped object
    with ``replicates(worker, key)``) bounds the delta buffer: received
    deltas are restricted to the keys this replica owns or replicates
    before they are buffered for forwarding (locally-generated deltas
    always buffer — a replica must be able to accept a write for a key it
    does not own and forward it to the owners). Pair it with
    a ``ShardByKey``-shaped policy so outgoing payloads are
    restricted to each destination's shard; convergence is then per key
    across that key's replica set rather than global (do not combine with
    ``ghost_check``, which asserts global payload equivalence).

    ``ttl`` turns on the key lifecycle (``repro_torch.lifecycle``): every
    local write also *touches* the key — extends its LWW expiry to
    ``now() + ttl`` within the key's current epoch — so a key expires
    ``ttl`` after its last write anywhere in the fleet (expiries
    max-join). Writes to a key at a past-0 epoch always carry that
    epoch (they must land in the live incarnation), and a write to a
    *tombstoned* key starts a fresh incarnation one epoch above the
    tombstone — reviving is explicit new state, never a resurrection a
    straggler replay could cause.
    """

    def __init__(self, node_id: str, neighbors: Sequence[str],
                 *, causal: bool = True,
                 policy: Optional[ShippingPolicy] = None,
                 rng: Optional[random.Random] = None,
                 ghost_check: bool = False,
                 fanout: Optional[int] = None,
                 transitive: bool = True,
                 ownership: Optional[Any] = None,
                 wire: Optional[Any] = None,
                 ttl: Optional[float] = None,
                 resident: bool = False,
                 device="cuda",
                 tracer: Optional[Any] = None):
        super().__init__(node_id, LatticeStore.bottom(), neighbors,
                         causal=causal, policy=policy, rng=rng,
                         ghost_check=ghost_check, fanout=fanout,
                         transitive=transitive, wire=wire,
                         resident=resident, device=device, tracer=tracer)
        self.ownership = ownership
        if ttl is not None and ttl <= 0:
            raise ValueError(f"ttl must be positive, got {ttl!r}")
        self.ttl = ttl

    # -- keyed API --------------------------------------------------------------
    def _stamp(self, S: LatticeStore, key: str,
               delta: LatticeStore) -> LatticeStore:
        """Attach the lifecycle state a local write must carry: the
        key's current epoch (one above it when tombstoned — a revival is
        a new incarnation) and, under a TTL, the touched expiry."""
        from ..lifecycle.lattice import touch
        epoch, expiry = S.life_of(key)
        # tombstoned ⇒ revive one epoch above (inline: tombstoned() would
        # re-materialize both store dicts on this per-write hot path)
        if epoch and key not in S.as_dict():
            epoch, expiry = epoch + 1, float("-inf")
        if self.ttl is not None:
            return delta.with_life(key, touch((epoch, expiry), self.now(),
                                              self.ttl))
        if epoch:
            return delta.with_life(key, (epoch, float("-inf")))
        return delta

    def update(self, key: str, typ, mutator_name: str, *args) -> Any:
        """δ-mutate the object at ``key`` through the engine (records the
        single-key store delta for anti-entropy)."""
        return self.operation(lambda S: self._stamp(
            S, key, S.apply_delta(key, typ, mutator_name, *args)))

    def put(self, key: str, delta_value: Any) -> Any:
        """Record a ready-made delta value for ``key``."""
        return self.operation(lambda S: self._stamp(
            S, key, LatticeStore.key_delta(key, delta_value)))

    def get(self, key: str, typ=None):
        return self.X.get(key, typ)

    def keys(self):
        return self.X.keys()

    def replicates(self, key: str) -> bool:
        return (self.ownership is None
                or self.ownership.replicates(self.id, key))

    def buffers(self, key: str) -> bool:
        """May a received delta for ``key`` enter the forward buffer?
        The write set always; a zone-aware ownership additionally lets
        its zone relays buffer keys their zone-mates read (``buffers``),
        so cross-zone pull responses survive to be pushed on intra-zone."""
        if self.ownership is None:
            return True
        may = getattr(self.ownership, "buffers", None)
        if may is not None:
            return may(self.id, key)
        return self.ownership.replicates(self.id, key)

    # -- ownership-bounded buffering ---------------------------------------------
    def _record(self, d: Any, origin: Optional[str]) -> None:
        if (origin is not None and self.ownership is not None
                and isinstance(d, LatticeStore)):
            # buffer only the shard this replica replicates or relays
            # (all_keys: tombstone-only keys forward too); the entry is
            # recorded even when empty so the causal index stays dense
            d = d.restrict(k for k in d.all_keys() if self.buffers(k))
        super()._record(d, origin)
