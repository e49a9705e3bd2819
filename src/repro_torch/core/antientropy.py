"""Anti-entropy algorithms for δ-CRDTs (paper Algorithms 1 and 2).

Both algorithms are thin configurations of the unified propagation runtime
(:mod:`repro_torch.core.propagation`): one :class:`~repro_torch.core.propagation.Replica`
engine owns the send/receive/ack/GC machinery and a pluggable
:class:`~repro_torch.core.propagation.ShippingPolicy` decides *what* ships each
round (the paper's open ``chooseᵢ(Xᵢ, Dᵢ)``).

``BasicNode`` is Algorithm 1 — convergence only (Prop. 1): deltas accumulate
in a volatile delta-group ``D`` and are periodically broadcast to
neighbours; received payloads join into ``X`` (and into ``D`` too when in
*transitive* mode). The default policy is ``ShipStateEveryK`` when
``ship_state_every`` is set (so convergence holds under message loss, since
Algorithm 1 clears ``D`` after a send even if the message is dropped) and
``ShipAll`` otherwise.

``CausalNode`` is Algorithm 2 — causal consistency: every delta joined into
``X`` is recorded in the sequence ``D`` under an increasing counter ``c``
(durable, like ``X``); a sender only ships *delta-intervals* Δᵢᵃ'ᵇ starting
at the receiver's acknowledged index, which establishes the causal
delta-merging condition (Def. 6) — see Props. 2 & 3. Old deltas are
garbage-collected once acknowledged by all neighbours; a receiver that is
too far behind (or a sender that lost volatile state in a crash) gets the
full state instead. Pass ``policy=`` (e.g. ``AvoidBackPropagation``,
``RemoveRedundant``, or a ``Compose`` of both) to change what enters each
delta-interval; every policy preserves the merging condition (see the
propagation module docstring).

Both classes are datatype-generic: they operate on any value implementing
``join``/``leq`` (every datatype in ``repro_torch.core.crdts`` and the tensor
lattices in ``repro_torch.core.tensor_lattice``).

For verifying Prop. 2 operationally, messages optionally carry a *ghost*
copy of the sender's full state at send time: the proof's simulation
argument says joining Δⱼᵃ'ᵇ must produce exactly the state that joining the
full Xⱼᵇ would. ``ghost_check=True`` asserts that equality at every
delivery — under every shipping policy.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Optional, Sequence

from .propagation import (Replica, ShipAll, ShippingPolicy,
                          ShipStateEveryK)
from .sim import Node, Simulator


class BasicNode(Replica):
    """Algorithm 1: basic anti-entropy (convergence, no causal guarantees)."""

    def __init__(self, node_id: str, bottom: Any, neighbors: Sequence[str],
                 transitive: bool = True,
                 ship_state_every: Optional[int] = None,
                 policy: Optional[ShippingPolicy] = None,
                 wire: Optional[Any] = None):
        if policy is None:
            policy = (ShipStateEveryK(ship_state_every)
                      if ship_state_every else ShipAll())
        super().__init__(node_id, bottom, neighbors, causal=False,
                         policy=policy, transitive=transitive, fanout=None,
                         wire=wire)
        self.ship_state_every = ship_state_every

    # -- paper: chooseᵢ(Xᵢ, Dᵢ), kept for the paper correspondence -------------
    def choose(self, dst: Optional[str] = None) -> Any:
        """What the next broadcast would carry: to ``dst`` when given
        (the full per-destination pipeline — watermark, ``include``
        filter, ``finalize``), else to a *generic* neighbour (coarse
        ``X``-or-``D`` preview, per-destination hooks skipped).

        The generic case passes ``dst=None`` — a sentinel no policy hook
        treats as a real receiver. It used to pass ``""``, which is a
        perfectly legal replica id: ``RemoveRedundant`` would consult
        ``known_state("")`` (any bound actually tracked for a replica
        named ``""`` would silently filter the preview) and
        ``AvoidBackPropagation``'s ``include`` compares it against entry
        origins. ``None`` is unambiguous, and dst-dependent hooks must
        treat it as "no specific receiver" (``dict.get(None)`` misses and
        ``origin != None`` holds for every remote entry, so the built-in
        policies do so for free).

        Peeks at the round counter the engine will use: ``on_periodic``
        increments ``rounds`` before shipping.
        """
        rounds = self.rounds
        try:
            self.rounds += 1
            if self.policy.pull_exchange and self.policy.pull_round(self,
                                                                    dst):
                from .digest import store_digest
                return ("digest", store_digest(self.store))
            if dst is None:
                # coarse preview: per-destination hooks (watermarks,
                # include) are skipped — BP's include would misread the
                # sentinel as "local entries echo back to their origin"
                if self.policy.want_full_state(self, None) \
                        or not self.entries:
                    return self.X
                return self.D
            # the real pipeline _ship_basic runs, minus the side effects
            m, _full = self._basic_payload(dst)
            return m if m is not None else self.bottom
        finally:
            self.rounds = rounds


class CausalNode(Replica):
    """Algorithm 2: delta-interval anti-entropy with the causal
    delta-merging condition."""

    def __init__(self, node_id: str, bottom: Any, neighbors: Sequence[str],
                 rng: Optional[random.Random] = None,
                 ghost_check: bool = False,
                 fanout: int = 1,
                 policy: Optional[ShippingPolicy] = None,
                 wire: Optional[Any] = None):
        super().__init__(node_id, bottom, neighbors, causal=True,
                         policy=policy, rng=rng, ghost_check=ghost_check,
                         fanout=fanout, wire=wire)


# ---------------------------------------------------------------------------
# Reference: classical full-state shipping (the baseline the paper improves)
# ---------------------------------------------------------------------------

class FullStateNode(Node):
    """Classical state-based CRDT anti-entropy: ship the entire state."""

    def __init__(self, node_id: str, bottom: Any, neighbors: Sequence[str],
                 wire: Optional[Any] = None):
        super().__init__(node_id)
        self.bottom = bottom
        self.X = bottom
        self.neighbors = list(neighbors)
        self.wire = wire

    def operation(self, m_full: Callable[[Any], Any]) -> None:
        self.X = m_full(self.X)

    def on_periodic(self) -> None:
        if not self.alive:
            return
        for j in self.neighbors:
            # WireCodec routes on the engine's "delta" tuple shape and
            # tags the frame as state traffic via full_state
            msg = (self.wire.encode_msg(("delta", self.X), full_state=True)
                   if self.wire is not None else ("state", self.X))
            self.send(j, msg)

    def on_receive(self, src: str, msg: Any) -> None:
        if self.wire is not None and isinstance(msg, (bytes, bytearray)):
            msg = self.wire.decode_msg(msg)
        _, s = msg
        self.X = self.X.join(s)

    def durable_snapshot(self) -> Any:
        return self.X

    def recover(self, durable: Any) -> None:
        self.X = durable


def converged(nodes: Sequence[Node]) -> bool:
    states = [n.X for n in nodes]
    return all(s == states[0] for s in states[1:])


def run_to_convergence(sim: Simulator, nodes: Sequence[Node],
                       interval: float = 1.0, max_time: float = 10_000.0,
                       gc: bool = True) -> float:
    """Drive periodic anti-entropy until all nodes' states agree.

    Returns the simulated time at convergence; raises if the bound is hit.
    """
    scheduled = getattr(sim, "_ae_scheduled", set())
    for n in nodes:
        if n.id in scheduled:
            continue  # idempotent: don't double-schedule on repeated calls
        scheduled.add(n.id)
        sim.every(interval, n.on_periodic)
        if gc and isinstance(n, Replica) and n.causal:
            sim.every(interval * 7, n.gc_deltas)
    sim._ae_scheduled = scheduled
    step = interval * 2
    while sim.time < max_time:
        sim.run_for(step)
        if converged(nodes):
            return sim.time
    raise AssertionError(
        f"no convergence by t={max_time}; states differ: "
        + "; ".join(repr(n.X)[:120] for n in nodes))
