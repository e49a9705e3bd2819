"""Cross-pod delta-synchronized training (local SGD / DiLoCo shape).

Each pod trains K local steps per *round*, then contributes the round's
pseudo-gradient (scaled parameter displacement) as a **uniquely-dotted
delta** to the additive ``DotSumStore`` lattice. Rounds gossip between pods
with the paper's Algorithm 2 (delta-intervals + acks) over an unreliable
network; every pod's *outer parameters* are the deterministic function

    outer = init + Σ_{dots (pod, round)} update / P

of the converged lattice, so (Prop. 1) all pods agree once all dots are
delivered — regardless of loss, duplication, or reordering, and without any
exactly-once machinery. Optionally payloads are top-k+error-feedback
compressed (``TopKCompressor``); the dot then carries the sparse update.

``DeltaSyncPod`` runs on the unified propagation runtime
(``repro_torch.core.propagation.Replica`` in causal mode): the CRDT state
IS the dot store, and the ``policy=`` knob selects what each gossip round
ships — ``ShipAll`` (default), ``AvoidBackPropagation`` /
``RemoveRedundant`` (or their ``Compose``) to cut redundant bytes on dense
topologies. ``CompressedAggregator`` is the §7.2-compressed execution
(``IntervalSum`` — O(1) memory instead of the full dot cloud). Updates are
pytrees of torch tensors on the pods' device.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .. import tree as tu
from ..core.propagation import Replica, ShippingPolicy
from ..core.tensor_lattice import DotSumStore, IntervalSum
from ..obs.trace import spanned
from .compression import TopKCompressor


@dataclass
class OuterParams:
    """init + scale · Σ dots — materializer for the outer parameters."""

    init: Any
    scale: float

    def materialize(self, store: DotSumStore,
                    decompress: Optional[Callable[[Any], Any]] = None) -> Any:
        total = store.total()
        if total is None:
            return self.init
        if decompress is not None:
            total = decompress(total)
        return tu.tree_map(
            lambda p, t: p + self.scale * t.to(p.dtype), self.init, total)

    def materialize_sum(self, running_sum: Any) -> Any:
        if running_sum is None:
            return self.init
        return tu.tree_map(
            lambda p, t: p + self.scale * t.to(p.dtype),
            self.init, running_sum)


class DeltaSyncPod(Replica):
    """A pod replica: local training + δ-CRDT gossip of round updates.

    ``local_update_fn(params, round_idx, pod_id) -> new_params`` is the
    K-local-steps inner loop (supplied by ``launch.train`` / tests).
    ``policy`` is any :class:`~repro_torch.core.propagation.ShippingPolicy`
    (default ship-all, Algorithm 2 semantics preserved).
    """

    def __init__(self, pod_id: str, neighbors, init_params: Any,
                 local_update_fn: Callable[[Any, int, str], Any],
                 num_pods: int,
                 compressor: Optional[TopKCompressor] = None,
                 rng: Optional[random.Random] = None,
                 ghost_check: bool = False,
                 policy: Optional[ShippingPolicy] = None):
        super().__init__(pod_id, DotSumStore.bottom(), neighbors,
                         causal=True, policy=policy, rng=rng,
                         ghost_check=ghost_check, fanout=1)
        self.outer = OuterParams(init=init_params, scale=1.0 / num_pods)
        self.local_update_fn = local_update_fn
        self.compressor = compressor
        self.round_idx = 0

    # -- current view -----------------------------------------------------------
    @spanned("pod.params")
    def params(self) -> Any:
        if self.compressor is not None:
            # dots carry sparse updates: decompress each then sum
            total = None
            for _, upd in self.X.dots:
                dense = TopKCompressor.decompress(upd)
                total = dense if total is None else tu.tree_map(
                    lambda a, b: a + b, total, dense)
            return self.outer.materialize_sum(total)
        return self.outer.materialize(self.X)

    # -- one training round ------------------------------------------------------
    @spanned("pod.round")
    def do_round(self) -> None:
        base = self.params()
        new_params = self.local_update_fn(base, self.round_idx, self.id)
        delta = tu.tree_map(lambda n, b: n - b, new_params, base)
        payload = (self.compressor.compress(delta)
                   if self.compressor is not None else delta)
        self.operation(lambda X: X.contribute_delta(self.id, payload))
        self.round_idx += 1


class CompressedAggregator:
    """Large-model execution of the same semantics: keep only the
    (version-vector, running-sum) per §7.2 instead of the dot cloud.

    Exactness relies on the causal delta-merging condition, enforced by
    ``IntervalSum.apply_interval`` (gap ⇒ reject, duplicate ⇒ no-op); it is
    exercised against the reference ``DotSumStore`` in tests.
    """

    def __init__(self, init_params: Any, num_pods: int):
        self.outer = OuterParams(init=init_params, scale=1.0 / num_pods)
        self.agg = IntervalSum()

    def apply(self, producer: str, start_seq: int, updates) -> bool:
        return self.agg.apply_interval(producer, start_seq, updates)

    def params(self) -> Any:
        return self.outer.materialize_sum(self.agg.sum)
