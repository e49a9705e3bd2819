"""Cross-pod δ-CRDT synchronization runtime: the membership and metrics
parts of the JAX package's ``sync``.

* ``membership`` — elastic worker membership: AWORSet of workers +
                   monotone heartbeats; straggler detection/eviction;
                   ``ClusterReplica`` gossips the view through the
                   propagation runtime; ``KeyOwnership``/``ShardByKey``
                   rendezvous-hash the keyed-store keyspace over the live
                   worker set so each replica buffers/ships only its shard.
* ``metrics``    — duplicate-safe distributed metrics (per-replica
                   monotone entries; PN counters).

Cross-pod training (``localsgd.DeltaSyncPod``) and top-k compression
(``compression.TopKCompressor``) arrive with slice D.
"""

from .membership import (ClusterReplica, ClusterState, KeyOwnership,
                         Membership, RebalanceHandoff, ShardByKey,
                         owners_for_key, rendezvous_score)
from .metrics import Metrics, MetricsState

__all__ = [
    "ClusterReplica", "ClusterState", "KeyOwnership", "Membership",
    "RebalanceHandoff", "ShardByKey", "owners_for_key",
    "rendezvous_score", "Metrics", "MetricsState",
]
