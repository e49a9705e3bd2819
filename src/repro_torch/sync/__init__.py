"""Cross-pod δ-CRDT synchronization runtime (the JAX package's ``sync``).

* ``localsgd``   — DiLoCo-style cross-pod training: pods run K local
                   steps, contribute uniquely-dotted pseudo-gradient
                   deltas to a ``DotSumStore`` lattice, gossiped with
                   Algorithm 2; the §7.2-compressed ``IntervalSum``
                   variant keeps O(1) memory.
* ``compression`` — top-k magnitude sparsification with error feedback
                   (the delta payloads for dense models).
* ``membership`` — elastic worker membership: AWORSet of workers +
                   monotone heartbeats; straggler detection/eviction;
                   ``ClusterReplica`` gossips the view through the
                   propagation runtime; ``KeyOwnership``/``ShardByKey``
                   rendezvous-hash the keyed-store keyspace over the live
                   worker set so each replica buffers/ships only its shard.
* ``metrics``    — duplicate-safe distributed metrics (per-replica
                   monotone entries; PN counters).
"""

from .compression import (TopKCompressor, sparse_nbytes, topk_frame,
                          topk_unframe)
from .localsgd import DeltaSyncPod, OuterParams
from .membership import (ClusterReplica, ClusterState, KeyOwnership,
                         Membership, RebalanceHandoff, ShardByKey,
                         owners_for_key, rendezvous_score)
from .metrics import Metrics, MetricsState

__all__ = [
    "TopKCompressor", "sparse_nbytes", "topk_frame", "topk_unframe",
    "DeltaSyncPod", "OuterParams",
    "ClusterReplica", "ClusterState", "KeyOwnership", "Membership",
    "RebalanceHandoff", "ShardByKey", "owners_for_key",
    "rendezvous_score", "Metrics", "MetricsState",
]
