"""δ-CRDT core over torch tensors — the port of the JAX package's core.

* ``dots``           — dots, compressed causal contexts (§7.2), dot stores,
                       the generic causal join of Figs. 3b/4.
* ``dotcols``        — the same dot stores and contexts as packed int64
                       columns; the containment mask of every columnar
                       causal join runs on the card for large columns.
* ``crdts``          — the datatype catalogue (counters, sets, OR-Sets,
                       registers, flags, ORMap).
* ``tensor_lattice`` — the versioned chunk store ``TensorState``.
* ``store``          — the keyed store ``LatticeStore`` and its batched,
                       stacked, patched and resident join fast paths.
* ``digest``         — digest summaries for pull-shaped anti-entropy.
* ``propagation``    — the replica engine and its shipping policies.
* ``antientropy``    — Algorithms 1 and 2 over the engine.
* ``sim``            — the §2 network model as a discrete-event simulator.

Hierarchical gossip arrives with a later slice.
"""

from .dots import CausalContext, Dot, DotFun, DotMap, DotSet, causal_join
from .crdts import (ALL_CRDT_TYPES, AWORSet, AWORSetTombstone, DWFlag,
                    DeltaCRDT, EWFlag, GCounter, GSet, LWWRegister, LWWSet,
                    MVRegister, ORMap, PNCounter, RWORSet, TwoPSet)
from .tensor_lattice import ChunkedTensor, SparseChunks, TensorState
from .store import LatticeStore, digest_select_store
from .digest import StoreDigest, digest_diff, opaque_hash, store_digest
from .propagation import (AvoidBackPropagation, Compose, DeltaEntry,
                          DigestBudget, DigestExchange, POLICY_SPECS,
                          RemoveRedundant, Replica, ShipAll,
                          ShipStateEveryK, ShippingPolicy, StoreReplica,
                          causal_policy_spec, make_policy, stable_seed)
from .antientropy import (BasicNode, CausalNode, FullStateNode, converged,
                          run_to_convergence)
from .sim import NetConfig, NetStats, Node, Simulator, structural_size

__all__ = [
    "CausalContext", "Dot", "DotFun", "DotMap", "DotSet", "causal_join",
    "ALL_CRDT_TYPES", "AWORSet", "AWORSetTombstone", "DWFlag", "DeltaCRDT",
    "EWFlag", "GCounter", "GSet", "LWWRegister", "LWWSet", "MVRegister",
    "ORMap", "PNCounter", "RWORSet", "TwoPSet",
    "ChunkedTensor", "SparseChunks", "TensorState",
    "LatticeStore", "digest_select_store",
    "StoreDigest", "digest_diff", "opaque_hash", "store_digest",
    "AvoidBackPropagation", "Compose", "DeltaEntry", "DigestBudget",
    "DigestExchange", "POLICY_SPECS", "RemoveRedundant", "Replica",
    "ShipAll", "ShipStateEveryK", "ShippingPolicy", "StoreReplica",
    "causal_policy_spec", "make_policy", "stable_seed",
    "BasicNode", "CausalNode", "FullStateNode", "converged",
    "run_to_convergence",
    "NetConfig", "NetStats", "Node", "Simulator", "structural_size",
]
