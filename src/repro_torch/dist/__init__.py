"""Distribution layer: sharding assignment, collective accounting,
roofline arithmetic.

Tier-0 of the two-tier distribution story (DESIGN.md §2): *inside* a pod,
synchronous SPMD over a ``torch.distributed`` ``DeviceMesh`` — this
package maps logical parameter axes to mesh axes and places ``DTensor``s
(``shardings``), charges the collectives a step issues with ring costs
(``hlo``: from HLO text, as the JAX package reads it, or from the
collectives the port's dry-run records), and turns a traced step's counts
into per-chip roofline terms (``roofline``). Tier-1 — *across* pods — is
the δ-CRDT propagation runtime in ``repro_torch.core`` /
``repro_torch.sync``.
"""

from .hlo import (collective_bytes, collective_count, cross_pod_bytes,
                  recorded_collective_bytes)
from .roofline import (HBM_BW, ICI_BW, PEAK_FLOPS, RooflineReport,
                       roofline)
from .shardings import (MeshRules, P, batch_pspecs, distribute, make_rules,
                        param_pspecs, placements, spec_for)

__all__ = [
    "collective_bytes", "collective_count", "cross_pod_bytes",
    "recorded_collective_bytes",
    "HBM_BW", "ICI_BW", "PEAK_FLOPS", "RooflineReport", "roofline",
    "MeshRules", "P", "batch_pspecs", "distribute", "make_rules",
    "param_pspecs", "placements", "spec_for",
]
