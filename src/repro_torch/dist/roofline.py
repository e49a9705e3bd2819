"""Roofline arithmetic for the dry-run cells.

Three per-chip time terms from the traced step's counts:

    compute_s     flops / PEAK_FLOPS
    memory_s      bytes accessed / HBM_BW
    collective_s  ring wire bytes (dist.hlo) / ICI_BW

The step is bound by the largest term; ``useful_frac`` is the model-flops
share of executed flops (rematerialization, padding, and fallback gathers
dilute it); ``roofline_frac`` is useful compute time over the bound time —
the headline "fraction of the roofline we reach".

Hardware constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense
rates at the 700 W limit): bf16 tensor-core peak, HBM3 rate, and NVLink
4's rate per direction; override per call to model other silicon.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional

PEAK_FLOPS = 989e12   # bf16 dense FLOP/s per card
HBM_BW = 3.35e12      # HBM bytes/s per card
ICI_BW = 450e9        # NVLink bytes/s per card, one direction


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    useful_frac: float
    roofline_frac: float
    step_s: float
    tokens_per_s: float
    peak_memory_gb: Optional[float] = None
    collective_breakdown_s: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def roofline(arch: str, shape: str, mesh: str, chips: int,
             cost: Dict[str, float], wire_bytes: float,
             per_kind: Dict[str, float], model_flops_total: float,
             tokens: int,
             peak_memory: Optional[float] = None,
             peak_flops: float = PEAK_FLOPS,
             hbm_bw: float = HBM_BW,
             ici_bw: float = ICI_BW) -> RooflineReport:
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / hbm_bw
    collective_s = float(wire_bytes) / ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=lambda k: terms[k])
    step_s = terms[bound]
    useful_frac = (model_flops_total / (flops * chips)
                   if flops > 0 and chips > 0 else 0.0)
    roofline_frac = (compute_s * useful_frac / step_s) if step_s > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, useful_frac=useful_frac, roofline_frac=roofline_frac,
        step_s=step_s,
        tokens_per_s=(tokens / step_s) if step_s > 0 else 0.0,
        peak_memory_gb=(peak_memory / 1e9
                        if peak_memory is not None else None),
        collective_breakdown_s={k: v / ici_bw
                                for k, v in (per_kind or {}).items()},
    )
