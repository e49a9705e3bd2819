"""Sets of runs of one cell, each run a process of its own as the check
makes them, and the spread of each metric.

    python3 -m perfbench.sets --workload <cell> --seeds 1,2,3,4,5,6 \\
        --sets 2 --seconds 40 [--trace 0] [--out runs.jsonl]

prints each run's result line, then per set and metric the median and
the spread (quartile distance over the median), and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from perfbench.yardstick import spread

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": p.returncode, "wall_s": wall, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {card()}", flush=True)
    sets = []
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        for k in range(args.sets):
            runs = []
            for seed in seeds:
                rec = one(args.workload, seed, args.seconds, args.trace)
                rec["set"] = k
                runs.append(rec)
                line = json.dumps(rec)
                print(line if rec["result"] else line[-3500:], flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r["result"] for r in runs if r["result"]]
        names = sorted({m for r in ok for m in r["metrics"]})
        print(f"set {k}: {len(ok)}/{len(runs)} results, correct "
              f"{sum(r['correct'] for r in ok)}")
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            if len(vals) >= 2:
                print(f"  {m}: median {statistics.median(vals)!r} spread "
                      f"{spread(vals) if len(vals) >= 2 else None!r} "
                      f"values {vals!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
