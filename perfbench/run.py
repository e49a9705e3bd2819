"""Run one cell of the benchmark once, on the card.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (the port is taken from ``src/``). The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` the
``breakdown``, and last the ``checks``: each compared number beside its
limit); the last lines of standard error repeat the checks. Without a
card, or with fewer than the cell asks for, or where JAX or the JAX
package was loaded, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOST_THREADS = 2
# the caching allocator grows segments instead of splitting fixed ones:
# a train step's 6.6 GB f32 logits then fit beside the optimizer state
ALLOCATOR = "expandable_segments:True"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOCATOR)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from perfbench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    torch.cuda.reset_peak_memory_stats()
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t0=T0)
    harness.execute(run)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    result = harness.finish(run)
    print(json.dumps(result), flush=True)
    for name, value in run.numbers.items():
        if name not in result["checks"]:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
