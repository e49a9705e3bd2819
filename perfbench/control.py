"""Readings that set the limits of the correctness check, on the card.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--controls N] [--faults N] [--out readings.jsonl]

runs the cell's driver once per seed in this one process (a short
window, set-up as in a run) and prints, per seed, the numbers the check
compares: the program's (the lower readings), and for the first
``--controls`` seeds also the control's, the reference computed with
float8 products put in the program's place, and for training cells the
fault of a step that leaves half of the batch out. A step that leaves
its state unchanged reads 1 on the gaps of the gradient and of the
change by their definition and needs no run. In a serving cell the last
``--faults`` seeds run with one slot's token altered at every decode
step (:func:`token_altered`), and their line's ``program`` is the
fault's reading.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _patch_train(readings: dict, controls: bool):
    from perfbench import judge, reference
    real = reference.train_steps

    def train_steps(conf, seed, batches, opt, quant="f32", rows=None):
        ref = real(conf, seed, batches, opt, quant, rows)
        if controls:
            fp8 = real(conf, seed, batches, opt, quant="fp8")
            readings["control_fp8"] = dict(readings.get("control_fp8", {}),
                                           **judge.train_numbers(fp8, ref))
            half = real(conf, seed, batches, opt,
                        rows=batches[0]["tokens"].shape[0] // 2)
            readings["fault_half_batch"] = judge.train_numbers(half, ref)
        return ref

    reference.train_steps = train_steps
    return lambda: setattr(reference, "train_steps", real)


def _patch_serve(readings: dict, controls: bool):
    import torch
    from perfbench import judge, reference
    real = reference.serve_logits

    def serve_logits(conf, seed, tokens, s, quant="f32"):
        ref = real(conf, seed, tokens, s, quant)
        if controls:
            fp8 = real(conf, seed, tokens, s, quant="fp8")
            gaps = judge.served_gaps(ref, fp8.argmax(-1))
            readings.setdefault("control_gaps", []).append(gaps)
            del fp8
        return ref

    def done():
        reference.serve_logits = real
        gaps = readings.pop("control_gaps", None)
        if gaps:
            readings["control_fp8"] = judge.serve_numbers(torch.cat(gaps))

    reference.serve_logits = serve_logits
    return done


def token_altered():
    """Plant a fault under the timed path: every decode step serves slot
    0 its least likely token. Returns the undo."""
    import repro_torch.models as models
    real = models.decode_step

    def step(cfg, params, tokens, pos, caches):
        logits, caches = real(cfg, params, tokens, pos, caches)
        logits = logits.clone()
        worst = logits[0, -1].argmin()
        logits[0, -1, worst] = logits[0, -1].max() + 1.0
        return logits, caches

    models.decode_step = step
    return lambda: setattr(models, "decode_step", real)


def _patch_outer(readings: dict, controls: bool):
    """The outer parameters rounded to float8 (one scale a row) in the
    program's place: the control of ``outer_gap``."""
    from perfbench import reference
    from perfbench.drivers import localsgd
    real = localsgd.outer_gap

    def outer_gap(run, pods):
        got = real(run, pods)
        if controls:
            for pod in pods:
                pod.params_real = pod.params

                def rounded(pod=pod):
                    from repro_torch import tree as tu
                    return tu.tree_map(
                        lambda t: reference.fake_fp8(t.float(), -1)
                        .to(t.dtype), pod.params_real())
                pod.params = rounded
            readings["control_fp8"] = dict(
                readings.get("control_fp8", {}),
                outer_gap=real(run, pods))
        return got

    localsgd.outer_gap = outer_gap
    return lambda: setattr(localsgd, "outer_gap", real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench.run import ALLOCATOR
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOCATOR)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from perfbench import harness, spec
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    driver = cell.mix["driver"]
    with contextlib.ExitStack() as stack:
        out = (stack.enter_context(open(args.out, "a")) if args.out
               else None)
        seeds = [int(s) for s in args.seeds.split(",")]
        for n, seed in enumerate(seeds):
            readings: dict = {}
            controls = n < args.controls
            undo = [(_patch_serve if driver == "serve" else _patch_train)(
                readings, controls)]
            if driver == "localsgd":
                undo.append(_patch_outer(readings, controls))
            if driver == "serve" and n >= len(seeds) - args.faults:
                undo.append(token_altered())
                readings["fault"] = "token_altered"
            torch.cuda.reset_peak_memory_stats()
            run = harness.Run(cell=cell, seed=seed, seconds=args.seconds,
                              trace=False, device="cuda",
                              t0=time.perf_counter())
            try:
                harness.execute(run)
            finally:
                for u in undo:
                    u()
            line = {"workload": args.workload, "seed": seed,
                    "program": run.numbers, **readings,
                    "setup_s": run.setup_s,
                    "memory_peak_bytes": run.memory_peak_bytes,
                    "end_to_end": run.end_to_end,
                    "device": torch.cuda.get_device_name(0)}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            del run
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
