#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card. Run from the root of a checkout:

    python3 chip_smoke.py

1. Build: prints the card's name and power limit, then compiles every
   CUDA source of the port with ``nvcc`` (all started together).
2. Kernel parity: each of the four δ-CRDT kernels against its plain
   PyTorch version at the main path's shapes ([453113, 1024], scatter
   r=4096) and at ragged small shapes, in f32, bf16 and f16 — values,
   versions and max|x| bit-exact, Σx² to rtol 1e-4 — with CUDA-event
   times (median of 20) at the main shape in each dtype beside the
   bytes-over-bandwidth bound.
3. Main path: three device-resident ``StoreReplica``s (basic mode,
   ``WireCodec(to_device=True)``, full mesh over a lossy, duplicating
   ``Simulator``) replicate a store holding the parameter set of
   qwen1.5-0.5b (one key per parameter tensor, 290 keys, f32 chunks of
   1024: 453,113 rows, 1.86 GB per replica). Replica a puts the store,
   the mesh converges, 8 rounds of writes follow (each replica writes
   2,048 rows over 4 tensors per round, as delta-groups of two
   δ-mutations), and the mesh converges again. The replicas must equal
   each other and an independent numpy last-writer-wins replay of every
   write, and every kernel must have launched on this path.
4. Steady-state ingest: launches and staged bytes of one wire ingest are
   the same at the full and at half the store size.
5. Top-k: the resident digest ranking equals the host greedy selection.

The last line is ``{"ok": true, "device": {...}}``; any failed phase
raises and the script exits non-zero without it, as it does when no card
is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 1410
CHUNK = 1024
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
SUMSQ_RTOL = 1e-4                # Σx² is summed in another order
SCATTER_ROWS = 4096
IDS = ("a", "b", "c")
WRITE_ROUNDS = 8
TENSORS_PER_WRITE = 4
ROWS_PER_TENSOR = 512            # 4 × 512 = 2,048 rows = 8 MB f32 a write
TPU_KERNEL = {                   # the Pallas kernel each CUDA kernel replaces
    "delta_join": "src/repro/kernels/delta_join.py:75",
    "fused_join_digest": "src/repro/kernels/delta_join.py:194",
    "scatter_join": "src/repro/kernels/delta_join.py:278",
    "chunk_digest": "src/repro/kernels/delta_join.py:311",
}
SOURCE = "src/repro_torch/kernels/csrc/delta_join.cu"


def log(*parts) -> None:
    print(*parts, flush=True)


def qwen_tensors(n_layers=24, d_model=1024, d_ff=2816, vocab=151936):
    """``(name, numel)`` of every parameter tensor of qwen1.5-0.5b as
    ``src/repro/configs/qwen1_5_0_5b.py`` defines it: 24 layers,
    d_model 1024, 16 heads (MHA), d_ff 2816, vocab 151936, QKV bias,
    RMS norms, tied embeddings — 290 tensors. Sorted by name, the key
    order of a ``LatticeStore``."""
    d = d_model
    out = [("embed_tokens.weight", vocab * d), ("norm.weight", d)]
    for i in range(n_layers):
        p = f"layers.{i:02d}."
        for proj in "qkv":
            out += [(p + f"self_attn.{proj}_proj.weight", d * d),
                    (p + f"self_attn.{proj}_proj.bias", d)]
        out += [(p + "self_attn.o_proj.weight", d * d),
                (p + "mlp.gate_proj.weight", d * d_ff),
                (p + "mlp.up_proj.weight", d * d_ff),
                (p + "mlp.down_proj.weight", d_ff * d),
                (p + "input_layernorm.weight", d),
                (p + "post_attention_layernorm.weight", d)]
    return sorted(out)


# ---------------------------------------------------------------------------
# 1. Build
# ---------------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    procs = {name: _build.compile_source(name) for name in _build.SIGNATURES}
    for name, proc in procs.items():
        report = _build.finish(proc)
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln]
        log(f"built {name}: {len(regs)} kernels; " + "; ".join(
            sorted(set(r.split("Used ")[-1] for r in regs))))
        _build.library(name)
    log(f"build_s={time.perf_counter() - t0:.3f}")


# ---------------------------------------------------------------------------
# 2. Kernel parity and timing
# ---------------------------------------------------------------------------

def _bits(t):
    import torch
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _same_bits(x, y, what) -> None:
    if x.shape != y.shape or not bool((_bits(x) == _bits(y)).all()):
        raise AssertionError(f"{what}: kernel differs from plain version")


def _close(x, y, what) -> float:
    import torch
    if not torch.allclose(x, y, rtol=SUMSQ_RTOL, atol=0):
        raise AssertionError(f"{what}: Σx² beyond rtol {SUMSQ_RTOL}")
    return float((x - y).abs().max()) if x.numel() else 0.0


def time_ms(fn, reps=20) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events
    around each call, after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _operands(n, chunk, dtype, gen, dev):
    import torch
    av = torch.randn((n, chunk), generator=gen, device=dev).to(dtype)
    bv = torch.randn((n, chunk), generator=gen, device=dev).to(dtype)
    avr = torch.randint(0, 64, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    bvr = torch.randint(0, 64, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    return av, avr, bv, bvr


def check_kernels(n, chunk, dtype, dev, timed: bool) -> dict:
    """Each kernel against its plain version at ``[n, chunk]``; returns
    per-kernel ``max_abs_err`` and, when ``timed``, the times and bounds
    at this shape."""
    import torch
    from repro_torch.kernels import delta_join as dj
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + n + chunk)
    av, avr, bv, bvr = _operands(n, chunk, dtype, gen, dev)
    row = chunk * av.element_size()
    out = {}

    ov, over = dj.delta_join(av, avr, bv, bvr)
    pv, pvr = ref.delta_join_ref(av, avr, bv, bvr)
    torch.cuda.synchronize()
    _same_bits(ov, pv, "delta_join values")
    _same_bits(over, pvr, "delta_join versions")
    n_b = int((bvr > avr).sum())
    out["delta_join"] = {"max_abs_err": float(
        (ov.float() - pv.float()).abs().max())}
    if timed:
        # needed bytes: both version columns, the winning row of each
        # pair (the loser is never read), the merged rows and versions
        nbytes = 8 * n + n * row + n * row + 4 * n
        out["delta_join"].update(
            ms=time_ms(lambda: dj.delta_join(av, avr, bv, bvr)),
            plain_ms=time_ms(lambda: ref.delta_join_ref(av, avr, bv, bvr)),
            bound_bytes=nbytes, b_wins=n_b)
    del ov, over, pv, pvr

    got = dj.fused_join_digest(av, avr, bv, bvr)
    want = ref.fused_join_digest_ref(av, avr, bv, bvr)
    torch.cuda.synchronize()
    _same_bits(got[0], want[0], "fused_join_digest values")
    _same_bits(got[1], want[1], "fused_join_digest versions")
    _same_bits(got[2], want[2], "fused_join_digest max|x|")
    out["fused_join_digest"] = {"max_abs_err": max(
        float((got[0].float() - want[0].float()).abs().max()),
        _close(got[3], want[3], "fused_join_digest"))}
    if timed:
        nbytes = 8 * n + n * row + n * row + 4 * n + 8 * n
        out["fused_join_digest"].update(
            ms=time_ms(lambda: dj.fused_join_digest(av, avr, bv, bvr)),
            plain_ms=time_ms(lambda: ref.fused_join_digest_ref(
                av, avr, bv, bvr)),
            bound_bytes=nbytes)
    del got, want

    ma, ss = dj.chunk_digest(av)
    pma, pss = ref.chunk_digest_ref(av)
    torch.cuda.synchronize()
    _same_bits(ma, pma, "chunk_digest max|x|")
    out["chunk_digest"] = {"max_abs_err": _close(ss, pss, "chunk_digest")}
    if timed:
        out["chunk_digest"].update(
            ms=time_ms(lambda: dj.chunk_digest(av)),
            plain_ms=time_ms(lambda: ref.chunk_digest_ref(av)),
            bound_bytes=n * row + 8 * n)

    # scatter: r unique rows of b (plus ⊥ pad rows on one free row) into
    # the resident columns of a; the old columns must stay intact
    r = min(SCATTER_ROWS, n - 1)
    rng = np.random.default_rng(SEED + n)
    idx_np = np.sort(rng.choice(n - 1, size=r, replace=False))
    free = int(np.setdiff1d(np.arange(n), idx_np)[0])
    pad = 8 if n > r + 8 else 0
    idx = torch.as_tensor(np.concatenate(
        [idx_np, np.full(pad, free)]).astype(np.int32), device=dev)
    d_vals = torch.cat([bv[:r], bv.new_zeros((pad, chunk))])
    d_vers = torch.cat([bvr[:r], bvr.new_zeros(pad)])
    cols = (av, avr, ma, ss)
    keep = [c.clone() for c in cols]
    got = dj.scatter_join(*cols, idx, d_vals, d_vers)
    want = ref.scatter_join_ref(*cols, idx, d_vals, d_vers)
    torch.cuda.synchronize()
    for x, y, what in zip(got[:3], want[:3], ("values", "versions",
                                               "max|x|")):
        _same_bits(x, y, f"scatter_join {what}")
    err = _close(got[3], want[3], "scatter_join")
    for c, k in zip(cols, keep):
        _same_bits(c, k, "scatter_join old snapshot")
    out["scatter_join"] = {"max_abs_err": max(err, float(
        (got[0].float() - want[0].float()).abs().max()))}
    if timed:
        take = int((d_vers > avr[idx.long()]).sum())
        col_bytes = n * (row + 12)
        out["scatter_join"].update(
            ms=time_ms(lambda: dj.scatter_join(*cols, idx, d_vals, d_vers)),
            plain_ms=time_ms(lambda: ref.scatter_join_ref(
                *cols, idx, d_vals, d_vers)),
            # the function returns new columns: read the old ones and
            # write the new ones once, plus idx, delta versions and the
            # delta rows that win
            bound_bytes=2 * col_bytes + 8 * (r + pad) + take * row,
            copy_ms=time_ms(lambda: [torch.empty_like(c).copy_(c)
                                     for c in cols]),
            rows_only_bytes=(r + pad) * (8 + 4 + 8) + take * row
            + (r + pad) * row)
    return out


def kernel_parity(dev) -> dict:
    """Every kernel against its plain version in f32, bf16 and f16 at the
    main path's shape and two ragged small ones, timed at the main shape
    in each dtype. Returns per-kernel ``max_abs_err`` over all checks and
    the f32 times and bound (the main path stores f32)."""
    import torch
    results = {}
    n_main = sum(-(-numel // CHUNK) for _, numel in qwen_tensors())
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for n, chunk in ((n_main, CHUNK), (1001, CHUNK), (37, 100)):
            timed = n == n_main
            t0 = time.perf_counter()
            got = check_kernels(n, chunk, dtype, dev, timed)
            torch.cuda.empty_cache()
            log(f"parity {str(dtype)[6:]} [{n}x{chunk}] ok "
                f"({time.perf_counter() - t0:.3f} s)")
            for name, rec in got.items():
                agg = results.setdefault(name, {"max_abs_err": 0.0})
                agg["max_abs_err"] = max(agg["max_abs_err"],
                                         rec.pop("max_abs_err"))
                if not timed:
                    continue
                rec["bound_ms"] = rec["bound_bytes"] / HBM_BYTES_PER_S * 1e3
                extra = (f" copy_ms={rec['copy_ms']:.4f} rows_only_bound_ms="
                         f"{rec['rows_only_bytes'] / HBM_BYTES_PER_S * 1e3:.5f}"
                         if name == "scatter_join" else "")
                log(f"kernel {name} {str(dtype)[6:]} [{n}x{chunk}]: "
                    f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.4f} "
                    f"bytes={rec['bound_bytes']}{extra}")
                if dtype == torch.float32:
                    agg.update(rec)
    for name, rec in results.items():
        log(f"kernel {name}: max_abs_err={rec['max_abs_err']} over all "
            "checks")
    return results


# ---------------------------------------------------------------------------
# 3. Main path
# ---------------------------------------------------------------------------

class Replay:
    """Independent host reference: the store as numpy columns in key
    order, with every write applied last-writer-wins by version."""

    def __init__(self, names, rows, vals, version):
        self.offset = dict(zip(names, np.cumsum([0] + rows[:-1])))
        self.rows = dict(zip(names, rows))
        self.vals = vals.copy()
        self.vers = np.full(len(vals), version, np.int32)

    def write(self, name, idx, new, version) -> None:
        g = self.offset[name] + np.asarray(idx)
        take = version > self.vers[g]
        self.vals[g[take]] = new[take]
        self.vers[g[take]] = version


def make_store_values(tensors, chunk, rng):
    rows = [-(-numel // chunk) for _, numel in tensors]
    vals = rng.standard_normal((sum(rows), chunk), dtype=np.float32)
    vals *= 0.02
    for (_, numel), start, n in zip(tensors, np.cumsum([0] + rows[:-1]),
                                    rows):
        tail = n * chunk - numel          # zero the padding of a tail chunk
        if tail:
            vals[start + n - 1, chunk - tail:] = 0
    return rows, vals


def converged(reps) -> bool:
    from repro_torch.core.digest import store_digest
    d0 = store_digest(reps[0].store)
    return all(store_digest(r.store) == d0 for r in reps[1:])


def main_path(dev, tensors, chunk=CHUNK, write_rounds=WRITE_ROUNDS,
              rows_per_tensor=ROWS_PER_TENSOR):
    """Drive the port's main path; returns (replicas, replay, timings)."""
    import torch
    from repro_torch.core.propagation import StoreReplica, make_policy
    from repro_torch.core.sim import NetConfig, Simulator
    from repro_torch.core.store import LatticeStore
    from repro_torch.core.tensor_lattice import (ChunkedTensor, TensorState,
                                                 make_version)
    from repro_torch.wire.frames import WireCodec

    rng = np.random.default_rng(SEED)
    names = [n for n, _ in tensors]
    t0 = time.perf_counter()
    rows, init = make_store_values(tensors, chunk, rng)
    replay = Replay(names, rows, init, make_version(1, 0))
    log(f"store: {len(names)} keys, {sum(rows)} rows x {chunk} f32 = "
        f"{init.nbytes} bytes per replica (made in "
        f"{time.perf_counter() - t0:.3f} s)")

    wire = WireCodec(to_device=True, device=dev)
    sim = Simulator(NetConfig(loss=0.1, dup=0.1, seed=SEED))
    # digest-sync: a converged mesh trades version digests only; the
    # push policies of basic mode would re-ship and forward the 1.86 GB
    # state every quiet round
    reps = [sim.add_node(StoreReplica(
        i, [j for j in IDS if j != i], causal=False, wire=wire,
        resident=True, device=dev, policy=make_policy("digest-sync")))
        for i in IDS]
    a = reps[0]
    version0 = make_version(1, 0)
    model = {}
    for name, n in zip(names, rows):
        s = replay.offset[name]
        model[name] = TensorState.of({"w": ChunkedTensor(
            torch.from_numpy(init[s:s + n]),
            torch.full((n,), version0, dtype=torch.int32))}, lamport=1)
    # one δ-mutation puts the whole model (one store delta, 290 keys)
    a.operation(lambda _store: LatticeStore.of(model))

    def round_() -> float:
        t = time.perf_counter()
        for r in reps:
            r.on_periodic()
        sim.run_for(2.0)
        if dev != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter() - t

    def to_convergence(tag: str, limit=12) -> list:
        times = []
        while not converged(reps) or not times:
            if len(times) == limit:
                raise AssertionError(f"{tag}: no convergence in {limit} "
                                     "rounds")
            times.append(round_())
        log(f"{tag}: converged in {len(times)} rounds, round_s="
            + ",".join(f"{t:.3f}" for t in times))
        return times

    timings = {"initial_rounds_s": to_convergence("initial sync")}
    big = [i for i, n in enumerate(rows) if n >= rows_per_tensor]
    write_s = []
    for rnd in range(write_rounds):
        t = time.perf_counter()
        for rank, rep in enumerate(reps):
            for ti in rng.choice(big, size=TENSORS_PER_WRITE,
                                 replace=False):
                name = names[ti]
                sel = np.sort(rng.choice(rows[ti], size=rows_per_tensor,
                                         replace=False))
                # one delta-group of two overlapping δ-mutations: the
                # later one wins the shared rows
                cut = rows_per_tensor * 5 // 8
                i1, i2 = sel[:cut], sel[rows_per_tensor - cut:]
                v1 = rng.standard_normal((len(i1), chunk), np.float32)
                v2 = rng.standard_normal((len(i2), chunk), np.float32)
                cur = rep.get(name, TensorState)
                d1 = cur.write_delta(rank, "w", torch.from_numpy(v1).to(dev),
                                     chunk_idx=i1)
                d2 = d1.write_delta(rank, "w", torch.from_numpy(v2).to(dev),
                                    chunk_idx=i2)
                rep.put(name, d1.join(d2))
                replay.write(name, i1, v1, make_version(d1.lamport, rank))
                replay.write(name, i2, v2, make_version(d2.lamport, rank))
        write_s.append(round_() + (time.perf_counter() - t))
    timings["write_rounds_s"] = write_s
    log("write rounds: round_s=" + ",".join(f"{t:.3f}" for t in write_s))
    timings["final_rounds_s"] = to_convergence("final sync")
    return reps, replay, timings


def check_against_replay(store, replay, dev, what) -> None:
    from repro_torch.kernels import resident
    cache = resident.ensure(store, dev)
    for key, name, start, stop in cache.layout:
        if (start, stop - start) != (replay.offset[key], replay.rows[key]):
            raise AssertionError(f"{what}: layout of {key} differs")
    if not np.array_equal(cache.vers_host, replay.vers):
        raise AssertionError(f"{what}: version mirror differs from replay")
    if not np.array_equal(cache.vers.cpu().numpy(), replay.vers):
        raise AssertionError(f"{what}: versions differ from replay")
    vals = cache.vals.cpu().numpy()
    if not np.array_equal(vals.view(np.int32), replay.vals.view(np.int32)):
        raise AssertionError(f"{what}: values differ from replay")


# ---------------------------------------------------------------------------
# 4. Steady-state ingest at two sizes, 5. top-k
# ---------------------------------------------------------------------------

def ingest_scaling(store, names, dev) -> dict:
    """One decoded wire delta into the resident store at its full size
    and at half of it: same launches, same staged bytes, bounded by the
    padded index column."""
    import torch
    from repro_torch.core.store import LatticeStore
    from repro_torch.core.tensor_lattice import TensorState
    from repro_torch.kernels import ops, resident
    from repro_torch.kernels.resident import _pad_bucket
    from repro_torch.wire.codec import decode_store, encode_store

    half = store.restrict(names[: len(names) // 2])
    resident.ensure(half, dev)
    rng = np.random.default_rng(SEED + 7)
    cur = store.get(names[0], TensorState)
    n = cur.as_dict()["w"].shape[0]
    idx = np.sort(rng.choice(n, size=min(SCATTER_ROWS, n), replace=False))
    vals = torch.from_numpy(rng.standard_normal(
        (len(idx), cur.as_dict()["w"].shape[1]), np.float32)).to(dev)
    delta = LatticeStore.key_delta(names[0], cur.write_delta(
        7, "w", vals, chunk_idx=idx))
    wire = decode_store(encode_store(delta), to_device=True, device=dev)
    costs = {}
    for tag, s in (("full", store), ("half", half)):
        snap = ops.counters.snapshot()
        s.join(wire)
        costs[tag] = ops.counters.since(snap)
    bound = _pad_bucket(len(idx)) * 4
    log(f"steady ingest of {len(idx)} rows: full={costs['full']} "
        f"half={costs['half']} idx+pad bound={bound}")
    if costs["full"]["launches"] != costs["half"]["launches"] \
            or costs["full"]["h2d_bytes"] != costs["half"]["h2d_bytes"] \
            or costs["full"]["h2d_bytes"] > bound:
        raise AssertionError("steady-state ingest cost depends on store "
                             "size or stages more than the index column")
    return costs


def topk_check(store, dev) -> None:
    """``digest_select_store`` of a resident store (the top-k epilogue
    over the maintained Σx² column) against the host greedy
    ``digest_keep_plan`` over the same rows. The greedy digests each
    tensor with the chunk_digest kernel, which sums a row in the same
    lane order as the kernels that maintain the column, so the two
    rankings see identical energies."""
    import torch
    from repro_torch.core.store import LatticeStore, digest_select_store
    from repro_torch.core.tensor_lattice import (ChunkedTensor, TensorState,
                                                 digest_keep_plan)
    from repro_torch.kernels import resident

    cache = resident.ensure(store, dev)
    budget = int(0.01 * cache.rows * CHUNK * 4)
    t0 = time.perf_counter()
    keep_dev = resident.keep_plan(cache, budget)
    sel = digest_select_store(store, budget)
    t_dev = time.perf_counter() - t0
    spilled = resident.spill(store)
    if not (torch.equal(spilled.vals, cache.vals.cpu())
            and torch.equal(spilled.vers, cache.vers.cpu())):
        raise AssertionError("spill does not return the resident columns")
    views = LatticeStore.of({key: TensorState.of({name: ChunkedTensor(
        cache.vals[s:e], cache.vers[s:e])}) for key, name, s, e in
        cache.layout})
    t0 = time.perf_counter()
    keep_host = digest_keep_plan(((k, n, ct) for k, v in views.entries
                                  for n, ct in v.chunks), budget)
    t_host = time.perf_counter() - t0
    if keep_dev != keep_host:
        raise AssertionError("resident top-k differs from host greedy")
    kept = sum(len(v) for v in keep_dev.values())
    shipped = sum(len(ct.versions) for _, v in sel.entries
                  for _, ct in v.chunks)
    log(f"top-k: budget={budget} bytes kept_rows={kept} over "
        f"{len(keep_dev)} tensors; select_s={t_dev:.3f} "
        f"host_greedy_s={t_host:.3f} (selected store rows {shipped})")


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import delta_join as dj

    dev = "cuda"
    card = card_line()
    log(card)
    build()
    parity = kernel_parity(torch.device(dev))

    tensors = qwen_tensors()
    dj.reset_launches()
    t0 = time.perf_counter()
    reps, replay, timings = main_path(dev, tensors)
    a, b = reps[0].store, reps[1].store
    joined = a.join(b)                  # state-based full-state merge
    torch.cuda.synchronize()
    launches = dict(dj.launches)
    log(f"main path: {time.perf_counter() - t0:.3f} s, launches={launches}")
    for r in reps:
        check_against_replay(r.store, replay, dev, f"replica {r.id}")
    check_against_replay(joined, replay, dev, "a ⊔ b")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log("replicas equal each other and the numpy replay")

    ingest_scaling(a, [n for n, _ in tensors], dev)
    topk_check(a, dev)

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": TPU_KERNEL[name], "launches": launches[name],
        "max_abs_err": parity[name]["max_abs_err"],
        "ms": parity[name]["ms"], "plain_ms": parity[name]["plain_ms"],
        "bound_ms": parity[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": None} for name in TPU_KERNEL]
    log(json.dumps({"timings": timings}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
