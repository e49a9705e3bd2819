#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card. Run from the root of a checkout:

    python3 chip_smoke.py

1. Build: prints the card's name and power limit, then compiles every
   CUDA source of the port with ``nvcc`` (all started together) and
   logs each kernel's registers and spills.
2. Kernel parity: each of the four δ-CRDT kernels against its plain
   PyTorch version at the main path's shapes ([453113, 1024], scatter
   r=4096) and at ragged small shapes, in f32, bf16 and f16 — values,
   versions and max|x| bit-exact, Σx² to rtol 1e-4 — with CUDA-event
   times (median of 20) at the main shape in each dtype beside the
   bytes-over-bandwidth bound. Then both flash kernels against their
   plain versions (``ref.attention_ref`` / ``decode_ref``) in f32 (rtol
   = atol = 2e-5, TF32 off), bf16 and f16 (one unit in the last place of
   the output dtype at max|out|): prefill at the served shapes of
   qwen1.5-0.5b and qwen2-1.5b (GQA, head_dim 128; 1,000 tokens, which
   no tile divides), at 4,096 tokens with gemma2's window, softcap and
   query scale, and at small shapes with a window, a softcap and a
   scale; decode against the served caches, a ring with empty slots, a
   wrapped ring with a window, a row with no valid slot (exactly 0) and a
   32,768-slot cache whose splits hold several tiles. Times at the
   served shapes beside the bound and the time of
   ``scaled_dot_product_attention`` on the same inputs (a yardstick the
   port never calls): warm (events around each call, so a call shorter
   than its host enqueue reads as the enqueue), device (the card held
   busy while the host enqueues, so the events bracket the kernel only)
   and, for decode, cold (device time after a 128 MB write flushes the
   L2, as a served step finds each layer's cache). The build checks that
   the tensor-core prefill issues ``HGMMA`` (``cuobjdump -sass``).
3. Store path: three device-resident ``StoreReplica``s (basic mode,
   ``WireCodec(to_device=True)``, full mesh over a lossy, duplicating
   ``Simulator``) replicate a store holding the parameter set of
   qwen1.5-0.5b (one key per parameter tensor, 290 keys, f32 chunks of
   1024: 453,113 rows, 1.86 GB per replica). Replica a puts the store,
   the mesh converges, 8 rounds of writes follow (each replica writes
   2,048 rows over 4 tensors per round, as delta-groups of two
   δ-mutations), and the mesh converges again. The replicas must equal
   each other and an independent numpy last-writer-wins replay of every
   write, and every δ-CRDT kernel must have launched on this path.
4. Steady-state ingest: launches and staged bytes of one wire ingest are
   the same at the full and at half the store size.
5. Top-k: the resident digest ranking equals the host greedy selection.
6. Dot stores, at the sizes of ``benchmarks/bench_dots.py``: the causal
   join of two DotSet states of 1,062,500 dots over 4 replicas runs
   ``causal_join_cols`` with its containment mask on the card (mask
   launches counted from 0 around it, at least one required), bit-
   identical to the numpy path and equal to the frozenset ``causal_join``
   oracle; median host times of 5 joins on each path, run in turns, and
   the mask's share of them. ``missing_mask`` on the card (staging included, and on
   resident operands; CUDA-event medians of 20, card held) and with numpy
   at 1M and 16M packed dots, with a 65,536-dot cloud and without, beside
   the bytes bound; masks bit-identical. Then the per-dot reconnect of a
   999,000-dot ORMap between two causal ``StoreReplica``s (digest-sync,
   wire, no loss) with its masks on the card: it converges to the
   responder's state, the pull stays within 5% of one full-state frame,
   and its bytes equal the reference's (constants the CPU tests confirm).
5b. Net store path: three ``GossipNode``s in one event loop over TCP on
   loopback ephemeral ports, each holding a device-resident basic-mode
   ``StoreReplica`` of the same qwen1.5-0.5b-sized store (digest-sync,
   ``WireCodec(to_device=True)``). Every member loads the same initial
   store locally, as pods start from one checkpoint (one 1.86 GB state
   cannot cross as a frame: the transport refuses frames above 64 MiB).
   8 write rounds as in step 3 follow, each gossiped until every version
   digest agrees; then two members' stores are merged state-based. Per
   round: the wall time (ending in a synchronise), frames and bytes by
   kind, the largest frame against 64 MiB, queue drops and host→device
   bytes per ingest. The members and their merge must equal a numpy
   replay bit for bit; every δ-CRDT kernel must launch, and the launches
   read through ``obs.trace_kernel_launches`` must equal the kernels'
   own counts, the ``ops.counters`` diff and the
   ``repro_kernel_launches_total`` that ``Registry`` exports.
5c. Net sessions: three OS processes of ``python -m
   repro_torch.launch.serve --listen … --peers … --sessions 24`` gossip
   over UDP with 10% injected loss on loopback until every status file
   shows every session done and one fingerprint, each with the
   ``repro_net_*`` metric families; then the in-process ``serve
   --sessions 64 --session-ttl 5`` on the simulator must report every
   session reaped by its owners' ack quorum.
7. Serve path: ``repro_torch.launch.serve``'s model part serves
   qwen1.5-0.5b (published config, bf16, random weights from the seed)
   to 4 requests of 1,000 prompt tokens with 32 greedy tokens each, then
   qwen2-1.5b to 2 requests with 16 tokens, with ``attn_impl="chunked"``:
   attention runs in the flash kernels, exactly once per layer for the
   prefill (every bf16 launch on the tensor-core route) and once per
   layer per decode step. The plain path
   (``attn_impl="naive"``) then scores the same tokens (teacher forcing)
   and every step's logits must agree within a bf16 tolerance, the
   greedy tokens wherever the plain path's top-1/top-2 margin exceeds
   twice the logits' gap; and an f32 run of qwen1.5-0.5b at full width,
   2 layers deep, must agree with its plain path at rtol = atol = 1e-3.
   After qwen1.5-0.5b's batch, ``serve --replicate``'s code path
   replicates its session table over 3 gateways (every status "done"),
   and each model is served 5 more times on each attention path, in
   turns, for medians of prefill time and decode rate with their spread.
8. Train path: ``repro_torch.launch.train``'s ``run_sync`` trains
   qwen1.5-0.5b at full width (bf16 params, f32 master and moments,
   batch 8 × 128 tokens, lr 1e-3, random weights from seed 0) for 20
   steps under ``torch.use_deterministic_algorithms``, writing a snapshot
   at step 6 and full-state deltas at steps 12 and 18 into
   ``build/train_ckpt`` (≈6.5 GB each; the free disk is checked first,
   the directory deleted after). Per step: loss, seconds, tokens/s; the
   peak device memory; two more steps traced for the card's busy share.
   The loss must start within 0.5 of ln(151,936) and fall (the mean of
   the last four steps 0.02 nats below the first four's). The same
   command then resumes from the directory: restore = snapshot ⊔ d1 ⊔ d2
   on the card must launch ``delta_join`` exactly 114 times (57 leaves ×
   2 deltas), the restored state must equal the live state at step 18
   and a restore joined by the plain version on the card bit for bit,
   and steps 18 and 19 must print the uninterrupted run's losses
   exactly.
9. Delta mode: ``run_delta`` on the card at the JAX package's smoke size
   (REDUCED config, 2 pods, 2 local steps, 4 steps, top-k 0.1, bp+rr)
   converges with 4 dots merged.
10. Top-k: ``TopKCompressor(0.01).compress`` over qwen1.5-0.5b's
   parameters in f32 on the card, per-leaf times of the stable sort
   (and of ``torch.topk``'s selection, a yardstick, where the embedding's
   sort passes 50 ms); the embedding's and one stacked leaf's indices and
   values bit-equal to a stable CPU argsort.
11. Families: the other eight architectures the port serves, each at
   its published widths (bf16, random weights from the seed, every
   earlier tensor freed first) through ``launch.serve``'s ``generate``
   with ``attn_impl="chunked"``: gemma2-27b (all 46 layers, 1 request of
   4,608 prompt tokens, so the local layers' 4,096-slot rings wrap in
   decode), stablelm-1.6b, phi-3-vision-4.2b (256 patch embeddings + 768
   tokens), musicgen-large (frame embeddings) and mamba2-130m (24 SSD
   layers, 2 × 4,096 tokens: 16 chunks of 256 a sequence) at full depth,
   and mixtral-8x22b (4 of 56 layers), deepseek-v2-236b (3 of 60: the
   dense layer and 2 MoE) and jamba-v0.1-52b (the first 8 of 32 layers,
   one period of its interleave: 7 SSD + 1 attention, 4 dense + 4 MoE)
   cut in depth; 16 tokens out each. The flash launches are counted from
   0 around each served run: one prefill launch per attention layer
   (phi-3-vision's head_dim 96 on the CUDA-core route, the others on the
   tensor cores) and one decode launch per attention layer and step;
   deepseek's MLA and mamba2's SSD launch none (the SSD mixer has no
   kernel in either package). Each is scored by the plain path under
   the serve phase's bf16 rule; then gemma2 (one local and one global
   layer, 4,608 tokens), mixtral and deepseek at full width, 2 layers
   deep, and jamba's layers 3–4 (SSD + MoE, attention + dense) in f32 at
   rtol = atol = 1e-3. Where a check fails while the MoE routing flipped
   between the two paths (a near-tie decided the other way), the flips
   are printed and the plain path is scored again on the served routing;
   without flips a failure stands. Per model: prefill s, decode tok/s,
   peak GiB, flash launches by route and MoE pairs dropped at prefill
   and decode. Last, the SSD recurrence gate: mamba2 at full width and
   depth, in f32 (rtol = atol = 1e-3) and bf16 (the serve rule), its
   prefill and 15 decode steps fed the served tokens against
   ``forward`` over 4,096 + 256 tokens whose first 4,096 + 16 are the
   prompt and the served tokens.
12. The mesh: a one-rank NCCL group and ``launch.mesh.make_host_mesh``'s
   1×1 ("data", "model") ``DeviceMesh`` on the card. qwen1.5-0.5b
   (SERVE[0]: 4 × 1,000 prompt tokens, 32 out, bf16) served through
   ``generate`` on ``DTensor`` parameters placed by ``param_pspecs`` with
   the activation hints installed: the flash kernels launch on each
   rank's shards through ``local_map`` (counted from 0: 24 prefill
   launches, all on the tensor cores, and 24 × 31 decode), the greedy
   tokens equal the unsharded run's and every step's logits are within
   SERVE_LOGIT_TOL of max|logits| (the largest gap printed; bit-equal
   expected); decode tokens/s on the mesh against the unsharded run, in
   turns (DTensor's host cost on one card). mixtral-8x22b at full width,
   2 layers, f32: a prefill with ``moe_impl="local"`` (the per-shard
   dispatch, all-to-alls over a one-rank group) against the global path
   without a mesh: expert ids and drops bit-exact, logits within 1e-3,
   the local path's fallback counter 0. Three ``launch.train`` steps of
   qwen1.5-0.5b at full width (batch 8 × 128) unsharded, then on the
   mesh (parameters, optimizer state and batches as ``DTensor``s, the
   loss on the vocab-parallel path a real mesh runs): the first loss
   within MESH_TRAIN_RTOL_FIRST of the unsharded run's and the later
   ones within MESH_TRAIN_RTOL, under deterministic algorithms (the
   gaps printed). Then ``python -m
   repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh
   single --out build/dryrun`` in a subprocess (a fake group of 256
   ranks on ``meta`` tensors, 300 s limit) and its roofline line.

The last line is ``{"ok": true, "device": {...}}``; any failed phase
raises and the script exits non-zero without it, as it does when no card
is present.
"""

from __future__ import annotations

import json
import os
import re
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
    "flash_attention": "src/repro/kernels/flash_attention.py:119",
    "flash_decode": "src/repro/kernels/flash_attention.py:206",
}
SOURCE = "src/repro_torch/kernels/csrc/delta_join.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# the decode design's kernels as a trace names them: one kernel, whose
# last block of each (row, KV head) also merges the splits
DECODE_KERNEL_NAMES = ("flash_decode_kernel",)
PREFILL_KERNEL_NAMES = ("flash_fwd_tc_kernel", "flash_fwd_kernel")
# published dense peaks of one H100 SXM: f32 on the CUDA cores (the
# decode kernel's and the CUDA-core prefill's route), bf16 / f16 on the
# tensor cores (the tensor-core prefill's, which multiplies P twice: hi
# and lo halves)
F32_FLOPS = 67e12
TYPE_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
FLUSH_BYTES = 128 << 20          # written between cold timings: > 50 MB L2
HOLD_CYCLES = 2_000_000          # ~1 ms of card busy while the host enqueues
ATTN_RTOL = ATTN_ATOL = 2e-5     # f32 flash parity, the JAX package's bar
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}   # at 1.0
SERVE = (                        # arch, requests, prompt tokens, tokens out
    ("qwen1.5-0.5b", 4, 1000, 32),
    ("qwen2-1.5b", 2, 1000, 16),
)
# served bf16 logits against the plain path's: the kernels keep the
# softmax probabilities in f32 where the plain path rounds them to bf16,
# so the two differ by bf16 rounding carried through every layer
SERVE_LOGIT_TOL = 0.05           # of max|logits|
F32_DEPTH = 2                    # layers of the f32 full-width check
F32_RTOL = F32_ATOL = 1e-3
SERVE_REPEATS = 5                # timed runs of each attn_impl, in turns
SESSION_GATEWAYS = 3
# phase 11, the families: every other architecture the port serves, at its
# published widths (random bf16 weights from the seed); the MoE models
# cut in depth to fit one card. Layers: None for all, N for the first N,
# (start, stop) for that slice of the layout
FAMILIES = (   # arch, layers on the card, requests, prompt, out
    ("gemma2-27b", None, 1, 4608, 16),       # crosses the 4,096 window
    ("stablelm-1.6b", None, 2, 1000, 16),
    ("phi-3-vision-4.2b", None, 2, 1024, 16),   # 256 patches + 768 tokens
    ("musicgen-large", None, 2, 1000, 16),   # frame embeddings in
    ("mixtral-8x22b", 4, 2, 1000, 16),       # 4 of 56 layers
    ("deepseek-v2-236b", 3, 2, 1000, 16),    # the dense layer and 2 MoE
    ("mamba2-130m", None, 2, 4096, 16),      # 16 chunks of 256 a sequence
    ("jamba-v0.1-52b", 8, 2, 1024, 16),      # one period: 7 SSM + 1 attn
)
FAMILY_ROUTE = {"phi-3-vision-4.2b": "simt"}   # head_dim 96; others tc
FAMILIES_F32 = (   # arch, layers, requests, prompt, out: f32, full width
    ("gemma2-27b", 2, 1, 4608, 8),           # one local, one global layer
    ("mixtral-8x22b", 2, 2, 1000, 8),
    ("deepseek-v2-236b", 2, 2, 1000, 8),     # the dense layer and 1 MoE
    ("jamba-v0.1-52b", (3, 5), 2, 1024, 8),  # SSM + MoE, attn + dense
)
# the SSD recurrence (prefill, then decode steps) against the chunked
# form over a longer sequence, in f32 (F32_RTOL) and bf16
# (SERVE_LOGIT_TOL): arch, requests, prompt, out
SSM_GATE = ("mamba2-130m", 2, 4096, 16)
# phase 12, the mesh: a one-rank NCCL group and its 1×1 ("data", "model")
# DeviceMesh on the card. Served: SERVE[0] on DTensor parameters; MoE:
# arch, layers, requests, prompt (f32, moe_impl "local" against "global");
# train: steps of TRAIN_ARGS' model and batch; the dry-run's CLI cell
MESH_MOE = ("mixtral-8x22b", 2, 2, 256)
MESH_MOE_TOL = 1e-3              # rtol = atol, f32
MESH_TRAIN_STEPS = 3
# relative gaps of the mesh's train losses from the unsharded run's: the
# first step's (the same parameters; f32 losses whose two paths sum in
# other orders), then the later steps' (the two losses' gradients round
# to bf16 differently, and the parameters part from there)
MESH_TRAIN_RTOL_FIRST = 1e-6
MESH_TRAIN_RTOL = 1e-4
MESH_TURNS = 2                   # timed (plain, mesh, mesh, plain) rounds
DRYRUN_ARGS = ("--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh",
               "single", "--out", "build/dryrun")
DRYRUN_TIMEOUT = 300
# dot stores at the sizes of an OR-Set / session-table deployment
# (benchmarks/bench_dots.py): a 1,062,500-dot causal join over 4
# replicas, and a reconnect of a 999,000-dot ORMap (2,000 keys of 500
# dots; every 10th key missed 10 writes, every 10th key offset 5 lost 5
# elements at the responder)
JOIN_PER_RID = 250_000
JOIN_REPEATS = 5
RECONNECT = {"n_keys": 2000, "per_key": 500, "missing_tail": 10,
             "removed_head": 5}
# the reference's pull at that size (digest request, response) and its
# one full-state frame: the figures tests/test_torch_replica.py confirms
# on the CPU for both packages
RECONNECT_REQUEST_BYTES = 21_284
RECONNECT_RESPONSE_BYTES = 71_530
RECONNECT_FULL_STATE_BYTES = 10_544_464
RECONNECT_MAX_SHARE = 0.05       # of the full-state frame
MASK_DOTS = (1 << 20, 1 << 24)   # 8 MB and 128 MB int64 dot columns
MASK_RIDS = 64
MASK_CLOUD = 1 << 16
MASK_NUMPY_REPS = 5
# the net phases: the store over TCP on loopback (anti-entropy period,
# digest poll, per-round wait, the transport's frame limit) and the
# session cluster of three serve processes over lossy UDP, as
# benchmarks/bench_net.py runs it. The three members share one event
# loop, and a digest request that arrives before the requester has
# ingested the previous response is answered again: at a 0.5 s period
# the redundant responses compounded from round to round (PERF.md §6),
# so the period leaves the host several times a round's work.
NET_TICK = 2.0
NET_POLL = 0.1
NET_ROUND_TIMEOUT = 120.0
MAX_FRAME = 64 << 20
NET_SESSIONS = 24
NET_SESSION_ARGS = ("--sessions", str(NET_SESSIONS), "--ship-policy",
                    "bp+rr+digest-sync:4", "--transport", "udp",
                    "--udp-loss", "0.1", "--tick", "0.1", "--metrics")
NET_RUN_FOR = 20.0
NET_WAIT_S = 90.0
TTL_SESSIONS = 64
TTL_SECONDS = 5
# the training phases (slices E-train and D): ``launch.train --mode sync``
# at full width, 20 steps with a checkpoint every 6 (snapshot seq 0 at
# step 6, deltas seq 1 and 2 at steps 12 and 18), then the same command
# resumed from the directory, which must rerun steps 18 and 19 from
# snapshot ⊔ d1 ⊔ d2 — one delta_join launch per leaf per delta past the
# snapshot: 57 leaves (14 parameters; m, v and master of each; the step).
# The synthetic stream's next token is a function of the previous one,
# but at a 151,936-token vocabulary a step's 1,024 tokens are almost all
# new to the model, so in 20 steps the loss can only fall from the random
# head's ≈ln(vocab) + 0.2 toward ln(vocab): the check compares the means
# of the first and the last four steps
TRAIN_ARGS = ("--arch", "qwen1.5-0.5b", "--device", "cuda", "--batch", "8",
              "--seq", "128", "--steps", "20", "--ckpt-every", "6",
              "--snap-every", "3", "--log-every", "1", "--lr", "1e-3")
TRAIN_LEAVES = 57
TRAIN_RESTORE_JOINS = 2 * TRAIN_LEAVES      # two deltas past the snapshot
TRAIN_RESUME_STEP = 18
TRAIN_DIR = ROOT / "build" / "train_ckpt"
TRAIN_DISK_BYTES = 24 << 30     # three 6.5 GB files and a temp file
TRAIN_LOSS_DROP = 0.02          # nats, mean of the last 4 below the first 4
TRAIN_TRACED_STEPS = 2
DELTA_ARGS = ("--mode", "delta", "--device", "cuda", "--pods", "2",
              "--local-steps", "2", "--steps", "4", "--topk", "0.1",
              "--ship-policy", "bp+rr")
TOPK_RATE = 0.01
TOPK_SELECT_IF_MS = 50.0        # time a selection beside the sort past this


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
        spills = [ln.strip() for ln in report.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                      "spill loads")]
        log(f"built {name}: {len(regs)} kernels; " + "; ".join(
            sorted(set(r.split("Used ")[-1] for r in regs)))
            + f"; spills: {spills or 'none'}")
        _build.library(name)
    log(f"build_s={time.perf_counter() - t0:.3f}")
    hgmma = sass_count(_build.lib_path("flash_attention"), "HGMMA")
    log(f"HGMMA instructions in the SASS of each tensor-core kernel: "
        f"{hgmma}")
    if not hgmma or not all(hgmma.values()):
        raise AssertionError("the tensor-core prefill issues no wgmma")


def sass_count(lib, opcode) -> dict:
    """``opcode``'s count in the SASS of each tensor-core prefill kernel
    of the built library (``cuobjdump -sass`` from the CUDA toolkit)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if "flash_fwd_tc_kernel" in fn else None
            if fn:
                counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    short = {}
    for name, n in counts.items():    # e.g. flash_fwd_tc_kernel<bf16, 64>
        t = "f16" if "6__half" in name else "bf16"
        hd = re.search(r"Li(\d+)E", name)
        short[f"{t}/hd{hd.group(1) if hd else '?'}"] = n
    return short


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


_flush = []                      # the cold timings' L2 flush buffer


def time_ms(fn, reps=20, held=False, cold=False) -> float:
    """Median time of ``fn()`` over ``reps`` calls: CUDA events around
    each call, after one warm-up. By default the events see the card as
    the host reaches it, so a call shorter than its own host enqueue reads
    as the enqueue. ``held``: the card is first kept busy
    (``torch.cuda._sleep``) while the host enqueues the events and the
    call, so they bracket device time only. ``cold`` (held too): a
    ``FLUSH_BYTES`` buffer is written before each call, outside the
    events, so the call finds the 50 MB L2 cold, as a served step finds
    each layer's cache."""
    import torch
    if cold and not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                  device="cuda"))
    fn()
    torch.cuda.synchronize()
    times = []
    for rep in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            _flush[0].fill_(rep)
        if held or cold:
            torch.cuda._sleep(HOLD_CYCLES)
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
# 2b. Flash attention parity and timing
# ---------------------------------------------------------------------------

# tag, b, h, kv, s, hd, options, timed: the served prefill shapes, gemma2's
# long-window shape, and the small shapes of the JAX package's flash tests
PREFILL_CHECKS = [
    ("qwen1.5-0.5b", 4, 16, 16, 1000, 64, {}, True),
    ("qwen2-1.5b", 2, 12, 2, 1000, 128, {}, True),
    ("gemma2-4096", 1, 32, 16, 4096, 128,
     {"window": 4096, "softcap": 50.0, "scale": 144.0 ** -0.5}, True),
] + [(f"small-{b}x{h}x{kv}x{s}x{hd}", b, h, kv, s, hd, opts, False)
     for b, h, kv, s, hd in ((1, 4, 4, 256, 64), (2, 8, 2, 256, 64),
                             (1, 4, 1, 512, 128), (1, 2, 2, 128, 32))
     for opts in ({}, {"window": 48}, {"softcap": 30.0}, {"scale": 0.0825})]
# tag, b, h, kv, C, hd, tokens written, options, rows with no valid slot,
# timed: the served caches midway through decode, then the edge cases
DECODE_CHECKS = [
    ("qwen1.5-0.5b", 4, 16, 16, 1032, 64, 1016, {}, (), True),
    ("qwen2-1.5b", 2, 12, 2, 1016, 128, 1008, {}, (), True),
    ("empty-slots", 2, 8, 2, 256, 64, 100, {}, (), False),
    ("wrapped-ring-window", 1, 4, 2, 128, 64, 300, {"window": 128}, (),
     False),
    ("no-valid-row", 3, 4, 2, 96, 128, 50,
     {"window": 16, "softcap": 30.0, "scale": 0.0825}, (1,), False),
    # splits of four 128-slot tiles through the decode ring
    ("long-cache", 1, 16, 8, 32768, 64, 32000, {"window": 20000}, (), False),
]


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def _attention_err(got, want, what) -> float:
    """max|got - want|; raises beyond rtol = atol = 2e-5 in f32, or one
    unit in the last place of the output dtype at max|want|."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} "
                             f"!= {want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        ok = bool(torch.isclose(got, want, rtol=ATTN_RTOL,
                                atol=ATTN_ATOL).all())
        bar = f"rtol=atol={ATTN_RTOL}"
    else:
        tol = ULP[_dt(got.dtype)] * float(want.float().abs().max())
        ok, bar = err <= tol, f"atol={tol:.3g} (1 ulp at max|out|)"
    if not ok:
        raise AssertionError(f"{what}: kernel differs from plain version "
                             f"by {err} ({bar})")
    return err


def _bound(flops, nbytes, dtype, route_flops, route_rate) -> dict:
    """Least time of the work on this card: the larger of the operations
    over the peak rate of their type and the bytes over the memory rate;
    ``route_bound_ms`` takes the operations the kernel's route issues
    (``route_flops``) at that route's peak rate instead."""
    ops_ms = flops / TYPE_FLOPS[_dt(dtype)] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "route_bound_ms": max(route_flops / route_rate * 1e3, bytes_ms),
            "flops": flops, "bytes": nbytes}


def _timings(rec, fns, modes) -> None:
    """Times of the kernel, its plain version and the library call (None:
    no library call) in each mode: ``warm`` (the host's enqueue may be
    inside the events), ``dev`` (held: device time, warm
    L2) and ``cold`` (device time after an L2 flush). The row's ``ms``,
    ``plain_ms`` and ``library_ms`` are those of the last mode."""
    for mode in modes:
        for key, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            rec[f"{mode}_{key}"] = None if fn is None else time_ms(
                fn, held=mode == "dev", cold=mode == "cold")
    for key in ("ms", "plain_ms", "library_ms"):
        rec[key] = rec[f"{modes[-1]}_{key}"]


def _ring(b, kv, C, hd, filled, dtype, dev, gen, empty_rows=()):
    """A ring cache after ``filled`` tokens (token t in slot t % C, the
    latest token of each slot kept); rows in ``empty_rows`` hold none."""
    import torch
    k = torch.zeros((b, kv, C, hd), device=dev, dtype=dtype)
    v = torch.zeros_like(k)
    pos = np.full((b, C), -1, np.int32)
    used = np.arange(min(filled, C))
    pos[:, used] = used + C * ((filled - 1 - used) // C)
    pos[list(empty_rows)] = -1
    k[:, :, used] = torch.randn((b, kv, used.size, hd), generator=gen,
                                device=dev).to(dtype)
    v[:, :, used] = torch.randn((b, kv, used.size, hd), generator=gen,
                                device=dev).to(dtype)
    return k, v, torch.from_numpy(pos).to(dev)


def _prefill_check(tag, b, h, kv, s, hd, opts, timed, dtype, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + s * h + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd)))
    got = fa.flash_attention(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    rec = {"max_abs_err": _attention_err(got, want, f"flash_attention "
                                         f"{tag} {_dt(dtype)}")}
    del got, want
    if not timed:
        return rec
    window = opts.get("window") or s
    pairs = int(np.minimum(np.arange(1, s + 1), window).sum())
    es = q.element_size()
    flops = 4 * hd * b * h * pairs
    rec["route"] = fa.prefill_route(dtype, hd)
    # the tensor-core route multiplies P twice (hi and lo halves): 1.5x
    route = ((1.5 * flops, TYPE_FLOPS[_dt(dtype)]) if rec["route"] == "tc"
             else (flops, F32_FLOPS))
    rec.update(_bound(flops, es * (2 * b * h * s * hd + 2 * b * kv * s * hd),
                      dtype, *route))
    library = None
    if "softcap" not in opts and opts.get("window") is None:
        def library():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True,
                scale=opts.get("scale"))
    _timings(rec, (lambda: fa.flash_attention(q, k, v, **opts),
                   lambda: ref.attention_ref(q, k, v, **opts), library),
             ("warm", "dev"))
    torch.cuda.empty_cache()
    return rec


def _decode_check(tag, b, h, kv, C, hd, filled, opts, empty, timed, dtype,
                  dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + C + filled)
    k, v, kpos = _ring(b, kv, C, hd, filled, dtype, dev, gen, empty)
    q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(dtype)
    qpos = torch.full((b, 1), filled, dtype=torch.int32, device=dev)
    got = fa.flash_decode(q, k, v, qpos, kpos, **opts)
    want = ref.decode_ref(q, k, v, qpos, kpos, **opts)
    torch.cuda.synchronize()
    rec = {"max_abs_err": _attention_err(got, want, f"flash_decode {tag} "
                                         f"{_dt(dtype)}")}
    for r in empty:
        if bool(got[r].any()):
            raise AssertionError(f"flash_decode {tag}: a row with no "
                                 "valid slot is not exactly 0")
    if not timed:
        return rec
    valid = (kpos >= 0) & (kpos <= qpos)
    if opts.get("window") is not None:
        valid &= (qpos - kpos) < opts["window"]
    n_valid = int(valid.sum())          # (row, slot) pairs the step needs
    es = q.element_size()
    flops = 4 * hd * h * n_valid
    rec["route"] = "cuda cores"
    rec.update(_bound(flops, 2 * n_valid * kv * hd * es + 4 * b * C
                      + 2 * b * h * hd * es + 4 * b, dtype, flops,
                      F32_FLOPS))
    mask = valid[:, None, None, :]
    rec["splits"] = fa.decode_splits(b, kv, C, fa.decode_tile(hd, es),
                                     fa.sm_count(q.device))
    _timings(rec, (
        lambda: fa.flash_decode(q, k, v, qpos, kpos, **opts),
        lambda: ref.decode_ref(q, k, v, qpos, kpos, **opts),
        lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True,
            scale=opts.get("scale"))), ("warm", "dev", "cold"))
    return rec


def flash_parity(dev) -> dict:
    """Both flash kernels against their plain versions in f32, bf16 and
    f16; returns per-kernel ``max_abs_err`` over all checks and the times
    and bound at the served qwen1.5-0.5b shape in bf16 (the main path's
    dtype)."""
    import torch
    results = {"flash_attention": {"max_abs_err": 0.0},
               "flash_decode": {"max_abs_err": 0.0}}
    runs = ([("flash_attention", c, _prefill_check) for c in PREFILL_CHECKS]
            + [("flash_decode", c, _decode_check) for c in DECODE_CHECKS])
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        t0 = time.perf_counter()
        for name, case, check in runs:
            rec = check(*case, dtype, dev)
            agg = results[name]
            agg["max_abs_err"] = max(agg["max_abs_err"],
                                     rec.pop("max_abs_err"))
            if "ms" not in rec:
                continue
            times = " ".join(
                f"{k}={'null' if v is None else f'{v:.4f}'}"
                for k, v in rec.items() if k.endswith("ms")
                and k.split("_")[0] in ("warm", "dev", "cold"))
            log(f"kernel {name} {case[0]} {_dt(dtype)} ({rec['route']}"
                + (f", splits {rec['splits']}" if "splits" in rec else "")
                + f"): {times} bound_ms={rec['bound_ms']:.5f} "
                f"({rec['bound_by']}) route_bound_ms="
                f"{rec['route_bound_ms']:.5f} of_bound="
                f"{rec['bound_ms'] / rec['ms']:.4f} flops={rec['flops']} "
                f"bytes={rec['bytes']}")
            if case[0] == "qwen1.5-0.5b" and dtype == torch.bfloat16:
                agg.update(rec)
        log(f"flash parity {_dt(dtype)} ok: {len(PREFILL_CHECKS)} prefill "
            f"and {len(DECODE_CHECKS)} decode checks "
            f"({time.perf_counter() - t0:.3f} s)")
    for name, rec in results.items():
        log(f"kernel {name}: max_abs_err={rec['max_abs_err']} over all "
            "checks")
    return results


# ---------------------------------------------------------------------------
# 3. Store path
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
    """Drive the port's store path; returns (replicas, replay, timings)."""
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
# 5b. Net store path: the resident store replicating over loopback TCP
# ---------------------------------------------------------------------------

def _kernel_launch_total(registry, node) -> int:
    return int(registry.snapshot()["repro_kernel_launches_total"][node])


def net_store_path(dev, tensors, chunk=CHUNK, write_rounds=WRITE_ROUNDS,
                   rows_per_tensor=ROWS_PER_TENSOR, tick=NET_TICK) -> dict:
    """Three ``GossipNode``s in one event loop over TCP on loopback
    ephemeral ports, each holding a device-resident basic-mode
    ``StoreReplica`` (``digest-sync``, ``WireCodec(to_device=True)``).
    Every member loads the same initial store locally (version
    ``make_version(1, 0)``, lamport 1, as pods start from one
    checkpoint), then ``write_rounds`` rounds of writes follow as in
    :func:`main_path`, each gossiped until every version digest agrees.
    The per-kernel launches are counted from 0 around the phase and read
    three ways: ``delta_join.launches``, ``kernel_launch`` events of
    ``obs.trace_kernel_launches``, and ``repro_kernel_launches_total`` of
    ``Registry.absorb_kernel_counters``."""
    import asyncio
    import random
    import torch
    from repro_torch.core.digest import store_digest
    from repro_torch.core.propagation import (StoreReplica, make_policy,
                                              stable_seed)
    from repro_torch.core.store import LatticeStore
    from repro_torch.core.tensor_lattice import (ChunkedTensor, TensorState,
                                                 make_version)
    from repro_torch.kernels import delta_join as dj
    from repro_torch.kernels import ops, resident
    from repro_torch.net import start_cluster, stop_cluster, wait_converged
    from repro_torch.obs import Registry, Tracer, trace_kernel_launches
    from repro_torch.wire import WireCodec

    rng = np.random.default_rng(SEED + 1)
    names = [n for n, _ in tensors]
    rows, init = make_store_values(tensors, chunk, rng)
    version0 = make_version(1, 0)
    replay = Replay(names, rows, init, version0)

    def factory(node_id, neighbors):
        return StoreReplica(
            node_id, list(neighbors), causal=False, resident=True,
            device=dev, wire=WireCodec(to_device=True, device=dev),
            policy=make_policy("digest-sync"),
            rng=random.Random(stable_seed(node_id)))

    def sync() -> None:
        if dev != "cpu":
            torch.cuda.synchronize()

    def totals(nodes) -> dict:
        out = {"frames": {}, "bytes": {}, "recv": 0, "queue_drops": 0}
        for n in nodes:
            for k, v in n.stats.by_kind.items():
                out["frames"][k] = out["frames"].get(k, 0) + v
            for k, v in n.stats.bytes_by_kind.items():
                out["bytes"][k] = out["bytes"].get(k, 0) + v
            out["recv"] += n.stats.recv_by_kind.get("digest-resp", 0)
            out["queue_drops"] += n.stats.queue_drops
        return out

    def diff(after, before) -> dict:
        return {"frames": {k: v - before["frames"].get(k, 0)
                           for k, v in after["frames"].items()},
                "bytes": {k: v - before["bytes"].get(k, 0)
                          for k, v in after["bytes"].items()},
                "ingests": after["recv"] - before["recv"],
                "queue_drops": after["queue_drops"] - before["queue_drops"]}

    tracer = Tracer(node="net-store", capacity=1 << 20)
    registry = Registry()
    registry.absorb_kernel_counters(node="net-store")
    largest, max_frame = [0, 0], [0]      # overall, this round; limit
    ingests = []                # (frame bytes, h2d bytes) of each ingest
    host_s = {}                 # host seconds in ticks, frames and polls

    async def scenario():
        nodes = await start_cluster(len(IDS), transport="tcp", tick=tick,
                                    replica_factory=factory,
                                    start_gossip=False, seed=SEED)
        try:
            max_frame[0] = max(n.transport.max_frame for n in nodes)
            for n in nodes:            # every frame delivered, by size
                def seen(src, frame, deliver=n._on_frame):
                    largest[0] = max(largest[0], len(frame))
                    largest[1] = max(largest[1], len(frame))
                    h2d = ops.counters.h2d_bytes
                    t = time.perf_counter()
                    deliver(src, frame)
                    kind = getattr(frame, "kind", "frame")
                    host_s[kind] = (host_s.get(kind, 0.0)
                                    + time.perf_counter() - t)
                    if kind == "digest-resp":
                        ingests.append((len(frame),
                                        ops.counters.h2d_bytes - h2d))
                n.transport.set_receiver(seen)

                def timed_tick(periodic=n.replica.on_periodic):
                    t = time.perf_counter()
                    periodic()
                    host_s["tick"] = (host_s.get("tick", 0.0)
                                      + time.perf_counter() - t)
                n.replica.on_periodic = timed_tick
            t = time.perf_counter()
            for n in nodes:
                model = {}
                for name, r in zip(names, rows):
                    s = replay.offset[name]
                    model[name] = TensorState.of({"w": ChunkedTensor(
                        torch.from_numpy(init[s:s + r]),
                        torch.full((r,), version0, dtype=torch.int32))},
                        lamport=1)
                n.replica.operation(lambda _s, m=model: LatticeStore.of(m))
                resident.ensure(n.replica.store, dev)  # adopt on the card
            sync()
            log(f"net store: {len(nodes)} members over TCP at "
                + ", ".join(n.addr for n in nodes) + f", each loaded "
                f"{init.nbytes} bytes in {time.perf_counter() - t:.3f} s")
            for n in nodes:
                await n.start()

            def agreed() -> bool:
                t = time.perf_counter()
                d0 = store_digest(nodes[0].replica.store)
                same = all(store_digest(n.replica.store) == d0
                           for n in nodes[1:])
                host_s["poll"] = (host_s.get("poll", 0.0)
                                  + time.perf_counter() - t)
                return same

            big = [i for i, r in enumerate(rows) if r >= rows_per_tensor]
            rounds = []
            for rnd in range(write_rounds):
                before = totals(nodes)
                first = len(ingests)
                host_s.clear()
                largest[1] = 0
                t = time.perf_counter()
                for rank, n in enumerate(nodes):
                    for ti in rng.choice(big, size=TENSORS_PER_WRITE,
                                         replace=False):
                        name = names[ti]
                        sel = np.sort(rng.choice(rows[ti],
                                                 size=rows_per_tensor,
                                                 replace=False))
                        cut = rows_per_tensor * 5 // 8
                        i1, i2 = sel[:cut], sel[rows_per_tensor - cut:]
                        v1 = rng.standard_normal((len(i1), chunk),
                                                 np.float32)
                        v2 = rng.standard_normal((len(i2), chunk),
                                                 np.float32)
                        cur = n.replica.get(name, TensorState)
                        d1 = cur.write_delta(rank, "w",
                                             torch.from_numpy(v1).to(dev),
                                             chunk_idx=i1)
                        d2 = d1.write_delta(rank, "w",
                                            torch.from_numpy(v2).to(dev),
                                            chunk_idx=i2)
                        n.replica.put(name, d1.join(d2))
                        replay.write(name, i1, v1,
                                     make_version(d1.lamport, rank))
                        replay.write(name, i2, v2,
                                     make_version(d2.lamport, rank))
                await wait_converged(nodes, timeout=NET_ROUND_TIMEOUT,
                                     poll=NET_POLL, settle=agreed)
                sync()
                wall = time.perf_counter() - t
                d = diff(totals(nodes), before)
                h2d = [b for _, b in ingests[first:]]
                d["h2d_per_ingest"] = (sum(h2d) / len(h2d) if h2d
                                       else 0.0)
                d["wall_s"] = wall
                d["largest_frame"] = largest[1]
                d["host_s"] = dict(host_s)
                rounds.append(d)
                log(f"net store round {rnd}: {wall:.3f} s, frames "
                    f"{d['frames']}, bytes {d['bytes']}, largest frame "
                    f"{largest[1]} B of {max_frame[0]}, ingests "
                    f"{d['ingests']}, h2d/ingest {d['h2d_per_ingest']:.0f} "
                    f"B, queue drops {d['queue_drops']}, host s in ticks, "
                    f"frames by kind and digest polls {host_s}")
            for n in nodes:
                n.check_healthy()
            return nodes, rounds
        except BaseException:
            await stop_cluster(nodes)
            raise

    dj.reset_launches()
    snap = ops.counters.snapshot()
    reg0 = _kernel_launch_total(registry, "net-store")
    uninstall = trace_kernel_launches(tracer)
    t0 = time.perf_counter()
    try:
        loop = asyncio.new_event_loop()
        try:
            nodes, rounds = loop.run_until_complete(scenario())
            stores = [n.replica.store for n in nodes]
            joined = stores[0].join(stores[1])   # state-based full merge
            sync()
            loop.run_until_complete(stop_cluster(nodes))
        finally:
            loop.close()
    finally:
        uninstall()
    wall = time.perf_counter() - t0
    launches = dict(dj.launches)
    ops_launches = ops.counters.since(snap)["launches"]
    reg_launches = _kernel_launch_total(registry, "net-store") - reg0
    traced = {}
    for e in tracer.events():
        if e["kind"] == "kernel_launch":
            traced[e["op"]] = traced.get(e["op"], 0) + 1
    log(f"net store path: {wall:.3f} s; kernel launches {launches}; traced "
        f"{traced}; ops.counters {ops_launches}; "
        f"repro_kernel_launches_total {reg_launches}; largest frame "
        f"{largest[0]} B of {max_frame[0]}")
    if sum(traced.values()) != ops_launches or reg_launches != ops_launches:
        raise AssertionError("traced launches, ops.counters and the "
                             "registry disagree")
    if dev != "cpu" and any(traced.get(k, 0) != v
                            for k, v in launches.items()):
        raise AssertionError("traced launches differ from the kernels' "
                             "own counts")
    if max_frame[0] != MAX_FRAME or largest[0] > MAX_FRAME:
        raise AssertionError(f"a frame of {largest[0]} B against a "
                             f"{max_frame[0]} B limit")
    if any(r["queue_drops"] for r in rounds):
        raise AssertionError("the send queues dropped frames")
    for n, s in zip(IDS, stores):
        check_against_replay(s, replay, dev, f"net member {n}")
    check_against_replay(joined, replay, dev, "net a ⊔ b")
    log("net members equal each other and the numpy replay")
    # an ingest stages its frame's columns and a padded row index, never
    # the store: host→device bytes stay within 1% of the frame's length
    over = [(f, b) for f, b in ingests if b > 1.01 * f]
    if over or not ingests:
        raise AssertionError(f"ingests staged more than their frames "
                             f"(frame B, h2d B): {over[:4]}")
    log(f"net store ingests: {len(ingests)}, h2d per ingest "
        f"{min(b for _, b in ingests)}–{max(b for _, b in ingests)} B for "
        f"frames of {min(f for f, _ in ingests)}–"
        f"{max(f for f, _ in ingests)} B")
    return {"wall_s": wall, "rounds": rounds, "launches": launches,
            "traced": traced, "largest_frame": largest[0]}


def _free_ports(n, kind) -> list:
    """``n`` loopback ports the OS reports free for ``kind`` sockets."""
    import socket
    socks = [socket.socket(socket.AF_INET, kind) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def net_sessions_path(dev) -> dict:
    """Three OS processes of ``python -m repro_torch.launch.serve
    --listen … --peers …`` gossip ``NET_SESSIONS`` session keys over
    lossy UDP on loopback; every status file must show ``all_done``, every
    key and one fingerprint, with the ``repro_net_*`` families in each
    metrics snapshot. Then the in-process ``serve --sessions 64
    --session-ttl 5`` on the simulator must reap every session."""
    import contextlib
    import io
    import os
    import socket
    import subprocess
    import tempfile
    from repro_torch.launch import serve

    ports = _free_ports(len(IDS), socket.SOCK_DGRAM)
    members = [f"gw{k}@127.0.0.1:{p}" for k, p in enumerate(ports)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        status = [Path(tmp) / f"gw{k}.json" for k in range(len(IDS))]
        logs = [open(Path(tmp) / f"gw{k}.log", "w")
                for k in range(len(IDS))]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--device", dev, "--listen", me,
             "--peers", ",".join(m for m in members if m != me),
             *NET_SESSION_ARGS, "--run-for", str(NET_RUN_FOR),
             "--status-file", str(st)], cwd=ROOT, env=env,
            stdout=lg, stderr=subprocess.STDOUT)
            for me, st, lg in zip(members, status, logs)]
        try:
            seen = None
            while time.perf_counter() - t0 < NET_WAIT_S:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                try:
                    seen = [json.loads(st.read_text()) for st in status]
                except (FileNotFoundError, json.JSONDecodeError):
                    seen = None
                if seen and all(s["all_done"] and s["keys"] == NET_SESSIONS
                                for s in seen) \
                        and len({s["fingerprint"] for s in seen}) == 1:
                    break
                time.sleep(0.1)
            wall = time.perf_counter() - t0
            for p in procs:
                p.wait(timeout=NET_RUN_FOR + 60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for lg in logs:
                lg.close()
        text = [(Path(tmp) / f"gw{k}.log").read_text()
                for k in range(len(IDS))]
        final = [json.loads(st.read_text()) if st.exists() else None
                 for st in status]
    for k, t in enumerate(text):
        log(f"  serve gw{k}: " + t.strip().replace("\n", "\n  serve: "))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a serve process of the UDP session cluster "
                             f"failed: {[p.returncode for p in procs]}")
    if not seen or not all(s["all_done"] and s["keys"] == NET_SESSIONS
                           for s in seen) \
            or len({s["fingerprint"] for s in seen}) != 1:
        raise AssertionError(f"the UDP session cluster did not agree "
                             f"within {NET_WAIT_S} s: {seen}")
    for s in final:
        missing = [f for f in ("repro_net_frames_sent_total",
                               "repro_net_bytes_by_kind_total",
                               "repro_net_bytes_recv_total")
                   if f not in s.get("metrics", {})]
        if missing:
            raise AssertionError(f"{s['id']}: metrics lack {missing}")
    by_kind = {}                        # sent until the cluster agreed
    for s in seen:
        for k, v in s["bytes_by_kind"].items():
            by_kind[k] = by_kind.get(k, 0) + v
    out["udp_cluster"] = {"converged_s": wall, "bytes_by_kind": by_kind,
                          "fingerprint": seen[0]["fingerprint"]}
    log(f"net sessions: 3 processes over UDP (10% loss) agreed on "
        f"{NET_SESSIONS} sessions, fingerprint {seen[0]['fingerprint']}, "
        f"{wall:.3f} s from launch; frame bytes by kind {by_kind}")

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", dev, "--batch", "2", "--prompt-len", "16",
                    "--gen", "4", "--sessions", str(TTL_SESSIONS),
                    "--session-ttl", str(TTL_SECONDS)])
    wall = time.perf_counter() - t0
    printed = buf.getvalue()
    log("  " + printed.strip().replace("\n", "\n  "))
    want = (f"all {TTL_SESSIONS} sessions expired and were reaped by "
            "their owners' ack quorum")
    if want not in printed:
        raise AssertionError(f"serve --session-ttl did not reap: {printed}")
    out["ttl_wall_s"] = wall
    log(f"ttl sessions: {wall:.3f} s")
    return out


# ---------------------------------------------------------------------------
# 6. Dot stores: the columnar causal join, its containment mask, reconnect
# ---------------------------------------------------------------------------

def join_inputs(per_rid):
    """Two divergent DotSet states over rids a..d, built as packed columns
    (``benchmarks/bench_dots.py``'s ``_join_inputs``): A holds a and b in
    full and has seen and removed c up to ``per_rid // 2``; B holds a up
    to ``per_rid // 4`` and c, d in full, and has seen and removed b up to
    ``per_rid // 5``. Returns the port's ``(sa, ca, sb, cb)``."""
    from repro_torch.convert import dotstore_from_numpy
    from repro_torch.core.dotcols import SEQ_BITS

    def packed(rid, lo, hi):
        return ((np.int64(rid) << SEQ_BITS)
                | np.arange(lo, hi + 1, dtype=np.int64))

    n, rids = per_rid, ("a", "b", "c", "d")
    sa, ca = dotstore_from_numpy(
        rids, np.concatenate([packed(0, 1, n), packed(1, 1, n)]),
        [n, n, n // 2, 0])
    sb, cb = dotstore_from_numpy(
        rids, np.concatenate([packed(0, 1, n // 4), packed(2, 1, n),
                              packed(3, 1, n)]), [n // 4, n // 5, n, n])
    return sa, ca, sb, cb


def big_ormap(n_keys, per_key, missing_tail, removed_head):
    """A requester / responder pair of ORMaps of AWORSets, one rid and
    ``per_key`` dots a key, each element equal to its seq
    (``bench_dots.py``'s ``_big_ormap``): every 10th key the requester
    missed the last ``missing_tail`` writes; every 10th key offset 5 the
    responder removed the first ``removed_head`` elements."""
    from repro_torch.convert import dotstore_from_numpy
    from repro_torch.core.crdts import ORMap
    from repro_torch.core.dotcols import SEQ_BITS

    rids = tuple(f"r{j:04d}" for j in range(n_keys))
    keys = tuple(f"k{j:04d}" for j in range(n_keys))

    def build(missed):
        vv = np.full(n_keys, per_key, np.int64)
        seqs = []
        for j in range(n_keys):
            lo, hi = 1, per_key
            if missed and j % 10 == 0:
                hi = vv[j] = per_key - missing_tail
            if not missed and j % 10 == 5:
                lo = removed_head + 1
            seqs.append(np.arange(lo, hi + 1, dtype=np.int64))
        counts = [c.size for c in seqs]
        seq = np.concatenate(seqs)
        rid = np.repeat(np.arange(n_keys, dtype=np.int64), counts)
        return ORMap(*dotstore_from_numpy(
            rids, (rid << SEQ_BITS) | seq, vv, vals=seq, keys=keys,
            offsets=np.concatenate([[0], np.cumsum(counts)])))

    return build(True), build(False)


def reconnect(n_keys, per_key, missing_tail, removed_head) -> dict:
    """``bench_dots.py``'s per-dot reconnect in the port: two causal
    ``StoreReplica``s under ``digest-sync`` with the wire on and no loss;
    the stale one sends its digest, the peer answers with the dots it
    lacks. Masks run where the caller's ``mask_device`` scope says."""
    import random
    from repro_torch.core import (LatticeStore, NetConfig, Simulator,
                                  StoreReplica, make_policy)
    from repro_torch.wire import WireCodec, encode_frame, encode_value

    req_map, resp_map = big_ormap(n_keys, per_key, missing_tail,
                                  removed_head)
    wire = WireCodec()
    sim = Simulator(NetConfig(loss=0.0, seed=21))
    stale, peer = (sim.add_node(StoreReplica(
        me, [other], causal=True, wire=wire,
        policy=make_policy("digest-sync"), rng=random.Random(3)))
        for me, other in (("stale", "peer"), ("peer", "stale")))
    stale.X = LatticeStore.of({"map": req_map})
    peer.X = LatticeStore.of({"map": resp_map})
    t0 = time.perf_counter()
    stale.on_periodic()                  # digest out, per-dot response back
    sim.run_for(5.0)
    wall = time.perf_counter() - t0
    return {"dots": int(resp_map.store.packed.size),
            "converged": stale.X == peer.X,
            "request_bytes": sim.stats.bytes_by_kind.get("digest", 0),
            "response_bytes": sim.stats.bytes_by_kind.get("digest-resp", 0),
            "full_state_bytes": len(encode_frame("state",
                                                 encode_value(peer.X))),
            "wall_s": wall}


def _same_join(got, want, what) -> None:
    (gs, gc), (ws, wc) = got, want
    if not (gs.rids == ws.rids == gc.rids == wc.rids
            and np.array_equal(gs.packed, ws.packed)
            and np.array_equal(gc.vvcol, wc.vvcol)
            and np.array_equal(gc.cloudcol, wc.cloudcol)):
        raise AssertionError(f"{what}: joins differ")


def _host_times(fn, reps) -> list:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return times


def mask_inputs(n, with_cloud, seed):
    """``n`` sorted packed dots over ``MASK_RIDS`` replicas (seqs 1 ..
    n / MASK_RIDS each), a vv column between a quarter of that and all
    of it, and — ``with_cloud`` — a sorted cloud of ``MASK_CLOUD`` dots
    drawn from those above the vv."""
    from repro_torch.core.dotcols import SEQ_BITS
    rng = np.random.default_rng(seed)
    per = n // MASK_RIDS
    rid = np.repeat(np.arange(MASK_RIDS, dtype=np.int64), per)
    seq = np.tile(np.arange(1, per + 1, dtype=np.int64), MASK_RIDS)
    dots = (rid << SEQ_BITS) | seq
    vv = rng.integers(per // 4, per, MASK_RIDS).astype(np.int64)
    cloud = np.zeros(0, np.int64)
    if with_cloud:
        cloud = np.sort(rng.choice(dots[seq > vv[rid]], MASK_CLOUD,
                                   replace=False))
    return vv, cloud, dots


def mask_scaling(dev) -> list:
    """``missing_mask`` on the card (staging included, and on operands
    already there) and with numpy at about 1M and 16M dots, with a cloud
    and without: bit-identical masks, times beside the bytes bound (the
    columns read once, the mask written once, over the memory rate)."""
    import torch
    from repro_torch.core import dotcols
    from repro_torch.kernels import ops

    rows = []
    for n in MASK_DOTS:
        for with_cloud in (False, True):
            vv, cloud, dots = mask_inputs(n, with_cloud, SEED + n)
            want = dotcols.missing_mask(vv, cloud, dots, backend="numpy")
            with dotcols.mask_device(dev):
                snap = ops.counters.snapshot()
                got = dotcols.missing_mask(vv, cloud, dots, backend="torch")
                moved = ops.counters.since(snap)
                if not np.array_equal(got, want):
                    raise AssertionError(f"missing_mask at {n} dots: card "
                                         "differs from numpy")
                card_ms = time_ms(lambda: dotcols.missing_mask(
                    vv, cloud, dots, backend="torch"), held=True)
            cols = [torch.from_numpy(c).to(dev) for c in (vv, cloud, dots)]
            on_card = dotcols._torch_missing(*cols)
            if not np.array_equal(on_card.cpu().numpy(), want):
                raise AssertionError(f"missing_mask at {n} dots: resident "
                                     "operands differ from numpy")
            device_ms = time_ms(lambda: dotcols._torch_missing(*cols),
                                held=True)
            numpy_ms = 1e3 * float(np.median(_host_times(
                lambda: dotcols.missing_mask(vv, cloud, dots,
                                             backend="numpy"),
                MASK_NUMPY_REPS)))
            nbytes = vv.nbytes + cloud.nbytes + dots.nbytes + n
            row = {"dots": n, "cloud": int(cloud.size), "ms": card_ms,
                   "device_ms": device_ms, "numpy_ms": numpy_ms,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bytes": nbytes, "h2d_bytes": moved["h2d_bytes"],
                   "d2h_bytes": moved["d2h_bytes"],
                   "missing": int(want.sum())}
            log("missing_mask " + " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))
            rows.append(row)
            del cols, on_card
            torch.cuda.empty_cache()
    return rows


def dots_path(dev) -> dict:
    """The dot-store phase: the 1,062,500-dot causal join with its mask on
    the card (launches counted from 0 around it), held bit-identical to
    the numpy path and equal to the frozenset oracle; median host times
    of both paths and the mask's share; the mask's scaling; the
    999,000-dot per-dot reconnect with its masks on the card."""
    from repro_torch.core import dotcols
    from repro_torch.core.dots import causal_join
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    sa, ca, sb, cb = join_inputs(JOIN_PER_RID)
    total = int(sa.packed.size + sb.packed.size)
    log(f"dots: join inputs of {total} dots made in "
        f"{time.perf_counter() - t0:.3f} s")

    dotcols.launches["missing_mask"] = 0
    snap = ops.counters.snapshot()
    with dotcols.mask_device(dev):
        got = dotcols.causal_join_cols(sa, ca, sb, cb)
    moved = ops.counters.since(snap)
    launches = dotcols.launches["missing_mask"]
    if launches < 1:
        raise AssertionError("the 1M-dot causal join launched no mask on "
                             "the card")
    with dotcols.mask_device("cpu"):
        want = dotcols.causal_join_cols(sa, ca, sb, cb)
    _same_join(got, want, "1M-dot join, card mask vs numpy")
    t0 = time.perf_counter()
    so, co = causal_join(sa.to_obj(), ca.to_obj(), sb.to_obj(), cb.to_obj())
    oracle_s = time.perf_counter() - t0
    if got[0].to_obj() != so or got[1].to_obj() != co:
        raise AssertionError("1M-dot join differs from the frozenset oracle")
    log(f"dots: 1M-dot join on the card mask: {launches} mask launches, "
        f"staged {moved['h2d_bytes']} B, fetched {moved['d2h_bytes']} B; "
        f"bit-identical to numpy; equal to the frozenset oracle "
        f"({oracle_s:.3f} s)")

    # host-clocked joins on each path, and the mask's part of them
    inner, spent = dotcols.missing_mask, []

    def timed_mask(*args, **kw):
        t = time.perf_counter()
        out = inner(*args, **kw)
        spent.append(time.perf_counter() - t)
        return out

    paths = (("card", dev), ("numpy", "cpu"))
    times = {path: [] for path, _ in paths}
    masks = {path: [] for path, _ in paths}
    dotcols.missing_mask = timed_mask
    try:
        for rep in range(JOIN_REPEATS + 1):          # in turns; 0 warms up
            for path, where in paths:
                spent.clear()
                with dotcols.mask_device(where):
                    t = _host_times(lambda: dotcols.causal_join_cols(
                        sa, ca, sb, cb), 1)[0]
                if rep:
                    times[path].append(t)
                    masks[path].append(sum(spent))
    finally:
        dotcols.missing_mask = inner
    join = {}
    for path, ts in times.items():
        join[path] = {"median_s": float(np.median(ts)), "min_s": min(ts),
                      "max_s": max(ts),
                      "mask_median_s": float(np.median(masks[path])),
                      "mask_share": sum(masks[path]) / sum(ts)}
        log(f"dots: join ({path} mask) over {JOIN_REPEATS} runs in turns: "
            + " ".join(f"{k}={v:.5f}" for k, v in join[path].items()))

    scaling = mask_scaling(dev)

    dotcols.launches["missing_mask"] = 0
    with dotcols.mask_device(dev):
        rec = reconnect(**RECONNECT)
    rec["mask_launches"] = dotcols.launches["missing_mask"]
    pull = rec["request_bytes"] + rec["response_bytes"]
    rec["share"] = pull / rec["full_state_bytes"]
    log("dots: reconnect " + " ".join(
        f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in rec.items()))
    want_bytes = (RECONNECT_REQUEST_BYTES, RECONNECT_RESPONSE_BYTES,
                  RECONNECT_FULL_STATE_BYTES)
    if not rec["converged"]:
        raise AssertionError("per-dot reconnect did not converge")
    if (rec["request_bytes"], rec["response_bytes"],
            rec["full_state_bytes"]) != want_bytes:
        raise AssertionError(f"reconnect bytes differ from the reference's "
                             f"{want_bytes}")
    if not 0 < pull <= RECONNECT_MAX_SHARE * rec["full_state_bytes"]:
        raise AssertionError(f"reconnect pull {pull} B is above "
                             f"{RECONNECT_MAX_SHARE} of full state")
    if rec["mask_launches"] < 1:
        raise AssertionError("the reconnect launched no mask on the card")
    return {"join_dots": total, "join_mask_launches": launches,
            "join_staged_bytes": moved["h2d_bytes"],
            "oracle_s": oracle_s, "join": join, "mask": scaling,
            "reconnect": rec}


# ---------------------------------------------------------------------------
# 7. Serve path
# ---------------------------------------------------------------------------

def _logit_checks(served, plain, tol_rel, what) -> dict:
    """Every step's served logits against the plain path's (teacher
    forced on the served tokens) within ``tol_rel`` of max|logits|, and
    the served greedy token equal to the plain argmax wherever the plain
    top-1/top-2 margin exceeds twice that row's observed gap."""
    import torch
    worst = mean = 0.0
    checked = total = 0
    for step, (s_lg, p_lg) in enumerate(zip(served.logits, plain.logits)):
        if not bool(torch.isfinite(s_lg).all()):
            raise AssertionError(f"{what}: step {step} logits not finite")
        gap = (s_lg - p_lg).abs()
        tol = tol_rel * float(p_lg.abs().max())
        if float(gap.max()) > tol:
            raise AssertionError(f"{what}: step {step} logits differ by "
                                 f"{float(gap.max())} > {tol}")
        worst = max(worst, float(gap.max()) / float(p_lg.abs().max()))
        mean = max(mean, float(gap.mean()))
        top2 = p_lg.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * gap.amax(dim=-1)
        agree = torch.from_numpy(served.tokens[:, step]).to(p_lg.device) \
            == p_lg.argmax(dim=-1)
        if not bool(agree[sure].all()):
            raise AssertionError(f"{what}: step {step} greedy token differs "
                                 "where the plain margin is decisive")
        checked += int(sure.sum())
        total += sure.numel()
    log(f"{what}: logits within {tol_rel} of max|logits| at every step "
        f"(worst {worst:.3e} of max, largest mean gap {mean:.3e}); greedy "
        f"tokens equal at {checked}/{total} decisive positions")
    return {"worst_rel_gap": worst, "decisive": checked, "positions": total}


def _traced(what, steps, names) -> dict:
    """Where the time of ``steps`` (calls, one step each) goes: host clock
    per step (ending in a synchronise), the host time to enqueue it, and
    — from a ``torch.profiler`` trace — the card's busy time (sum of
    kernel durations) and the part of it in kernels whose name holds one
    of ``names``, per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    enqueue, wall = [], []
    trace = ROOT / "build" / f"trace_{what.replace(' ', '_')}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for step in steps:
            t0 = time.perf_counter()
            step()
            enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    mine = [e for e in kernels if any(n in e["name"] for n in names)]
    n = len(steps)
    rec = {"step_ms": 1e3 * float(np.median(wall)),
           "enqueue_ms": 1e3 * float(np.median(enqueue)),
           "kernels_per_step": len(kernels) / n,
           "device_busy_ms": sum(e["dur"] for e in kernels) / 1e3 / n,
           "kernel_ms": sum(e["dur"] for e in mine) / 1e3 / n,
           "kernel_launches_per_step": len(mine) / n}
    rec["busy_share"] = (rec["device_busy_ms"] / rec["step_ms"]
                         if kernels else None)
    log(f"{what} (profiled, {n} steps; kernel = {'/'.join(names)}): "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in rec.items())
        + ("" if kernels else " — the profiler saw no device time: busy "
           "share not measured"))
    return rec


def decode_breakdown(cfg, params, prompt, gen, steps=4) -> dict:
    """Where a decode step's time goes (``_traced``), flash_decode's part
    of the card's busy time."""
    import torch
    from repro_torch.models import decode_step, prefill

    b = next(iter(prompt.values())).shape[0]
    n = sum(v.shape[1] for v in prompt.values())
    logits, caches = prefill(cfg, params, prompt, max_len=n + gen)
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    state = {"caches": caches}

    def step(k):
        pos = torch.full((b, 1), n + k, dtype=torch.int32, device=tok.device)
        _, state["caches"] = decode_step(cfg, params, tok, pos,
                                         state["caches"])
    return _traced(f"decode step {cfg.name}",
                   [lambda k=k: step(k) for k in range(steps)],
                   DECODE_KERNEL_NAMES)


def prefill_breakdown(cfg, params, prompt, gen, steps=2) -> dict:
    """Where a prefill's time goes (``_traced``), flash_attention's part
    of the card's busy time."""
    from repro_torch.models import prefill

    n = sum(v.shape[1] for v in prompt.values())
    return _traced(f"prefill {cfg.name}",
                   [lambda: prefill(cfg, params, prompt, max_len=n + gen)]
                   * steps, PREFILL_KERNEL_NAMES)


def serve_path(dev) -> dict:
    """Serve both models through ``repro_torch.launch.serve``'s model
    part; returns the flash launches of the served runs and timings."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import (generate, make_prompt,
                                          replicate_sessions)
    from repro_torch.models import init_model
    from repro_torch.tree import leaves

    launches = {"flash_attention": 0, "flash_decode": 0}
    out = {}
    for arch, b, prompt_len, gen in SERVE:
        cfg = dataclasses.replace(get_config(arch), attn_impl="chunked")
        t0 = time.perf_counter()
        params = init_model(cfg, SEED, device=dev)
        n_params = sum(t.numel() for t in leaves(params))
        prompt, _ = make_prompt(cfg, b, prompt_len, SEED, dev)
        generate(cfg, params, prompt, 2)          # warm-up, not counted
        torch.cuda.synchronize()
        log(f"serve {arch}: {n_params} parameters ({cfg.dtype}) made in "
            f"{time.perf_counter() - t0:.3f} s")

        fa.reset_launches()
        run = generate(cfg, params, prompt, gen, keep_logits=True)
        got = dict(fa.launches)
        L = cfg.n_layers
        want = {"flash_attention": L, "flash_decode": L * (gen - 1)}
        if got != want:
            raise AssertionError(f"serve {arch}: launches {got}, expected "
                                 f"{want}")
        # every bf16 prefill launch took the tensor-core route
        if fa.routes != {"flash_attention_tc": L, "flash_attention_simt": 0}:
            raise AssertionError(f"serve {arch}: prefill routes "
                                 f"{fa.routes}, expected all {L} on the "
                                 "tensor cores")
        for k in launches:
            launches[k] += got[k]
        if run.tokens.shape != (b, gen) or not (
                (run.tokens >= 0) & (run.tokens < cfg.vocab)).all():
            raise AssertionError(f"serve {arch}: bad tokens {run.tokens}")
        toks = b * (gen - 1)
        rec = {"prefill_s": run.prefill_s, "decode_s": run.decode_s,
               "prefill_tok_per_s": b * prompt_len / run.prefill_s,
               "decode_tok_per_s": toks / run.decode_s, "launches": got}
        log(f"serve {arch} (chunked, card): batch={b} prompt={prompt_len} "
            f"gen={gen} prefill_s={run.prefill_s:.4f} "
            f"decode_s={run.decode_s:.4f} "
            f"prefill_tok_per_s={rec['prefill_tok_per_s']:.1f} "
            f"decode_tok_per_s={rec['decode_tok_per_s']:.1f} "
            f"launches={got} routes={dict(fa.routes)}; req 0: "
            f"{run.tokens[0].tolist()}")
        if arch == SERVE[0][0]:
            rec["sessions"] = session_table(replicate_sessions, b, dev)

        plain_cfg = dataclasses.replace(cfg, attn_impl="naive")
        plain = generate(plain_cfg, params, prompt, gen, keep_logits=True,
                         forced=torch.from_numpy(run.tokens).to(dev))
        rec["plain_prefill_s"] = plain.prefill_s
        rec["plain_decode_s"] = plain.decode_s
        log(f"serve {arch} (naive, card, teacher-forced): "
            f"prefill_s={plain.prefill_s:.4f} decode_s={plain.decode_s:.4f}")
        rec.update(_logit_checks(run, plain, SERVE_LOGIT_TOL,
                                 f"serve {arch} chunked vs naive"))
        rec["repeated"] = serve_repeats(arch, cfg, plain_cfg, params, prompt,
                                        b, prompt_len, gen)
        rec["decode_step"] = decode_breakdown(cfg, params, prompt, gen)
        rec["prefill_step"] = prefill_breakdown(cfg, params, prompt, gen)
        out[arch] = rec
        del params, run, plain
        torch.cuda.empty_cache()

    # f32 at full width, 2 layers deep: the served path against the plain
    # one at rtol = atol = 1e-3 (TF32 is off)
    arch, b, prompt_len, gen = SERVE[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=F32_DEPTH,
                              dtype="float32", attn_impl="chunked")
    params = init_model(cfg, SEED + 1, device=dev)
    prompt, _ = make_prompt(cfg, b, prompt_len, SEED + 1, dev)
    run = generate(cfg, params, prompt, 8, keep_logits=True)
    plain = generate(dataclasses.replace(cfg, attn_impl="naive"), params,
                     prompt, 8, keep_logits=True,
                     forced=torch.from_numpy(run.tokens).to(dev))
    worst = 0.0
    for step, (s_lg, p_lg) in enumerate(zip(run.logits, plain.logits)):
        if not bool(torch.isclose(s_lg, p_lg, rtol=F32_RTOL,
                                  atol=F32_ATOL).all()):
            raise AssertionError(f"f32 {arch} depth {F32_DEPTH}: step "
                                 f"{step} beyond rtol=atol={F32_RTOL}")
        worst = max(worst, float((s_lg - p_lg).abs().max()))
    if not np.array_equal(run.tokens, plain.tokens):
        raise AssertionError(f"f32 {arch}: greedy tokens differ")
    log(f"serve {arch} f32 depth {F32_DEPTH}: chunked equals naive within "
        f"rtol=atol={F32_RTOL} at all 8 steps (max gap {worst:.3e}), "
        "same tokens")
    out["f32_depth2_max_gap"] = worst
    return {"launches": launches, "timings": out}


def session_table(replicate, b, dev) -> dict:
    """The served batch's session table over ``SESSION_GATEWAYS``
    gateways through ``serve --replicate``'s code path, on the card's
    process: every status must read ``"done"``."""
    t0 = time.perf_counter()
    statuses, frame_bytes = replicate(b, SESSION_GATEWAYS, "bp+rr", SEED,
                                      True, dev)
    wall = time.perf_counter() - t0
    log(f"  [δ-CRDT] session table replicated over {SESSION_GATEWAYS} "
        f"gateways (25% loss, policy=bp+rr, frame_bytes={frame_bytes}): "
        f"{statuses} ({wall:.3f} s)")
    if len(statuses) != b or any(v != "done" for v in statuses.values()):
        raise AssertionError(f"session table not all done: {statuses}")
    return {"frame_bytes": frame_bytes, "wall_s": wall}


def serve_repeats(arch, cfg, plain_cfg, params, prompt, b, prompt_len,
                  gen) -> dict:
    """``SERVE_REPEATS`` host-clocked runs of each attention path, in
    turns (chunked, naive, chunked, …) in this one process: medians with
    their spread (min, max)."""
    from repro_torch.launch.serve import generate

    runs = {"chunked": [], "naive": []}
    for _ in range(SERVE_REPEATS):
        for impl, c in (("chunked", cfg), ("naive", plain_cfg)):
            r = generate(c, params, prompt, gen)
            runs[impl].append((r.prefill_s, b * (gen - 1) / r.decode_s))
    out = {}
    for impl, rs in runs.items():
        pre = [p for p, _ in rs]
        tok = [t for _, t in rs]
        out[impl] = {"prefill_s": float(np.median(pre)),
                     "prefill_s_min": min(pre), "prefill_s_max": max(pre),
                     "prefill_tok_per_s": b * prompt_len / float(
                         np.median(pre)),
                     "decode_tok_per_s": float(np.median(tok)),
                     "decode_tok_per_s_min": min(tok),
                     "decode_tok_per_s_max": max(tok)}
        log(f"serve {arch} ({impl}, card, median of {SERVE_REPEATS}): "
            + " ".join(f"{k}={v:.4f}" for k, v in out[impl].items()))
    return out


# ---------------------------------------------------------------------------
# 8-10. Training: sync mode with checkpoints and resume, delta mode, top-k
# ---------------------------------------------------------------------------

def _state_bits_equal(a, b, what) -> None:
    """Two ``TensorState``s hold the same names, and bit for bit the
    same values and versions (on the card)."""
    import torch
    ca, cb = a.as_dict(), b.as_dict()
    if list(ca) != list(cb):
        raise AssertionError(f"{what}: different tensors")
    for name in ca:
        x, y = ca[name], cb[name]
        if x.values.dtype != y.values.dtype or not (
                torch.equal(_bits(x.values), _bits(y.values.to(
                    x.values.device)))
                and torch.equal(x.versions, y.versions.to(
                    x.versions.device))):
            raise AssertionError(f"{what}: {name} differs")


def plain_restore(directory: Path, dev):
    """``DeltaCheckpointStore.restore`` with the plain ``delta_join`` on
    the card: the snapshot's and every later delta's columns loaded onto
    ``dev`` and joined leaf by leaf with ``ref.delta_join_ref``."""
    from repro_torch.checkpoint.store import _state_from_npz
    from repro_torch.core.tensor_lattice import ChunkedTensor, TensorState
    from repro_torch.kernels import ref
    manifest = json.loads((directory / "manifest.json").read_text())
    snap = max(manifest["snapshots"])
    state = _state_from_npz(str(directory / f"snapshot-{snap:08d}.npz"),
                            dev)
    cols, lamport = state.as_dict(), state.lamport
    for seq in sorted(manifest["deltas"]):
        if seq <= snap:
            continue
        delta = _state_from_npz(str(directory / f"delta-{seq:08d}.npz"), dev)
        for name, ct in delta.chunks:
            cols[name] = ChunkedTensor(*ref.delta_join_ref(
                cols[name].values, cols[name].versions, ct.values,
                ct.versions))
        lamport = max(lamport, delta.lamport)
        del delta
    return TensorState.of(cols, lamport=lamport)


def train_path(dev) -> dict:
    """``launch.train --mode sync`` at full width on the card (steps,
    checkpoints, a resume through the ``delta_join`` kernel), under
    ``torch.use_deterministic_algorithms`` so the resumed steps must
    reproduce the uninterrupted run's losses exactly."""
    import shutil
    import torch
    from repro_torch.kernels import delta_join as dj
    from repro_torch.launch import train
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, make_train_step

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    free = shutil.disk_usage(TRAIN_DIR).free
    log(f"train: checkpoint directory {TRAIN_DIR} has {free / 2**30:.1f} "
        f"GiB free (needs {TRAIN_DISK_BYTES / 2**30:.0f})")
    if free < TRAIN_DISK_BYTES:
        raise AssertionError("not enough disk for the training checkpoints")
    argv = list(TRAIN_ARGS) + ["--ckpt-dir", str(TRAIN_DIR)]
    args = train.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train.run_sync(args)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        losses, step_s = first["losses"], first["step_s"]
        tokens = args.batch * args.seq
        for k, (loss, sec) in enumerate(zip(losses, step_s)):
            log(f"  train step {k}: loss={loss:.6f} step_s={sec:.4f} "
                f"tokens_per_s={tokens / sec:.1f}")
        steady = float(np.median(step_s[1:]))
        out.update(loss_first=losses[0], loss_last=losses[-1],
                   step_s_median=steady, tokens_per_s=tokens / steady,
                   ckpt_s=first["ckpt_s"])
        log(f"train {cfg.name} sync (batch {args.batch} × seq "
            f"{args.seq}): loss {losses[0]:.4f} → {losses[-1]:.4f} "
            f"(ln vocab = {np.log(cfg.vocab):.4f}); median step "
            f"{steady:.4f} s = {tokens / steady:.1f} tokens/s; peak "
            f"{out['peak_gib']:.2f} GiB; checkpoint writes "
            + ", ".join(f"{t:.2f}" for t in first["ckpt_s"]) + " s")
        out["loss_drop"] = float(np.mean(losses[:4]) - np.mean(losses[-4:]))
        log(f"train loss: mean of the first 4 steps minus the last 4 = "
            f"{out['loss_drop']:.4f} nats")
        if not (abs(losses[0] - np.log(cfg.vocab)) < 0.5
                and out["loss_drop"] > TRAIN_LOSS_DROP):
            raise AssertionError("the training loss did not fall from "
                                 "ln(vocab)")

        # where a step's time goes: two more steps, traced
        step_fn = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
            lr=args.lr, warmup_steps=max(10, args.steps // 20),
            total_steps=args.steps)))
        batch = train._batch(SyntheticLMStream(
            vocab=cfg.vocab, seq=args.seq, batch=args.batch,
            seed=args.seed), 0, dev)
        out["traced"] = _traced(
            f"train step {cfg.name}",
            [lambda: step_fn(first["params"], first["opt_state"], batch)]
            * TRAIN_TRACED_STEPS, ("gemm", "nvjet"))
        live = first["last_checkpoint"]
        del first, step_fn, batch
        torch.cuda.empty_cache()

        # crash and resume: the same command again, from the directory
        if len(live.chunks) != TRAIN_LEAVES:
            raise AssertionError(f"{len(live.chunks)} checkpoint leaves, "
                                 f"expected {TRAIN_LEAVES}")
        before = dj.launches["delta_join"]
        second = train.run_sync(train.parse_args(argv))
        torch.cuda.synchronize()
        joins = dj.launches["delta_join"] - before
        log(f"train resume: started at step {second['start_step']}, "
            f"restore {second['restore_s']:.3f} s, delta_join launches "
            f"{joins} (predicted {TRAIN_RESTORE_JOINS}), losses "
            + ", ".join(f"{v:.6f}" for v in second["losses"]))
        if second["start_step"] != TRAIN_RESUME_STEP:
            raise AssertionError("the resumed run started at the wrong step")
        if joins != TRAIN_RESTORE_JOINS:
            raise AssertionError("restore launched delta_join a number of "
                                 "times other than predicted")
        if second["losses"] != losses[TRAIN_RESUME_STEP:]:
            raise AssertionError("the resumed steps' losses differ from "
                                 "the uninterrupted run's")
        restored = second["restored"]
        _state_bits_equal(restored, live, "restored vs live checkpoint")
        del second
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = plain_restore(TRAIN_DIR, dev)
        torch.cuda.synchronize()
        out["plain_restore_s"] = time.perf_counter() - t0
        _state_bits_equal(restored, plain, "kernel vs plain restore")
        log(f"train restore: bit-equal to the live state at step "
            f"{TRAIN_RESUME_STEP} and to the plain-version restore "
            f"({out['plain_restore_s']:.3f} s); resumed losses equal the "
            "uninterrupted run's")
        out.update(restore_joins=joins, restored_leaves=len(live.chunks))
        del restored, plain, live
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    out["delta_join_launches"] = joins
    return out


def delta_path() -> dict:
    """``launch.train --mode delta`` on the card at the JAX package's own
    smoke size (REDUCED config, 2 pods, top-k payloads, bp+rr)."""
    from repro_torch.launch import train
    t0 = time.perf_counter()
    run = train.run_delta(train.parse_args(list(DELTA_ARGS)))
    wall = time.perf_counter() - t0
    if run["dots"] != 4:
        raise AssertionError(f"{run['dots']} dots merged, expected 4")
    log(f"train delta mode: {wall:.3f} s, payload_atoms="
        f"{run['payload_atoms']}, {run['dots']} dots merged")
    return {"wall_s": wall, "payload_atoms": run["payload_atoms"]}


def topk_path(dev) -> dict:
    """``TopKCompressor(0.01).compress`` over qwen1.5-0.5b's parameters
    in f32 on the card: per-leaf ``_topk_sparsify`` times (CUDA events,
    card held, median of 5), the whole call's host time, and the
    embedding and one stacked leaf bit-equal to a stable CPU argsort of
    -|x| (ties to the lower index)."""
    import dataclasses
    import torch
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.sync import TopKCompressor
    from repro_torch.sync.compression import _topk_sparsify

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), dtype="float32")
    params = init_model(cfg, SEED + 2, device=dev)
    pairs, _ = tu.flatten_with_path(params)
    per_leaf = {}
    for name, leaf in pairs:
        k = max(1, int(round(TOPK_RATE * leaf.numel())))
        per_leaf[name] = time_ms(lambda: _topk_sparsify(leaf, k), reps=5,
                                 held=True)
    comp = TopKCompressor(TOPK_RATE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sparse = comp.compress(params)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    emb = params["embed"]["tok"]
    log(f"top-k {TOPK_RATE} over {len(pairs)} f32 leaves "
        f"({sum(p.numel() for _, p in pairs)} elements): compress "
        f"{total_s * 1e3:.3f} ms (host clock, synchronised); the leaves' "
        f"sorts {sum(per_leaf.values()):.3f} ms (device); per leaf "
        + ", ".join(f"{n}={t:.4f}" for n, t in per_leaf.items()) + " ms")
    out = {"compress_ms": total_s * 1e3, "per_leaf_ms": per_leaf,
           "embed_ms": per_leaf["['embed']['tok']"]}
    if out["embed_ms"] > TOPK_SELECT_IF_MS:
        k = max(1, int(round(TOPK_RATE * emb.numel())))
        flat = emb.reshape(-1)
        out["embed_select_ms"] = time_ms(lambda: torch.topk(flat.abs(), k),
                                         reps=5, held=True)
        log(f"top-k: the embedding's stable sort takes "
            f"{out['embed_ms']:.3f} ms; torch.topk's selection (no tie "
            f"rule, not used) {out['embed_select_ms']:.3f} ms")
    for name, leaf, got in (
            ("['embed']['tok']", emb, sparse["embed"]["tok"]),
            ("['groups'][0][0]['mlp']['wi']", params["groups"][0][0]["mlp"]
             ["wi"], sparse["groups"][0][0]["mlp"]["wi"])):
        x = leaf.reshape(-1).cpu().numpy() + np.float32(0)
        k = max(1, int(round(TOPK_RATE * x.size)))
        t0 = time.perf_counter()
        idx = np.argsort(-np.abs(x), kind="stable")[:k]
        cpu_s = time.perf_counter() - t0
        if not (np.array_equal(got["idx"].cpu().numpy(), idx.astype(
                np.int32)) and got["vals"].cpu().numpy().tobytes()
                == x[idx].tobytes()):
            raise AssertionError(f"top-k of {name} differs from the stable "
                                 "CPU argsort")
        log(f"top-k {name}: {k} of {x.size} indices and values bit-equal "
            f"to the stable CPU argsort ({cpu_s:.3f} s on the host)")
    del params, sparse, comp
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 11. Families: the remaining dense configs, MoE and MLA
# ---------------------------------------------------------------------------

def _cut(cfg, depth):
    """``cfg`` at its published widths, cut to ``depth``: its first
    ``depth`` layers, or with a ``(start, stop)`` pair that slice of its
    layout."""
    import dataclasses
    if depth is None:
        return cfg
    start, stop = (0, depth) if isinstance(depth, int) else depth
    layout = cfg.default_layout()[start:stop]
    return dataclasses.replace(cfg, n_layers=len(layout), layout=layout)


def _check_family_launches(arch, cfg, gen, got, routes) -> None:
    """One prefill launch per attention layer on the model's route, one
    decode launch per attention layer and step; none for MLA layers."""
    attn = sum(spec.kind == "attn" for spec in cfg.default_layout())
    want = {"flash_attention": attn, "flash_decode": attn * (gen - 1)}
    route = FAMILY_ROUTE.get(arch, "tc")
    want_routes = {"flash_attention_tc": 0, "flash_attention_simt": 0}
    want_routes[f"flash_attention_{route}"] = attn
    if got != want or routes != want_routes:
        raise AssertionError(f"families {arch}: launches {got} routes "
                             f"{routes}, expected {want} {want_routes}")


def _routing_flips(a, b) -> int:
    """Tokens whose expert set differs between two runs' routing."""
    import torch
    flips = 0
    for x, y in zip(a.expert_ids, b.expert_ids, strict=True):
        flips += int((torch.sort(x, -1).values
                      != torch.sort(y, -1).values).any(-1).sum())
    return flips


def _scored(what, cfg, params, prompt_fn, gen, run, tap, check):
    """The plain path (``attn_impl="naive"``) teacher-forced on the served
    tokens (embeddings: the same draws) and held to the served run by
    ``check``. If that fails while the MoE routing flipped between the
    two paths (a near-tie decided the other way on bf16 or f32 rounding),
    the flips are counted and the plain path is scored again on the
    served routing, as it is on the served tokens; without flips a
    failure stands."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe

    plain_cfg = dataclasses.replace(cfg, attn_impl="naive")
    forced = torch.from_numpy(run.tokens).to(params["embed"]["tok"].device)

    def plain_run(routing=None):
        prompt, rng = prompt_fn()
        with moe.tap_routing(forced=routing) as ptap:
            out = generate(plain_cfg, params, prompt, gen, rng=rng,
                           keep_logits=True, forced=forced)
        return out, ptap

    plain, ptap = plain_run()
    flips = _routing_flips(tap, ptap) if tap.expert_ids else 0
    try:
        rec = check(run, plain)
    except AssertionError as e:
        if not flips:
            raise
        log(f"{what}: {flips} tokens' experts flipped between the paths "
            f"({e}); the plain path scored again on the served routing")
        plain, _ = plain_run(tap.expert_ids)
        rec = check(run, plain)
    rec["routing_flips"] = flips
    rec["plain_prefill_s"] = plain.prefill_s
    rec["plain_decode_s"] = plain.decode_s
    return rec


def _f32_check(what, pair="chunked equals naive"):
    """``check`` for :func:`_scored`: every step at rtol = atol =
    ``F32_RTOL`` and the same greedy tokens."""
    import torch

    def check(run, plain):
        worst = 0.0
        for step, (s_lg, p_lg) in enumerate(zip(run.logits, plain.logits)):
            if not bool(torch.isclose(s_lg, p_lg, rtol=F32_RTOL,
                                      atol=F32_ATOL).all()):
                raise AssertionError(f"{what}: step {step} beyond "
                                     f"rtol=atol={F32_RTOL}")
            worst = max(worst, float((s_lg - p_lg).abs().max()))
        if not np.array_equal(run.tokens, plain.tokens):
            raise AssertionError(f"{what}: greedy tokens differ")
        log(f"{what}: {pair} within rtol=atol={F32_RTOL} at all "
            f"{len(run.logits)} steps (max gap {worst:.3e}), same tokens")
        return {"max_gap": worst}
    return check


def _family_model(dev, arch, depth, b, prompt_len, gen, dtype=None,
                  seed=SEED):
    """``(cfg, params, prompt_fn)``: the published config (cut to
    ``depth`` layers, in ``dtype``) with ``attn_impl="chunked"``, its
    random parameters on ``dev`` and a function giving the same prompt
    and embedding generator anew."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompt
    from repro_torch.models import init_model

    cfg = dataclasses.replace(_cut(get_config(arch), depth),
                              attn_impl="chunked",
                              dtype=dtype or get_config(arch).dtype)
    params = init_model(cfg, seed, device=dev)
    return cfg, params, lambda: make_prompt(cfg, b, prompt_len, seed, dev)


def _held_tensors(top=6) -> str:
    """The largest CUDA tensors still referenced, with what refers to
    them (two levels of ``gc.get_referrers``)."""
    import gc
    import warnings

    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        found = [o for o in gc.get_objects()
                 if isinstance(o, torch.Tensor) and o.is_cuda]
    found.sort(key=lambda t: -t.untyped_storage().nbytes())
    seen, out = set(), []
    for t in found:
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen or len(out) == top:
            continue
        seen.add(ptr)
        chain = []
        for r in gc.get_referrers(t)[:3]:
            if r is found:
                continue
            up = [type(u).__name__ for u in gc.get_referrers(r)[:3]
                  if u is not found]
            chain.append(f"{type(r).__name__}<-{'/'.join(up)}")
        out.append(f"{tuple(t.shape)} {t.dtype} "
                   f"{t.untyped_storage().nbytes() / 2 ** 30:.3f} GiB "
                   f"held by {', '.join(chain)}")
    del found
    return f"{len(out)} largest: " + "; ".join(out)


def ssm_recurrence_gate(dev) -> dict:
    """``SSM_GATE``'s model at full width and depth, in f32 and bf16:
    the served run (prefill, then decode steps fed the served tokens)
    against ``forward`` over the prompt, the served tokens and filler to
    one more chunk. The model is causal, so forward's logits at the
    prompt's last position and at each served token are the served
    steps'. The served-vs-plain check cannot see the recurrence: for an
    attention-free model both paths run the same code."""
    import types

    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward

    arch, b, prompt_len, gen = SSM_GATE
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg, params, prompt_fn = _family_model(dev, arch, None, b,
                                               prompt_len, gen, dtype=dtype,
                                               seed=SEED + 2)
        n = prompt_len + cfg.ssm.chunk
        if prompt_len % cfg.ssm.chunk or gen > cfg.ssm.chunk:
            raise ValueError(f"SSM_GATE {SSM_GATE} does not fit the chunk")
        prompt, rng = prompt_fn()
        run = generate(cfg, params, prompt, gen, rng=rng, keep_logits=True)
        served = torch.from_numpy(run.tokens).to(dev)
        filler = torch.zeros((b, n - prompt_len - gen), dtype=torch.int32,
                             device=dev)
        seq = torch.cat([prompt["tokens"], served, filler], dim=1)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = forward(cfg, params, {"tokens": seq}, remat=False)
        at = logits[:, prompt_len - 1:prompt_len - 1 + gen]
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        chunked = types.SimpleNamespace(
            logits=list(at.unbind(1)), tokens=at.argmax(-1).cpu().numpy())
        what = f"ssm recurrence {arch} {dtype} ({n}-token forward)"
        pair = "prefill + decode equals the chunked forward"
        if dtype == "float32":
            rec = _f32_check(what, pair)(run, chunked)
        else:
            rec = _logit_checks(run, chunked, SERVE_LOGIT_TOL, what)
        rec.update(forward_s=forward_s, prefill_s=run.prefill_s,
                   decode_s=run.decode_s)
        out[dtype] = rec
        del params, run, logits, at, chunked, prompt, rng, prompt_fn
        torch.cuda.empty_cache()
    return out


def families_path(dev) -> dict:
    """Phase 11: serve each of ``FAMILIES`` through ``launch.serve``'s
    ``generate`` with the flash kernels (counts from 0 around the served
    run), score it with the plain path, and run the f32 checks of
    ``FAMILIES_F32``. Returns the launches and the records."""
    import gc

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    log(f"families: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
        "held from earlier phases at the start; " + _held_tensors())
    launches = {"flash_attention": 0, "flash_decode": 0}
    out = {}
    for arch, depth, b, prompt_len, gen in FAMILIES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, params, prompt_fn = _family_model(dev, arch, depth, b,
                                               prompt_len, gen)
        n_params = sum(t.numel() for t in leaves(params))
        prompt, rng = prompt_fn()
        generate(cfg, params, prompt, 2, rng=rng)     # warm-up, not counted
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0

        prompt, rng = prompt_fn()
        fa.reset_launches()
        with moe.tap_routing() as tap:
            run = generate(cfg, params, prompt, gen, rng=rng,
                           keep_logits=True)
        got, routes = dict(fa.launches), dict(fa.routes)
        _check_family_launches(arch, cfg, gen, got, routes)
        for k in launches:
            launches[k] += got[k]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if run.tokens.shape != (b, gen) or not (
                (run.tokens >= 0) & (run.tokens < cfg.vocab)).all():
            raise AssertionError(f"families {arch}: bad tokens {run.tokens}")
        n_moe = sum(spec.mlp == "moe" for spec in cfg.default_layout())
        drops = [int(d) for d in tap.drops]
        rec = {"layers": cfg.n_layers, "params": n_params,
               "param_counts": cfg.param_counts()[0],
               "made_s": made_s, "prefill_s": run.prefill_s,
               "decode_s": run.decode_s,
               "decode_tok_per_s": b * (gen - 1) / run.decode_s,
               "peak_gib": peak, "launches": got, "routes": routes,
               "moe_dropped_prefill": sum(drops[:n_moe]),
               "moe_dropped_decode": sum(drops[n_moe:]),
               "moe_pairs_prefill": (b * prompt_len * n_moe * cfg.moe.top_k
                                     if cfg.moe else 0),
               "moe_pairs_decode": (b * (gen - 1) * n_moe * cfg.moe.top_k
                                    if cfg.moe else 0)}
        log(f"families {arch} (bf16, chunked, card): layers={cfg.n_layers} "
            f"params={n_params} (param_counts {rec['param_counts']}) "
            f"batch={b} prompt={prompt_len} gen={gen} "
            f"made_s={made_s:.3f} prefill_s={run.prefill_s:.4f} "
            f"decode_tok_per_s={rec['decode_tok_per_s']:.2f} "
            f"peak_gib={peak:.3f} launches={got} routes={routes} "
            f"moe_dropped_prefill={rec['moe_dropped_prefill']}"
            f"/{rec['moe_pairs_prefill']} "
            f"moe_dropped_decode={rec['moe_dropped_decode']}"
            f"/{rec['moe_pairs_decode']}; req 0: {run.tokens[0].tolist()}")
        what = f"families {arch} chunked vs naive"
        rec.update(_scored(what, cfg, params, prompt_fn, gen, run, tap,
                           lambda r, p, what=what: _logit_checks(
                               r, p, SERVE_LOGIT_TOL, what)))
        rec["plain_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"families {arch} (naive, card, teacher-forced): "
            f"prefill_s={rec['plain_prefill_s']:.4f} "
            f"decode_s={rec['plain_decode_s']:.4f} "
            f"routing_flips={rec['routing_flips']} "
            f"peak_gib={rec['plain_peak_gib']:.3f}")
        out[arch] = rec
        del params, run, tap, prompt, rng, prompt_fn
        gc.collect()
        torch.cuda.empty_cache()

    for arch, depth, b, prompt_len, gen in FAMILIES_F32:
        cfg, params, prompt_fn = _family_model(dev, arch, depth, b,
                                               prompt_len, gen,
                                               dtype="float32",
                                               seed=SEED + 1)
        prompt, rng = prompt_fn()
        with moe.tap_routing() as tap:
            run = generate(cfg, params, prompt, gen, rng=rng,
                           keep_logits=True)
        what = f"families {arch} f32 layers {depth}"
        out[f"{arch}_f32"] = _scored(what, cfg, params, prompt_fn, gen, run,
                                     tap, _f32_check(what))
        del params, run, tap, prompt, rng, prompt_fn
        gc.collect()
        torch.cuda.empty_cache()
    out["ssm_recurrence"] = ssm_recurrence_gate(dev)
    return {"launches": launches, "timings": out}


# ---------------------------------------------------------------------------
# 12. The mesh
# ---------------------------------------------------------------------------

def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _mesh_params(cfg, params, mesh, serve):
    from repro_torch.dist import distribute, make_rules, param_pspecs
    from repro_torch.models.transformer import logical_specs
    rules = make_rules(mesh, serve=serve)
    return distribute(params, param_pspecs(params, logical_specs(cfg),
                                           rules), mesh), rules


def mesh_serve(mesh, dev) -> dict:
    """SERVE[0] through ``generate`` on ``DTensor`` parameters with the
    hints installed: the flash launches counted from 0 (every prefill on
    the tensor cores), the greedy tokens and every step's logits against
    the unsharded run, then decode rates of both in turns."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate, make_prompt
    from repro_torch.models import init_model
    from repro_torch.models.hints import activation_rules, default_rules

    arch, b, prompt_len, gen = SERVE[0]
    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked")
    params = init_model(cfg, SEED, device=dev)
    prompt, _ = make_prompt(cfg, b, prompt_len, SEED, dev)
    generate(cfg, params, prompt, 2)              # warm-up, not counted
    plain = generate(cfg, params, prompt, gen, keep_logits=True)
    dparams, rules = _mesh_params(cfg, params, mesh, serve=True)

    def on_mesh():
        return activation_rules(mesh, default_rules(False, serve=True))

    with on_mesh() as fallbacks:
        generate(cfg, dparams, prompt, 2)         # warm-up, not counted
        fa.reset_launches()
        run = generate(cfg, dparams, prompt, gen, keep_logits=True)
        got, routes = dict(fa.launches), dict(fa.routes)
    L = cfg.n_layers
    want = {"flash_attention": L, "flash_decode": L * (gen - 1)}
    if got != want or routes != {"flash_attention_tc": L,
                                 "flash_attention_simt": 0}:
        raise AssertionError(f"mesh serve {arch}: launches {got} routes "
                             f"{routes}, expected {want}, all on the "
                             "tensor cores")
    if not np.array_equal(run.tokens, plain.tokens):
        raise AssertionError(f"mesh serve {arch}: greedy tokens differ from "
                             "the unsharded run")
    worst, bit_equal = 0.0, True
    for step, (m_lg, p_lg) in enumerate(zip(run.logits, plain.logits)):
        gap = float((m_lg - p_lg).abs().max())
        tol = SERVE_LOGIT_TOL * float(p_lg.abs().max())
        if not gap <= tol:
            raise AssertionError(f"mesh serve {arch}: step {step} logits "
                                 f"differ by {gap} > {tol}")
        worst = max(worst, gap)
        bit_equal &= bool(torch.equal(m_lg, p_lg))
    rates = {"plain": [], "mesh": []}
    for _ in range(MESH_TURNS):
        for which in ("plain", "mesh", "mesh", "plain"):
            if which == "mesh":
                with on_mesh():
                    r = generate(cfg, dparams, prompt, gen)
            else:
                r = generate(cfg, params, prompt, gen)
            rates[which].append(b * (gen - 1) / r.decode_s)
    rec = {"launches": got, "routes": routes, "max_logit_gap": worst,
           "bit_equal": bit_equal, "fallbacks": list(fallbacks),
           "sharding_fallbacks": rules.fallbacks,
           "decode_tok_per_s": {k: float(np.median(v))
                                for k, v in rates.items()},
           "decode_tok_per_s_runs": rates}
    log(f"mesh serve {arch} (1x1 mesh, DTensor params, chunked, card): "
        f"batch={b} prompt={prompt_len} gen={gen} launches={got} "
        f"routes={routes}; tokens equal the unsharded run's, max logit gap "
        f"{worst:.3e} (bit-equal: {bit_equal}); decode tok/s median of "
        f"{2 * MESH_TURNS} in turns: mesh "
        f"{rec['decode_tok_per_s']['mesh']:.1f} against unsharded "
        f"{rec['decode_tok_per_s']['plain']:.1f} (runs {rates}); layout "
        f"fallbacks {rec['fallbacks']}")
    return rec


def mesh_moe(mesh, dev) -> dict:
    """MESH_MOE in f32: a prefill with ``moe_impl="local"`` on the mesh
    against the global path without one; expert ids and drops bit-exact,
    the logits within MESH_MOE_TOL, the local path's fallbacks 0."""
    import dataclasses
    import gc

    import torch
    from repro_torch.models import moe, prefill
    from repro_torch.models.hints import activation_rules, default_rules

    arch, depth, b, prompt_len = MESH_MOE
    cfg, params, prompt_fn = _family_model(dev, arch, depth, b, prompt_len,
                                           2, dtype="float32")
    prompt, _ = prompt_fn()
    with torch.no_grad(), moe.tap_routing() as tg:
        want, _ = prefill(cfg, params, prompt, max_len=prompt_len + 2)
    dparams, _ = _mesh_params(cfg, params, mesh, serve=True)
    del params
    gc.collect()
    before = dict(moe.local_fallbacks)
    local = dataclasses.replace(cfg, moe_impl="local")
    with torch.no_grad(), activation_rules(
            mesh, default_rules(False, serve=True)), \
            moe.tap_routing() as tl:
        got, _ = prefill(local, dparams, prompt, max_len=prompt_len + 2)
    got = _whole(got)
    fallbacks = {k: moe.local_fallbacks[k] - before[k] for k in before}
    if len(tl.expert_ids) != len(tg.expert_ids) or not all(
            torch.equal(a, b) for a, b in zip(tl.expert_ids, tg.expert_ids)):
        raise AssertionError(f"mesh moe {arch}: expert ids differ")
    drops = [int(d) for d in tl.drops]
    if drops != [int(d) for d in tg.drops]:
        raise AssertionError(f"mesh moe {arch}: drops {drops} differ from "
                             f"{[int(d) for d in tg.drops]}")
    if any(fallbacks.values()):
        raise AssertionError(f"mesh moe {arch}: local path fell back "
                             f"{fallbacks}")
    if not bool(torch.isclose(got, want, rtol=MESH_MOE_TOL,
                              atol=MESH_MOE_TOL).all()):
        raise AssertionError(f"mesh moe {arch}: logits beyond "
                             f"rtol=atol={MESH_MOE_TOL}")
    gap = float((got - want).abs().max())
    log(f"mesh moe {arch} (f32, {depth} layers, 1x1 mesh, local vs "
        f"global): {len(tl.expert_ids)} routings bit-exact, drops {drops}, "
        f"logits max gap {gap:.3e} (rtol=atol={MESH_MOE_TOL}), local-path "
        f"fallbacks {fallbacks}")
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_gap": gap, "drops": drops, "fallbacks": fallbacks}


def mesh_train(mesh, dev) -> dict:
    """MESH_TRAIN_STEPS steps of ``launch.train``'s sync run (TRAIN_ARGS'
    model, batch and lr) unsharded, then the same steps on ``DTensor``
    parameters, optimizer state and batches of the mesh; under
    ``torch.use_deterministic_algorithms`` the first loss must agree
    within MESH_TRAIN_RTOL_FIRST and the later ones within
    MESH_TRAIN_RTOL (the mesh's loss is the vocab-parallel one: its
    normaliser, mean and their gradients sum in another order than the
    plain loss's)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.dist import (batch_pspecs, distribute, make_rules,
                                  param_pspecs)
    from repro_torch.launch import train
    from repro_torch.models.hints import activation_rules, default_rules
    from repro_torch.models.transformer import logical_specs
    from repro_torch.optim import (AdamWConfig, init_opt_state,
                                   opt_state_pspecs)
    from repro_torch.runtime import TrainConfig, make_train_step

    argv = list(TRAIN_ARGS)
    argv[argv.index("--steps") + 1] = str(MESH_TRAIN_STEPS)
    args = train.parse_args(argv)
    cfg = get_config(args.arch)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        plain = train.run_sync(args)
        plain_s = time.perf_counter() - t0
        plain_losses = plain["losses"]
        del plain
        gc.collect()
        stream = SyntheticLMStream(vocab=cfg.vocab, seq=args.seq,
                                   batch=args.batch, seed=args.seed)
        params = train._init(cfg, args.seed, torch.device(dev))
        rules = make_rules(mesh)
        pspecs = param_pspecs(params, logical_specs(cfg), rules)
        dopt = distribute(init_opt_state(params), opt_state_pspecs(pspecs),
                          mesh)
        dparams = distribute(params, pspecs, mesh)
        del params
        step_fn = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
            lr=args.lr, warmup_steps=max(10, args.steps // 20),
            total_steps=args.steps)))
        losses = []
        t0 = time.perf_counter()
        with activation_rules(mesh, default_rules(False)):
            for step in range(args.steps):
                batch = train._batch(stream, step, dev)
                dbatch = distribute(batch, batch_pspecs(batch, rules), mesh)
                dparams, dopt, m = step_fn(dparams, dopt, dbatch)
                losses.append(float(_whole(m["loss"])))
        mesh_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    rtols = [MESH_TRAIN_RTOL_FIRST] + [MESH_TRAIN_RTOL] * (len(gaps) - 1)
    if len(losses) != len(plain_losses) or any(
            g > t for g, t in zip(gaps, rtols)):
        raise AssertionError(f"mesh train: losses {losses} differ from the "
                             f"unsharded run's {plain_losses} (relative "
                             f"gaps {gaps}, rtols {rtols})")
    log(f"mesh train {args.arch} ({args.steps} steps, batch {args.batch} x "
        f"{args.seq}, 1x1 mesh): losses {losses} against the unsharded "
        f"launch.train run's {plain_losses} (relative gaps "
        + ", ".join(f"{g:.3e}" for g in gaps)
        + f"; rtols {rtols}); {mesh_s:.3f} s on the mesh, {plain_s:.3f} s "
        f"unsharded (with its set-up)")
    del dparams, dopt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "plain_losses": plain_losses,
            "rel_gaps": gaps, "mesh_s": mesh_s, "plain_s": plain_s}


def mesh_dryrun() -> dict:
    """The dry-run CLI's production cell in a subprocess (a fake group of
    256 ranks on ``meta`` tensors: no card); its roofline line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *DRYRUN_ARGS], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=DRYRUN_TIMEOUT)
    wall = time.perf_counter() - t0
    line = next((x for x in r.stdout.splitlines()
                 if x.startswith("[ ok ]")), None)
    if r.returncode != 0 or line is None:
        raise AssertionError(f"dry-run failed ({r.returncode}): "
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    art = json.loads((ROOT / "build" / "dryrun" /
                      "qwen2-1.5b_train_4k_16x16.json").read_text())
    log(f"mesh dry-run ({wall:.1f} s): {line}")
    return {"wall_s": wall, "line": line, "roofline": art["roofline"],
            "cost_analysis": art["cost_analysis"],
            "collective_wire_bytes_per_chip":
                art["collective_wire_bytes_per_chip"],
            "layout_fallbacks": art["layout_fallbacks"]}


def mesh_path(dev) -> dict:
    """Phase 12: a one-rank group (NCCL on the card, gloo on the CPU;
    free-port rendezvous) and ``launch.mesh.make_host_mesh``; serve, MoE
    and train on it, the group destroyed after; then the dry-run.
    Returns the serve launches and the records."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    if dev == "cuda":
        log(f"mesh phase on {card_line()}")
    port = _free_ports(1, socket.SOCK_STREAM)[0]
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(dev)
        out = {"serve": mesh_serve(mesh, dev), "moe": mesh_moe(mesh, dev),
               "train": mesh_train(mesh, dev)}
    finally:
        dist.destroy_process_group()
    out["dryrun"] = mesh_dryrun()
    out["wall_s"] = time.perf_counter() - t0
    log(f"mesh phase: {out['wall_s']:.1f} s"
        + (f" on {card_line()}" if dev == "cuda" else ""))
    return {"launches": out["serve"]["launches"], "timings": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # cuBLAS reproducible under torch.use_deterministic_algorithms (the
    # train phase), set before the first cuBLAS handle exists
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.kernels import delta_join as dj

    # full f32 products for every plain version held against a kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    log(card)
    build()
    parity = kernel_parity(torch.device(dev))
    parity.update(flash_parity(torch.device(dev)))

    tensors = qwen_tensors()
    dj.reset_launches()
    t0 = time.perf_counter()
    reps, replay, timings = main_path(dev, tensors)
    a, b = reps[0].store, reps[1].store
    joined = a.join(b)                  # state-based full-state merge
    torch.cuda.synchronize()
    launches = dict(dj.launches)
    log(f"store path: {time.perf_counter() - t0:.3f} s, "
        f"launches={launches}")
    for rep in reps:
        check_against_replay(rep.store, replay, dev, f"replica {rep.id}")
    check_against_replay(joined, replay, dev, "a ⊔ b")
    log("replicas equal each other and the numpy replay")

    ingest_scaling(a, [n for n, _ in tensors], dev)
    topk_check(a, dev)
    # the loop's last replica reaches the simulator and with it all
    # three stores (5.2 GiB): drop it with the others
    del reps, rep, a, b, joined
    torch.cuda.empty_cache()

    net = net_store_path(dev, tensors)
    for name, n in net["launches"].items():
        launches[name] += n
        if not n:
            raise AssertionError(f"{name} never launched on the net store "
                                 "path")
    timings["net_store"] = {k: net[k] for k in ("wall_s", "rounds",
                                                 "largest_frame")}
    torch.cuda.empty_cache()
    timings["net_sessions"] = net_sessions_path(dev)

    timings["dots"] = dots_path(dev)

    served = serve_path(dev)
    launches.update(served["launches"])
    timings["serve"] = served["timings"]
    torch.cuda.empty_cache()

    timings["train"] = train_path(dev)
    launches["delta_join"] += timings["train"]["delta_join_launches"]
    timings["train_delta"] = delta_path()
    timings["topk"] = topk_path(dev)

    families = families_path(dev)
    for name, n in families["launches"].items():
        launches[name] += n
    timings["families"] = families["timings"]

    mesh = mesh_path(dev)
    for name, n in mesh["launches"].items():
        launches[name] += n
    timings["mesh"] = mesh["timings"]
    missing = [k for k in TPU_KERNEL if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")

    kernels = [{
        "name": name, "route": "cuda",
        "source": FLASH_SOURCE if name.startswith("flash") else SOURCE,
        "replaces": TPU_KERNEL[name], "launches": launches[name],
        "max_abs_err": parity[name]["max_abs_err"],
        "ms": parity[name]["ms"], "plain_ms": parity[name]["plain_ms"],
        "bound_ms": parity[name]["bound_ms"],
        "bound_by": parity[name].get("bound_by", "bytes"),
        "library_ms": parity[name].get("library_ms")} for name in TPU_KERNEL]
    log(json.dumps({"timings": timings}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
