"""End-to-end training entry point, on the card unless ``--device cpu``.

Two modes (DESIGN.md §2):

* ``--mode sync``  — single-replica training with delta-interval
  checkpointing: snapshot every ``--snap-every`` checkpoints, idempotent
  delta appends in between; crash at any point → restore = snapshot ⊔
  deltas (Algorithm 2's durable-state discipline on disk), joined by the
  ``delta_join`` kernel on the card.

* ``--mode delta`` — the paper's contribution end-to-end: ``--pods N``
  δ-CRDT replicas train local steps and gossip uniquely-dotted
  pseudo-gradient deltas over a lossy simulated network (loss/dup/reorder
  configurable); convergence is Prop. 1, not exactly-once delivery.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 20 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --mode delta --steps 4 --local-steps 2 --topk 0.1

The flags and printed lines are the JAX package's, plus ``--device``.
``run_sync`` and ``run_delta`` also return what they did (per-step losses
and seconds, the states they checkpointed and restored) for callers that
measure them.
"""

from __future__ import annotations

import argparse
import random
import time
from typing import List, Optional

import torch

from ..checkpoint import (DeltaCheckpointStore, pytree_from_state,
                          pytree_spec, state_from_pytree)
from ..configs import ARCH_IDS, get_config
from ..core import (NetConfig, POLICY_SPECS, Simulator, causal_policy_spec,
                    converged, make_policy, run_to_convergence)
from ..data import SyntheticLMStream
from ..models import init_model
from ..optim import AdamWConfig, init_opt_state
from ..runtime import TrainConfig, make_train_step
from ..sync import DeltaSyncPod, TopKCompressor


def _init(cfg, seed, device):
    return init_model(cfg, seed, device=device)


def _batch(stream, step, device, rank=0):
    return {k: torch.from_numpy(v).to(device)
            for k, v in stream.batch_at(step, rank=rank).items()}


def run_sync(args) -> dict:
    dev = torch.device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    stream = SyntheticLMStream(vocab=cfg.vocab, seq=args.seq,
                               batch=args.batch, seed=args.seed)
    params = _init(cfg, args.seed, dev)
    opt_state = init_opt_state(params)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=args.lr, warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps))
    step_fn = make_train_step(cfg, tcfg)
    rec = {"start_step": 0, "restored": None, "restore_s": None,
           "last_checkpoint": None, "ckpt_s": [], "losses": [],
           "step_s": []}

    store = DeltaCheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if store is not None and store.seq >= 0:
        t_restore = time.perf_counter()
        state, seq = store.restore(device=dev)
        if state.chunks:
            spec = pytree_spec({"params": params, "opt": opt_state})
            del params, opt_state
            restored = pytree_from_state(state, spec)
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(opt_state["step"])
            rec.update(restored=state, start_step=start_step,
                       restore_s=time.perf_counter() - t_restore)
            print(f"[restore] resumed at step {start_step} (ckpt seq {seq})")

    t0 = time.time()
    ck_seq = store.seq if store is not None else -1
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = _batch(stream, step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        rec["losses"].append(loss)
        rec["step_s"].append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if store is not None and (step + 1) % args.ckpt_every == 0:
            t_ck = time.perf_counter()
            full, _spec = state_from_pytree(
                {"params": params, "opt": opt_state}, args.chunk, rank=0,
                lamport=step + 1)
            ck_seq += 1
            if ck_seq % args.snap_every == 0:
                store.save_snapshot(full, seq=ck_seq)
            else:
                store.append_delta(full, seq=ck_seq)  # idempotent join on restore
            store.gc(keep_snapshots=2)
            rec["last_checkpoint"] = full
            rec["ckpt_s"].append(time.perf_counter() - t_ck)
    print(f"[done] {args.steps} steps in {time.time() - t0:.1f}s")
    rec.update(params=params, opt_state=opt_state)
    return rec


def run_delta(args) -> dict:
    dev = torch.device(args.device)
    cfg = get_config(args.arch, reduced=True)  # delta demo is smoke-scale
    stream = SyntheticLMStream(vocab=cfg.vocab, seq=args.seq,
                               batch=args.batch, seed=args.seed)
    init_params = _init(cfg, args.seed, dev)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr,
                                             warmup_steps=5,
                                             total_steps=args.steps))
    step_fn = make_train_step(cfg, tcfg)

    def local_update(params, round_idx, pod_id):
        # K local steps on this pod's data shard (fresh opt state per round
        # — pseudo-gradient outer loop)
        opt = init_opt_state(params)
        rank = int(pod_id.split("pod")[-1])
        p = params
        for k in range(args.local_steps):
            b = _batch(stream, round_idx * args.local_steps + k, dev, rank)
            p, opt, m = step_fn(p, opt, b)
        print(f"  [{pod_id}] round {round_idx} loss "
              f"{float(m['loss']):.4f}", flush=True)
        return p

    sim = Simulator(NetConfig(loss=args.net_loss, dup=0.1, seed=args.seed))
    ids = [f"pod{k}" for k in range(args.pods)]
    policy_spec = getattr(args, "ship_policy", "all")
    pods = [sim.add_node(DeltaSyncPod(
        i, [j for j in ids if j != i], init_params, local_update,
        num_pods=args.pods,
        compressor=(TopKCompressor(args.topk) if args.topk else None),
        rng=random.Random(args.seed + n),
        policy=make_policy(policy_spec)))
        for n, i in enumerate(ids)]

    rounds = max(1, args.steps // args.local_steps)
    for r in range(rounds):
        for p in pods:
            p.do_round()
        sim.run_for(5.0)  # anti-entropy gossip between rounds
    run_to_convergence(sim, pods, interval=1.0, max_time=50_000)
    assert converged(pods), "pods failed to converge"
    payload = sim.stats.payload_atoms()
    print(f"[done] {rounds} rounds × {args.local_steps} local steps on "
          f"{args.pods} pods over a lossy network (loss={args.net_loss}, "
          f"ship-policy={policy_spec}, payload_atoms={payload}); "
          f"all pods converged to identical outer params "
          f"({len(pods[0].X.dots)} dots merged)")
    return {"pods": pods, "rounds": rounds, "payload_atoms": payload,
            "dots": len(pods[0].X.dots)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--mode", default="sync", choices=["sync", "delta"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    # checkpointing
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--snap-every", type=int, default=5,
                    help="every Nth checkpoint is a full snapshot")
    ap.add_argument("--chunk", type=int, default=65536)
    # delta mode
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--net-loss", type=float, default=0.2)
    ap.add_argument("--topk", type=float, default=None,
                    help="top-k compression rate (e.g. 0.1)")

    def _policy_spec(s):
        try:             # fail at arg parsing, not after N training steps
            return causal_policy_spec(s, "delta-mode gossip")
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e))

    ap.add_argument("--ship-policy", default="all", type=_policy_spec,
                    help="delta-mode gossip shipping policy "
                         f"(e.g. {', '.join(POLICY_SPECS)})")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.mode == "sync":
        run_sync(args)
    else:
        run_delta(args)


if __name__ == "__main__":
    main()
