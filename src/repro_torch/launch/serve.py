"""Serving entry point of the port: batched prefill → greedy decode over ring
KV caches, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on the card

The CLI, the prompt construction from ``--seed`` (numpy
``default_rng``) and the printout are the JAX package's
``launch/serve.py``. Parameters are random, made from ``--seed``. Beyond
it: ``--device``; ``--attn-impl`` (``chunked``, the default, serves
attention through the hand-written flash kernels on the card;
``naive`` through plain products); ``--full`` serves the published
``CONFIG`` instead of the ``REDUCED`` one that the JAX package's
serve.py always takes.

``--replicate N`` then replicates the batch's session table as an
``ORMap(request → MVRegister status)`` over N causal gateway replicas on
a lossy simulated network (25% loss, 10% duplication), under
``--ship-policy`` and through the binary wire codec (``--no-wire``:
Python objects), as the JAX package's serve.py does; the causal joins'
containment mask runs on ``--device``.

Not ported yet: keyed sessions (``--sessions``; it needs the key
ownership of ``repro.sync`` and the lifecycle reaper, slice C) and socket
mode (``--listen``/``--peers``; ``repro_torch.net``, slice C). Those
options exit with an error naming the slice; the options that only shape
them are accepted, as the JAX package's serve.py accepts them.

:func:`make_prompt`, :func:`generate` and :func:`replicate_sessions` are
the parts ``chip_smoke.py`` drives at full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import (MVRegister, NetConfig, ORMap, POLICY_SPECS, Replica,
                    Simulator, causal_policy_spec, make_policy,
                    run_to_convergence)
from ..core.dotcols import mask_device
from ..models import decode_step, init_model, prefill
from ..models.config import ModelConfig
from ..models.transformer import compute_dtype


def make_prompt(cfg: ModelConfig, b: int, prompt_len: int, seed: int,
                device="cuda") -> Tuple[Dict[str, torch.Tensor],
                                        np.random.Generator]:
    """The prompt of the JAX package's serve.py from ``seed``: token ids
    (and, per input mode, embeddings) drawn from
    ``np.random.default_rng(seed)``. Returns
    the batch on ``device`` and the generator, which embeds-mode decode
    steps go on drawing from."""
    rng = np.random.default_rng(seed)
    dtype = compute_dtype(cfg)

    def embeds(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    def tokens(n):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (b, n)).astype(
            np.int32)).to(device)

    if cfg.input_mode == "embeds":
        return {"embeds": embeds((b, prompt_len, cfg.d_model))}, rng
    if cfg.input_mode == "tokens+prefix":
        tl = prompt_len - cfg.prefix_len
        if tl <= 0:
            raise ValueError("prompt shorter than the vision prefix")
        tok = tokens(tl)
        return {"tokens": tok,
                "prefix_embeds": embeds((b, cfg.prefix_len, cfg.d_model))}, rng
    return {"tokens": tokens(prompt_len)}, rng


@dataclasses.dataclass
class ServeRun:
    """What :func:`generate` returns."""
    tokens: np.ndarray                  # [b, gen] greedy tokens
    logits: List[torch.Tensor]          # per step [b, vocab] f32, if kept
    prefill_s: float                    # host clock, ends in a sync
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params: Dict, prompt: Dict[str, torch.Tensor],
             gen: int, *, rng: Optional[np.random.Generator] = None,
             forced: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> ServeRun:
    """Prefill ``prompt``, then ``gen - 1`` greedy decode steps: ``gen``
    tokens per request (the first from the prefill logits). ``forced``
    ([b, gen] tokens) feeds those tokens to the decode steps instead of
    the model's own (teacher forcing: the plain path scored on the
    served path's tokens). ``keep_logits`` keeps every step's logits."""
    first = next(iter(prompt.values()))
    b, device = first.shape[0], first.device
    prompt_len = sum(v.shape[1] for v in prompt.values())
    max_len = prompt_len + gen

    t0 = time.perf_counter()
    logits, caches = prefill(cfg, params, prompt, max_len=max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    generated = [tok]
    kept = [logits[:, -1]] if keep_logits else []
    t0 = time.perf_counter()
    for k in range(gen - 1):
        pos = torch.full((b, 1), prompt_len + k, dtype=torch.int32,
                         device=device)
        if cfg.input_mode == "embeds":
            step_in = torch.from_numpy(rng.normal(size=(b, 1, cfg.d_model))
                                       .astype(np.float32)).to(
                device=device, dtype=compute_dtype(cfg))
        elif forced is not None:
            step_in = forced[:, k:k + 1]
        else:
            step_in = tok
        logits, caches = decode_step(cfg, params, step_in, pos, caches)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        generated.append(tok)
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(device)
    decode_s = time.perf_counter() - t0
    return ServeRun(torch.cat(generated, dim=1).cpu().numpy(), kept,
                    prefill_s, decode_s)


def replicate_sessions(n_requests: int, n_gateways: int, policy: str,
                       seed: int, wire: bool = True, device="cuda"
                       ) -> Tuple[Dict[str, str], int]:
    """The session table of ``n_requests`` served requests as
    ``ORMap(request → MVRegister status)`` over ``n_gateways`` causal
    replicas under ``policy``, gossiped over a 25%-loss simulated network
    until they converge (the JAX package's ``_replicated_sessions``).
    Each request's owning gateway writes its statuses in order. Returns
    the converged table ``{request: status}`` and the payload traffic
    (frame bytes with ``wire``, else structural atoms)."""
    from ..wire import WireCodec
    codec = WireCodec() if wire else None
    sim = Simulator(NetConfig(loss=0.25, dup=0.1, seed=seed))
    ids = [f"gw{k}" for k in range(n_gateways)]
    with mask_device(device):
        nodes = [sim.add_node(Replica(
            i, ORMap.bottom(), [j for j in ids if j != i], causal=True,
            policy=make_policy(policy), rng=random.Random(seed + k),
            wire=codec)) for k, i in enumerate(ids)]
        for r in range(n_requests):
            gw = nodes[r % len(nodes)]   # each request owned by one gateway
            for status in ("queued", "prefilling", "decoding", "done"):
                # sequential writes per key: MVRegister holds one value
                gw.operation(lambda X, r=r, s=status, gw=gw: X.apply_delta(
                    gw.id, f"req{r}", MVRegister, "write_delta", s))
            sim.run_for(0.5)
        run_to_convergence(sim, nodes, interval=1.0)   # raises if not
    table = nodes[0].X
    statuses = {k: next(iter(table.get_value(k, MVRegister).read()))
                for k in sorted(table.keys())}
    return statuses, sim.stats.payload_atoms()


def _policy_spec(s: str) -> str:
    try:                 # fail at arg parsing, not after the model ran
        return causal_policy_spec(s, "the session-table gossip")
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _slice_error(flag: str, slice_: str, needs: str) -> str:
    return (f"{flag} is not ported yet: it needs {needs} (ROADMAP "
            f"{slice_}); run it with the JAX package's repro.launch.serve")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--attn-impl", default="chunked",
                    choices=("chunked", "naive"),
                    help="chunked: flash attention (the hand-written "
                         "kernels on the card, their plain tiled build "
                         "on the CPU); naive: plain products")
    ap.add_argument("--full", action="store_true",
                    help="serve the published CONFIG instead of REDUCED")
    ap.add_argument("--replicate", type=int, default=0,
                    help="N gateway replicas for the δ-CRDT session table")
    ap.add_argument("--ship-policy", default="bp+rr", type=_policy_spec,
                    help="shipping policy for --replicate gossip (e.g. "
                         f"{', '.join(POLICY_SPECS)}, bp+rr+digest-sync:8)")
    ap.add_argument("--no-wire", dest="wire", action="store_false",
                    help="gossip Python objects instead of binary frames")
    gossip = ap.add_argument_group(
        "keyed sessions and socket mode (not ported yet: slice C)")
    gossip.add_argument("--sessions", type=int, default=0)
    gossip.add_argument("--listen", default=None)
    gossip.add_argument("--peers", default=None)
    gossip.add_argument("--session-replication", type=int, default=2)
    gossip.add_argument("--session-ttl", type=float, default=None)
    gossip.add_argument("--transport", default="udp", choices=("udp", "tcp"))
    gossip.add_argument("--udp-loss", type=float, default=0.0)
    gossip.add_argument("--tick", type=float, default=0.1)
    gossip.add_argument("--run-for", type=float, default=45.0)
    gossip.add_argument("--status-file", default=None)
    gossip.add_argument("--metrics", action="store_true")
    args = ap.parse_args(argv)

    if args.listen or args.peers:
        ap.error(_slice_error("socket mode (--listen/--peers)", "slice C",
                              "the port of repro.net"))
    if args.sessions:
        ap.error(_slice_error("--sessions", "slice C", "the key ownership "
                              "of repro.sync and the lifecycle reaper"))
    try:
        cfg = get_config(args.arch, reduced=not args.full)
    except NotImplementedError as e:
        ap.error(str(e))
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)

    device = torch.device(args.device)
    params = init_model(cfg, args.seed, device=device)
    prompt, rng = make_prompt(cfg, args.batch, args.prompt_len, args.seed,
                              device)
    run = generate(cfg, params, prompt, args.gen, rng=rng)
    b = args.batch
    toks = b * (args.gen - 1)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(f"[serve] arch={cfg.name} batch={b} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"  prefill: {run.prefill_s:.2f}s   decode: {run.decode_s:.2f}s "
          f"({toks / max(run.decode_s, 1e-9):.1f} tok/s on {where}, "
          f"attn_impl={cfg.attn_impl})")
    print(f"  sample continuation (req 0): "
          f"{[int(t) for t in run.tokens[0, :8]]}")
    if args.replicate:
        statuses, payload = replicate_sessions(
            b, args.replicate, args.ship_policy, args.seed, args.wire,
            device)
        unit = "frame_bytes" if args.wire else "payload_atoms"
        print(f"  [δ-CRDT] session table replicated over {args.replicate} "
              f"gateways (25% loss, policy={args.ship_policy}, "
              f"{unit}={payload}): {statuses}")
        if any(v != "done" for v in statuses.values()):
            raise RuntimeError(f"session statuses not all done: {statuses}")


if __name__ == "__main__":
    main()
