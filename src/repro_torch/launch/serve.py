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

``--sessions N`` puts N session objects in a keyed ``LatticeStore``
replicated across the gateways with rendezvous-hashed key ownership
(``KeyOwnership`` + ``ShardByKey``), and ``--session-ttl`` adds the key
lifecycle: the owner-driven reaper tombstones every expired session once
its whole replica set acks the expiry.

``--listen HOST:PORT --peers a,b,c`` leaves the simulator: this process
becomes one member of a real gossip cluster (``repro_torch.net``) over
UDP or TCP, writes its share of the ``--sessions`` keys, gossips until
``--run-for`` ends, and publishes JSON heartbeats to ``--status-file``.
Socket mode returns before any model is built.

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
from ..core import (Compose, MVRegister, NetConfig, ORMap, POLICY_SPECS,
                    Replica, Simulator, StoreReplica, causal_policy_spec,
                    make_policy, run_to_convergence)
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
                    help="shipping policy for --replicate/--sessions "
                         f"gossip (e.g. {', '.join(POLICY_SPECS)}, "
                         "bp+rr+digest-sync:8)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="N keyed session objects spread across the "
                         "gateways (LatticeStore + hash-sharded ownership; "
                         "implies 3 gateways unless --replicate is set)")
    ap.add_argument("--session-replication", type=int, default=2,
                    help="replicas per session key under --sessions")
    ap.add_argument("--session-ttl", type=float, default=None,
                    metavar="SECONDS",
                    help="key lifecycle for --sessions: every session "
                         "key expires SECONDS after its last write, and "
                         "the owner-driven reaper drops it to a tombstone "
                         "once the whole replica set acks the expiry "
                         "(sim time in the simulator, wall time in socket "
                         "mode)")
    ap.add_argument("--no-wire", dest="wire", action="store_false",
                    help="gossip Python objects instead of binary frames "
                         "(incompatible with socket mode)")
    ap.add_argument("--listen", metavar="[ID@]HOST:PORT[@ZONE]",
                    default=None,
                    help="socket mode: gossip over real sockets as one "
                         "member of an OS-process cluster "
                         "(repro_torch.net); requires --peers. An @ZONE "
                         "suffix places this member in a failure domain "
                         "and makes gossip hierarchical")
    ap.add_argument("--peers", metavar="[ID@]H:P[@ZONE],...", default=None,
                    help="socket mode: the other cluster members (zone "
                         "annotations must cover every member or none)")
    ap.add_argument("--transport", default="udp", choices=("udp", "tcp"),
                    help="socket-mode channel")
    ap.add_argument("--udp-loss", type=float, default=0.0,
                    help="socket mode, UDP only: injected datagram loss "
                         "probability on the send path")
    ap.add_argument("--tick", type=float, default=0.1,
                    help="socket-mode anti-entropy period, seconds")
    ap.add_argument("--run-for", type=float, default=45.0,
                    help="socket mode: exit after this many seconds")
    ap.add_argument("--status-file", default=None,
                    help="socket mode: publish a JSON heartbeat "
                         "(fingerprint, key count, byte counters) here")
    ap.add_argument("--metrics", action="store_true",
                    help="socket mode: export the observability registry "
                         "(repro_torch.obs) on a loopback HTTP sidecar "
                         "(Prometheus text at /metrics, JSON at "
                         "/metrics.json); --status-file heartbeats gain "
                         "the full snapshot")
    args = ap.parse_args(argv)

    if args.listen or args.peers:
        from ..net import validate_net_args
        try:
            spec = validate_net_args(
                args.listen, args.peers, transport=args.transport,
                wire=args.wire, udp_loss=args.udp_loss,
                session_ttl=args.session_ttl)
        except ValueError as e:
            ap.error(str(e))
        with mask_device(args.device):
            _socket_sessions(args, spec)
        return

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
    if args.sessions:
        with mask_device(device):
            _keyed_sessions(args)


def _wire_codec(args):
    """The binary frame codec gateways gossip through (None = objects)."""
    if not args.wire:
        return None
    from ..wire import WireCodec
    return WireCodec()


def _keyed_sessions(args) -> None:
    """N session objects in a keyed LatticeStore across gateways, with
    rendezvous-hash-sharded ownership: gossip ships each session only to
    the gateways that replicate it. Under ``--session-ttl`` each key
    also carries an expiry touched on every write, and the owner-driven
    reaper tombstones it once the whole replica set acks the expiry —
    the store shrinks again after the sessions complete. Prints the JAX
    package's lines."""
    from ..sync import KeyOwnership, ShardByKey

    wire = _wire_codec(args)
    n_gw = max(args.replicate, 2) if args.replicate else 3
    ids = [f"gw{k}" for k in range(n_gw)]
    ownership = KeyOwnership(ids, replication=min(args.session_replication,
                                                  n_gw))
    sim = Simulator(NetConfig(loss=0.25, dup=0.1, seed=args.seed))
    nodes = [sim.add_node(StoreReplica(
        i, [j for j in ids if j != i], causal=True,
        policy=Compose(make_policy(args.ship_policy), ShardByKey(ownership)),
        rng=random.Random(args.seed + k), ownership=ownership, wire=wire,
        ttl=args.session_ttl or None))    # 0 ⇒ lifecycle off, like unset
        for k, i in enumerate(ids)]

    # gossip runs concurrently with ingest: register the periodic
    # anti-entropy (and GC) ticks before the first write
    for n in nodes:
        if args.session_ttl:
            from ..lifecycle import ReaperProtocol
            ReaperProtocol(n, ownership, grace=1.0, retry=2.0)
        sim.every(1.0, n.on_periodic)
        sim.every(7.0, n.gc_deltas)

    for s in range(args.sessions):
        key = f"sess{s}"
        gw = nodes[s % len(nodes)]   # ingress gateway; may not own the key
        for status in ("queued", "prefilling", "decoding", "done"):
            gw.update(key, MVRegister, "write_delta", gw.id, status)
        if s % 8 == 7:
            sim.run_for(0.5)

    # then drive until every session's replica set agrees
    keys = [f"sess{s}" for s in range(args.sessions)]
    by_id = {n.id: n for n in nodes}

    def settled() -> bool:
        for key in keys:
            states = [by_id[w].get(key, MVRegister)
                      for w in ownership.owners(key)]
            if any(s != states[0] for s in states[1:]):
                return False
            if states[0].read() != frozenset({"done"}):
                return False
        return True

    t0 = sim.time
    while sim.time - t0 < 10_000:
        sim.run_for(2.0)
        if settled():
            break
    if not settled():
        raise RuntimeError("sharded session store failed to settle")

    payload = sim.stats.payload_atoms()
    per_gw = {i: len([k for k in keys if ownership.replicates(i, k)])
              for i in ids}
    unit = "frame_bytes" if wire is not None else "payload_atoms"
    print(f"  [δ-CRDT store] {args.sessions} sessions sharded over "
          f"{n_gw} gateways (replication={ownership.replication}, 25% loss, "
          f"policy={args.ship_policy}+shard"
          f"{', binary δ-wire frames' if wire is not None else ''}): "
          f"all owner replicas settled to 'done'")
    print(f"    keys per gateway: {per_gw}   {unit}={payload}")

    if args.session_ttl:
        # every session saw its last write above; run the clock past the
        # TTL and let the acked reaper drain the store back down

        def all_reaped() -> bool:
            tombs = {i: by_id[i].X.tombstoned_keys() for i in ids}
            return all(key in tombs[w]
                       for key in keys for w in ownership.owners(key))

        t0 = sim.time
        while sim.time - t0 < args.session_ttl + 10_000:
            sim.run_for(5.0)
            if all_reaped():
                break
        tombs = {i: by_id[i].X.tombstoned_keys() for i in ids}
        reaped = {i: sum(1 for key in keys if key in tombs[i])
                  for i in ids}
        resident = {i: len(by_id[i].X.entries) for i in ids}
        if not all_reaped():
            raise RuntimeError("sessions past their TTL were not reaped")
        print(f"  [lifecycle] ttl={args.session_ttl}s: all {args.sessions} "
              f"sessions expired and were reaped by their owners' ack "
              f"quorum; tombstones per gateway: {reaped}, resident "
              f"values left: {resident}")


def _session_fingerprint(replica, keys) -> str:
    """Semantic fingerprint of the session table: blake2b over the sorted
    ``(key, sorted read set)`` pairs. Representation-blind on purpose —
    a locally-written MVRegister and its wire-decoded columnar twin are
    semantically equal but structurally different objects, so hashing
    the read values is what lets N processes agree they converged."""
    import hashlib
    acc = hashlib.blake2b(digest_size=16)
    for key in sorted(keys):
        val = replica.get(key, MVRegister)
        reads = sorted(repr(v) for v in val.read()) if val is not None \
            else []
        acc.update(repr((key, reads)).encode("utf-8"))
    return acc.hexdigest()


def _socket_replica_factory(args, spec, topo):
    """The socket-mode replica factory: ``--ship-policy`` (composed with
    :class:`HierarchicalGossip` when the members carry zones), plus —
    under ``--session-ttl`` — full-replication key ownership and the
    acked reaper, so the tombstone quorum runs over real UDP/TCP.

    Ownership is the whole static cluster (replication = member count):
    every process derives the identical owner map from the same
    ``--peers`` list with no membership gossip, every replica holds every
    key, and a reap commits only once every member acked the expiry."""
    from ..core.hiergossip import HierarchicalGossip
    from ..core.propagation import stable_seed
    from ..wire import WireCodec

    ownership = None
    if spec.session_ttl:
        from ..sync import KeyOwnership
        ids = spec.cluster_ids
        ownership = KeyOwnership(ids, replication=len(ids), topology=topo)

    def make(node_id, neighbors):
        pol = make_policy(args.ship_policy)
        if topo is not None:
            pol = Compose(pol, HierarchicalGossip(topo))
        replica = StoreReplica(
            node_id, list(neighbors), causal=True, policy=pol,
            rng=random.Random(stable_seed(node_id)), wire=WireCodec(),
            ownership=ownership, ttl=spec.session_ttl)
        if spec.session_ttl:
            from ..lifecycle import ReaperProtocol
            # grace/retry scale with the tick: proposals should survive
            # a couple of lost datagrams but not stall the reap for long
            ReaperProtocol(replica, ownership,
                           grace=max(2 * args.tick, 0.5),
                           retry=max(6 * args.tick, 1.0))
        return replica

    return make


def _socket_sessions(args, spec) -> None:
    """One member of a real socket gossip cluster (``repro_torch.net``):
    write this process's share of the session keys, gossip frames until
    the run window closes, publish convergence heartbeats."""
    import asyncio

    async def run() -> None:
        from ..net import GossipNode

        n_sessions = args.sessions if args.sessions else 12
        topo = spec.topology
        node = GossipNode(spec.node_id, spec.listen,
                          transport=spec.transport, peers=spec.peers,
                          replica_factory=_socket_replica_factory(
                              args, spec, topo),
                          topology=topo, tick=args.tick,
                          loss=args.udp_loss, seed=args.seed)
        await node.start()
        if args.metrics:
            node.export_metrics()
            maddr = await node.serve_metrics()
            print(f"[serve.net] {spec.node_id} metrics at "
                  f"http://{maddr}/metrics", flush=True)
        ids = spec.cluster_ids
        rank, n = ids.index(spec.node_id), len(ids)
        mine = [s for s in range(n_sessions) if s % n == rank]
        print(f"[serve.net] {spec.node_id} listening on {node.addr} "
              f"({spec.transport}, policy={args.ship_policy}"
              f"{'+hier' if topo is not None else ''}, "
              f"{len(spec.peers)} peers, udp_loss={args.udp_loss}"
              f"{f', zone={node.zone}' if node.zone else ''}"
              f"{f', ttl={spec.session_ttl}s' if spec.session_ttl else ''}"
              f"); writing {len(mine)}/{n_sessions} sessions", flush=True)
        for s in mine:
            for status in ("queued", "prefilling", "decoding", "done"):
                node.update(f"sess{s}", MVRegister, "write_delta",
                            node.id, status)
            await asyncio.sleep(args.tick / 4)   # interleave with gossip
        keys = [f"sess{s}" for s in range(n_sessions)]
        deadline = node.time + args.run_for
        while node.time < deadline:
            node.check_healthy()
            if args.status_file:
                _write_status(args.status_file, node, keys, n_sessions)
            await asyncio.sleep(min(0.25, args.tick))
        if args.status_file:
            _write_status(args.status_file, node, keys, n_sessions)
        print(f"[serve.net] {spec.node_id} done: "
              f"{len(node.X.keys())}/{n_sessions} keys resident, "
              f"frame_bytes_by_kind={node.stats.bytes_by_kind}, "
              f"{node.stats.summary()}", flush=True)
        await node.stop()

    asyncio.run(run())


def _write_status(path: str, node, keys, n_sessions: int) -> None:
    """Atomic heartbeat write (tmp + rename) so the harness never reads
    a torn JSON."""
    import json
    import os
    resident = node.X.keys()
    done = all(k in resident and node.replica.get(k, MVRegister) is not None
               and node.replica.get(k, MVRegister).read()
               == frozenset({"done"}) for k in keys)
    payload = {
        "id": node.id,
        "keys": len(resident),
        "expect": n_sessions,
        "all_done": done,
        "fingerprint": _session_fingerprint(node.replica, keys),
        "bytes_by_kind": node.stats.bytes_by_kind,
        "stats": node.stats.summary(),
        # zoned observability: where this member sits and how many of
        # its bytes were local vs cross-zone (empty/None on a flat mesh)
        "zone": node.zone,
        "bytes_by_class": node.stats.bytes_by_class,
        "recv_bytes_by_class": node.stats.recv_bytes_by_class,
        "tombstones": len(node.X.tombstoned_keys()),
    }
    if node.metrics_registry is not None:
        # --metrics: the harness gets the whole registry without having
        # to scrape the sidecar (and the sidecar address in case it does)
        payload["metrics_addr"] = node.metrics_addr
        payload["metrics"] = node.metrics_registry.snapshot()
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
