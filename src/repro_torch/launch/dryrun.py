"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake
process group.

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \
        --mesh single --out build/dryrun

The JAX package lowers and compiles each cell's step on 512 forced host
devices and reads XLA's cost analysis. The port runs the step itself, on
``meta`` tensors (shapes and dtypes, no storage), as one rank of a
``"fake"`` process group (``FakeStore``) of 256 or 512 ranks, in this
process:

* parameters, optimizer state and batch are ``DTensor``s placed by
  ``dist.shardings``' rules (``param_pspecs`` of
  ``models.transformer.logical_specs``, ``opt_state_pspecs``,
  ``batch_pspecs``); decode caches take the layout the mixers read and
  write them in (``models.transformer.cache_axes``). At inference the
  parameters replicate over the batch axes when the model-sharded copy
  fits, by the JAX dry-run's test;
* the activation hints are installed (``models.hints``); what the mesh
  cannot lay out evenly is recorded beside ``rules.fallbacks``;
* one train step (forward, backward, AdamW), one prefill or one decode
  step runs eagerly under :class:`StepCounter`, a ``CommDebugMode`` that
  also counts *below* ``DTensor``, on this rank's local shards: the
  flops (``torch.utils.flop_counter``'s formulas: matrix products and
  attention), the bytes each op reads and writes (views free; eager ops
  are not fused, so this is what unfused code moves), and every
  collective with its result bytes and the size of the mesh dimension
  it ran on, charged with ``dist.hlo``'s ring costs.

By design no probe correction is needed: XLA counts a scan body once,
whatever its trip count, so the JAX dry-run rebuilds the totals from
trip-1 probes; eager torch runs every layer, so the traced counts are
whole, and ``cost_analysis_raw_scan_body_once`` is recorded equal to
``cost_analysis``.

Memory: the bytes of this rank's parameter, optimizer, cache and batch
shards are exact from their shapes (``memory_analysis``); the step's
peak of live tensors it allocated (activations, gradients, temporaries)
is ``torch.distributed._tools.mem_tracker``'s on the ``meta`` device
(``temp_size_in_bytes``; ``null`` where that module is missing).

``meta`` tensors cannot launch a CUDA kernel: the dry-run takes the
config's ``attn_impl`` (default ``"naive"``), and ``--attn-impl chunked``
raises at the first prefill or decode kernel call rather than take a
plain version.

The artifacts carry ``run_cell``'s keys of the JAX dry-run, so
``launch.report`` renders the cells of both packages.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCH_IDS, SHAPE_CASES, ShapeCase, applicable,
                       get_config, input_specs)
from ..dist import (batch_pspecs, distribute, make_rules, param_pspecs,
                    recorded_collective_bytes, roofline)
from ..dist.shardings import axis_sizes
from ..models import init_model
from ..models.hints import activation_rules, default_rules, layout
from ..models.transformer import cache_axes, logical_specs
from ..optim import AdamWConfig, opt_state_pspecs
from ..runtime import (TrainConfig, make_decode_fn, make_prefill_fn,
                       make_train_step)
from ..tree import leaves, tree_map
from .mesh import make_production_mesh

# c10d functional collectives → the HLO names ``dist.hlo`` charges
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-broadcast"}
_FUNCOL = ("_c10d_functional", "_c10d_functional_autograd")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class StepCounter(CommDebugMode):
    """``CommDebugMode`` that also counts what one rank runs: the ops it
    sees below ``DTensor`` (which hands them this rank's local shards;
    its shape inference on fake global tensors is left out) give
    ``flops``, ``bytes`` (each op's tensor operands read and
    results written; views and allocations free) and ``collectives``,
    one ``(kind, result bytes, group size)`` per collective, the group
    the mesh dimension it ran on."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator) or any(
                issubclass(t, DTensor) for t in types):
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        # DTensor infers each op's global output shape by running it on
        # fake tensors of the global shapes: that is no rank's work
        if not any(issubclass(t, FakeTensor) for t in types):
            self._count(func, args, kwargs or {}, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__.rstrip("_")
        if ns in _FUNCOL or ns == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                group = next(a for a in reversed(args) if isinstance(a, str))
                size = dist.distributed_c10d._resolve_process_group(
                    group).size()
                self.collectives.append(
                    (kind, float(sum(map(_nbytes, _tensors(out)))), size))
            return
        fn = flop_registry.get(packet)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        if name.startswith("empty") or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            return                       # an allocation or a view
        self.bytes += float(sum(map(_nbytes, _tensors((args, kwargs))))
                            + sum(map(_nbytes, _tensors(out))))


def _mem_tracker():
    """A ``MemTracker`` (a context), or a no-op context without one."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError:
        return contextlib.nullcontext()
    return MemTracker()


def _peak_bytes(tracker) -> Optional[float]:
    if isinstance(tracker, contextlib.nullcontext):
        return None
    peak = tracker.get_tracker_snapshot("peak").get(torch.device("meta"))
    return None if peak is None else float(peak["Total"])


def abstract_model(cfg) -> Tuple[Any, Any]:
    """``meta`` parameters + their logical-axis tree, no allocation."""
    return init_model(cfg, device="meta"), logical_specs(cfg)


def abstract_opt_state(params) -> Dict[str, Any]:
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "master": tree_map(f32, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of ``DTensor``s."""
    return sum(_nbytes(t.to_local()) for t in leaves(tree))


def _fake_world(n: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``n`` ranks (the
    group is made anew when the size differs)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _trace_step(cfg, case: ShapeCase, mesh, multi_pod: bool, rules,
                microbatches: int = 1) -> Dict[str, Any]:
    """Distribute this cell's inputs on ``mesh`` and run its step once
    under a :class:`StepCounter`; returns the counts, the shard bytes
    and the fallbacks the layouts recorded."""
    serve_mode = False
    if case.step != "train" and rules.candidates.get("embed"):
        # Replicate params over the batch axes at inference ONLY if (i)
        # the model-axis-sharded copy fits per chip (bf16, 12 GB
        # headroom) and (ii) the batch actually occupies the data axes
        # (the JAX dry-run's test)
        total_params, _ = cfg.param_counts()
        model = axis_sizes(mesh)["model"]
        dp = mesh.size() // model
        if total_params * 2 / model <= 12e9 and case.batch >= dp:
            rules = make_rules(mesh, serve=True)
            serve_mode = True
    params_meta, logical = abstract_model(cfg)
    p_pspecs = param_pspecs(params_meta, logical, rules)
    params = distribute(params_meta, p_pspecs, mesh)
    batch_meta = input_specs(cfg, case)
    memory = {"param_bytes": _local_bytes(params)}
    counter = StepCounter()
    tracker = _mem_tracker()
    act_rules = default_rules(multi_pod, serve=serve_mode)
    with activation_rules(mesh, act_rules) as fallbacks:
        if case.step == "decode":
            # the caches in the layout the mixers write them in
            caches = tree_map(
                lambda t, ax: distribute_tensor(
                    t, mesh, layout(ax, mesh, act_rules)),
                batch_meta.pop("caches"), cache_axes(cfg, case.batch))
            memory["cache_bytes"] = _local_bytes(caches)
        batch = distribute(batch_meta, batch_pspecs(batch_meta, rules), mesh)
        memory["batch_bytes"] = _local_bytes(batch)
        if case.step == "train":
            opt = distribute(abstract_opt_state(params_meta),
                             opt_state_pspecs(p_pspecs), mesh)
            memory["opt_state_bytes"] = _local_bytes(opt)
            step_fn = make_train_step(cfg, TrainConfig(
                optimizer=AdamWConfig(), microbatches=microbatches))
            with counter, tracker:
                step_fn(params, opt, batch)
        elif case.step == "prefill":
            with torch.no_grad(), counter, tracker:
                make_prefill_fn(cfg, max_len=case.seq)(params, batch)
        else:
            with torch.no_grad(), counter, tracker:
                make_decode_fn(cfg)(params, batch["tokens"], batch["pos"],
                                    caches)
    wire, per_kind = recorded_collective_bytes(counter.collectives)
    counts: Dict[str, int] = {}
    for kind, _, _ in counter.collectives:
        counts[kind] = counts.get(kind, 0) + 1
    memory["argument_size_in_bytes"] = float(sum(memory.values()))
    memory["temp_size_in_bytes"] = _peak_bytes(tracker)
    return {"flops": counter.flops, "bytes accessed": counter.bytes,
            "wire": wire, "per_kind": per_kind, "counts": counts,
            "memory": memory, "rules": rules,
            "fallbacks": list(fallbacks)}


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             microbatches: int = 1,
             overrides: Optional[Dict[str, Any]] = None,
             tag_suffix: str = "", *, mesh=None,
             case: Optional[ShapeCase] = None,
             reduced: bool = False) -> Dict[str, Any]:
    """Trace one cell and return (and with ``out_dir`` write) its JSON.
    ``mesh`` defaults to the production mesh over a fake group of 256
    or 512 ranks made here; a caller's ``mesh`` runs on the caller's
    process group. ``case`` and ``reduced`` (the REDUCED config) size a
    cell for tests."""
    cfg = get_config(arch, reduced=reduced)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    case = case or SHAPE_CASES[shape]
    if mesh is None:
        _fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "x".join(str(n) for n in mesh.shape)
    tag = f"{arch}_{shape}_{mesh_name}{tag_suffix}".replace("/", "-")
    ok, reason = applicable(cfg, case)
    if not ok:
        res = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        _write(out_dir, tag, res)
        return res

    t0 = time.time()
    chips = mesh.size()
    total_params, active_params = cfg.param_counts()
    if case.step == "train":
        tokens = case.batch * case.seq
        model_flops = 6.0 * active_params * tokens
    elif case.step == "prefill":
        tokens = case.batch * case.seq
        model_flops = 2.0 * active_params * tokens
    else:
        tokens = case.batch
        model_flops = 2.0 * active_params * tokens
    if case.step == "train" and microbatches > 1:
        dp = chips // axis_sizes(mesh)["model"]
        if case.batch % microbatches or (case.batch // microbatches) % dp:
            raise ValueError(
                f"microbatches={microbatches}: per-microbatch batch "
                f"{case.batch // microbatches} must divide the {dp}-way "
                f"data-parallel axes (max valid mu = {case.batch // dp})")

    rules = make_rules(mesh)
    traced = _trace_step(cfg, case, mesh, multi_pod, rules, microbatches)
    cost = {"flops": traced["flops"],
            "bytes accessed": traced["bytes accessed"]}
    mem = traced["memory"]
    rep = roofline(arch, shape, mesh_name, chips, cost, traced["wire"],
                   traced["per_kind"], model_flops, tokens,
                   peak_memory=mem["temp_size_in_bytes"])
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok",
        "chips": chips,
        "compile_s": round(time.time() - t0, 1),
        "cost_analysis": cost,
        # eager torch runs every layer: nothing counted once to correct
        "cost_analysis_raw_scan_body_once": {**cost,
                                             "wire": traced["wire"]},
        "memory_analysis": mem,
        "collective_wire_bytes_per_chip": traced["wire"],
        "collective_breakdown": traced["per_kind"],
        "collective_counts": traced["counts"],
        "params_total": total_params,
        "params_active": active_params,
        "model_flops_total": model_flops,
        "roofline": json.loads(rep.to_json()),
        "sharding_fallbacks": sorted(set(rules.fallbacks)
                                     | set(traced["rules"].fallbacks)),
        "layout_fallbacks": sorted(set(traced["fallbacks"])),
    }
    if overrides:
        result["overrides"] = {k: str(v) for k, v in overrides.items()}
    result["microbatches"] = microbatches
    _write(out_dir, tag, result)
    return result


def _write(out_dir: Optional[str], tag: str, res: Dict[str, Any]) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPE_CASES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl

    arches = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_CASES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    try:
        for multi in meshes:
            for arch in arches:
                for shape in shapes:
                    tag = (f"{arch} × {shape} × "
                           f"{'2x16x16' if multi else '16x16'}")
                    try:
                        res = run_cell(arch, shape, multi, out_dir=args.out,
                                       microbatches=args.microbatches,
                                       overrides=overrides or None,
                                       tag_suffix=args.tag)
                    except Exception as e:   # report the cell, go on
                        failures += 1
                        print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                              flush=True)
                        traceback.print_exc()
                        continue
                    if res["status"] == "skipped":
                        print(f"[skip] {tag}: {res['reason']}", flush=True)
                        continue
                    r = res["roofline"]
                    print(f"[ ok ] {tag} trace={res['compile_s']}s "
                          f"c={r['compute_s']:.3e}s m={r['memory_s']:.3e}s "
                          f"n={r['collective_s']:.3e}s bound={r['bound']} "
                          f"useful={r['useful_frac']:.2%}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
