"""One rank of the CPU mesh rehearsal in ``test_torch_mesh.py``.

    python tests/torch_mesh_worker.py RANK WORLD INIT_METHOD DATA_DIR

Every rank joins a ``gloo`` group (``INIT_METHOD``, a ``file://``
rendezvous), builds the 2×4 ("data", "model") ``DeviceMesh`` and runs
each case below on ``DTensor``s; rank 0 writes what it found to
``DATA_DIR/result.json``. No JAX here: the reference's outputs come in
``DATA_DIR/moe.npz``.

* ``moe-ep`` / ``moe-tp``: ``apply_moe`` with ``moe_impl="local"`` on the
  mesh (E=8 experts: expert-parallel; E=3: tensor-parallel), the JAX
  global path's output and aux beside it, and the gradients of a
  weighted sum of the output plus the aux beside the port's global
  path's (its aux taken over the same token groups);
* ``dense-*``: a REDUCED dense forward and one train step (loss,
  gradients, AdamW) on ``DTensor`` parameters beside the same step on
  plain tensors: qwen2's (6 heads on a 4-wide "model" axis: the heads
  replicate, recorded) and a variant with 8 heads and 4 KV heads (the
  heads split over "model", the output projection a partial sum) and a
  vocab of 104 (split over "model": the vocab-parallel embedding, logits
  and loss);
* ``dense-microbatches``: that variant's train step with 2 microbatches
  and an uneven ``loss_mask``, on the mesh and on plain tensors;
* ``served``: REDUCED qwen1.5 (attention heads split over "model"),
  deepseek-v2 (MLA heads split, MoE local) and jamba (SSD replicated,
  attention, MoE local) served through ``generate`` on the mesh beside
  the unsharded run;
* ``hint``: the placements ``models.hints.hint`` gives, as specs.
"""

import dataclasses
import json
import os
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist


def _moe_case(mesh, data, ep):
    from repro_torch import dist as D
    from repro_torch.models import ModelConfig, MoESpec
    from repro_torch.models import moe as M
    from repro_torch.models.hints import activation_rules
    from repro_torch.tree import flatten, leaves
    E = 8 if ep else 3
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=0, vocab=17,
                      moe=MoESpec(num_experts=E, top_k=2, expert_d_ff=64,
                                  num_shared_experts=1, shared_d_ff=32,
                                  capacity_factor=float(E)),
                      dtype="float32", moe_impl="local")
    tag = "ep" if ep else "tp"
    p = {k[len(tag) + 3:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith(f"{tag}_p_") and "shared" not in k}
    p["shared"] = {k[len(tag) + 10:]: torch.from_numpy(v)
                   for k, v in data.items()
                   if k.startswith(f"{tag}_p_shared_")}
    x = torch.from_numpy(data[f"{tag}_x"])
    rules = D.make_rules(mesh)
    dp = D.distribute(p, D.param_pspecs(p, M.moe_specs(cfg), rules), mesh)
    xs = D.distribute({"x": x}, {"x": D.P("data")}, mesh)["x"]
    before = dict(M.local_fallbacks)
    # gradients of sum(y · w) + aux against the port's global path (no
    # mesh); the local aux is the mean of the aux of the token groups
    # routed apart: each data shard's tokens, and in the EP regime each
    # model rank's slice of them (here consecutive slices of the flat
    # tokens)
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(x.shape)).astype(np.float32))
    ref_leaves, treedef = flatten(p)
    ref_leaves = [t.clone().requires_grad_(True) for t in ref_leaves]
    xr = x.clone().requires_grad_(True)
    ref_p = treedef.unflatten(ref_leaves)
    yr, _ = M.apply_moe(ref_p, dataclasses.replace(cfg, moe_impl="global"),
                        xr)
    groups = xr.reshape(-1, cfg.d_model).chunk(8 if ep else 2)
    aux_r = torch.stack([M._route(ref_p["router"], cfg, g)[2]
                         for g in groups]).mean()
    ref_grads = torch.autograd.grad((yr * w).sum() + aux_r,
                                    ref_leaves + [xr])
    d_leaves = [t.detach().requires_grad_(True) for t in leaves(dp)]
    xs = xs.detach().requires_grad_(True)
    with activation_rules(mesh, {"tokens": "data", "batch": "data"}):
        y, aux = M.apply_moe(treedef.unflatten(d_leaves), cfg, xs)
        ws = D.distribute({"w": w}, {"w": D.P("data")}, mesh)["w"]
        grads = torch.autograd.grad((y * ws).sum() + aux,
                                    d_leaves + [xs])
    grad_err = max(float((g.full_tensor() - r).abs().max())
                   for g, r in zip(grads, ref_grads))
    y, aux = y.full_tensor(), aux.full_tensor()
    want = data[f"{tag}_y"]
    return {"max_err": float(np.abs(y.detach().numpy() - want).max()),
            "close": bool(np.allclose(y.detach().numpy(), want, rtol=2e-4,
                                      atol=2e-4)),
            "grad_err": grad_err,
            "aux": float(aux), "aux_ref": float(data[f"{tag}_aux"]),
            "aux_groups_err": float(abs(aux - aux_r)),
            "fallbacks": {k: M.local_fallbacks[k] - before[k]
                          for k in before}}


def _dense_case(mesh, heads_split):
    from repro_torch import dist as D
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    from repro_torch.models.hints import activation_rules, default_rules
    from repro_torch.models.transformer import logical_specs
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim import opt_state_pspecs
    from repro_torch.runtime import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = get_config("qwen2-1.5b", reduced=True)
    if heads_split:
        # and a vocab that splits over "model": the vocab-parallel
        # embedding, logits and loss
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4,
                                  head_dim=6, vocab=104)
    from repro_torch.models import init_model
    params = init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))
                           .astype(np.int32))
    batch = {"tokens": tok, "labels": torch.roll(tok, 1, 1)}
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig()))
    ref_logits, _ = forward(cfg, params, batch)
    ref_p, ref_o, ref_m = step(params, init_opt_state(params), batch)
    rules = D.make_rules(mesh)
    pspecs = D.param_pspecs(params, logical_specs(cfg), rules)
    dparams = D.distribute(params, pspecs, mesh)
    dopt = D.distribute(init_opt_state(params), opt_state_pspecs(pspecs),
                        mesh)
    dbatch = D.distribute(batch, D.batch_pspecs(batch, rules), mesh)
    with activation_rules(mesh, default_rules(False)) as fb:
        logits, _ = forward(cfg, dparams, dbatch)
        new_p, new_o, met = step(dparams, dopt, dbatch)
        # the backward (and the remat recompute in it) from a thread that
        # has no rules installed, as autograd's device thread on a card
        leaves_ = [t.detach().requires_grad_(True) for t in leaves(dparams)]
        from repro_torch.models import train_loss
        from repro_torch.tree import flatten
        loss = train_loss(cfg, flatten(dparams)[1].unflatten(leaves_),
                          dbatch)
    box = {}
    worker = threading.Thread(target=lambda: box.update(
        g=torch.autograd.grad(loss, leaves_)))
    worker.start()
    worker.join(timeout=300)
    other_thread = worker.is_alive() is False and "g" in box
    err = lambda a, b: float((a.full_tensor() - b).abs().max())
    return {
        "backward_on_another_thread": other_thread,
        "logits_err": err(logits, ref_logits),
        "loss_err": err(met["loss"], ref_m["loss"]),
        "grad_norm_err": err(met["grad_norm"], ref_m["grad_norm"]),
        "param_err": max(err(a, b) for a, b in zip(leaves(new_p),
                                                    leaves(ref_p))),
        "moment_err": max(err(a, b) for a, b in zip(leaves(new_o["v"]),
                                                     leaves(ref_o["v"]))),
        "placements_kept": all(
            a.placements == b.placements
            for a, b in zip(leaves(new_p), leaves(dparams))),
        "fallbacks": list(fb), "sharding_fallbacks": rules.fallbacks}


def _micro_case(mesh):
    """One train step with 2 microbatches and an uneven ``loss_mask`` on
    ``DTensor``s beside the same step on plain tensors: microbatch i is
    the batch's i-th slice of rows on both."""
    from repro_torch import dist as D
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.hints import activation_rules, default_rules
    from repro_torch.models.transformer import logical_specs
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim import opt_state_pspecs
    from repro_torch.runtime import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              n_heads=8, n_kv_heads=4, head_dim=6,
                              vocab=104)
    params = init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))
                           .astype(np.int32))
    # row r keeps about (r + 1) / 9 of its tokens
    keep = rng.random((8, 32)) < (np.arange(1, 9) / 9)[:, None]
    batch = {"tokens": tok, "labels": torch.roll(tok, 1, 1),
             "loss_mask": torch.from_numpy(keep.astype(np.float32))}
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(),
                                            microbatches=2))
    ref_p, ref_o, ref_m = step(params, init_opt_state(params), batch)
    rules = D.make_rules(mesh)
    pspecs = D.param_pspecs(params, logical_specs(cfg), rules)
    dparams = D.distribute(params, pspecs, mesh)
    dopt = D.distribute(init_opt_state(params), opt_state_pspecs(pspecs),
                        mesh)
    dbatch = D.distribute(batch, D.batch_pspecs(batch, rules), mesh)
    with activation_rules(mesh, default_rules(False)):
        new_p, new_o, met = step(dparams, dopt, dbatch)
    err = lambda a, b: float((a.full_tensor() - b).abs().max())
    return {
        "loss_err": err(met["loss"], ref_m["loss"]),
        "grad_norm_err": err(met["grad_norm"], ref_m["grad_norm"]),
        "param_err": max(err(a, b) for a, b in zip(leaves(new_p),
                                                    leaves(ref_p))),
        "moment_err": max(err(a, b) for a, b in zip(leaves(new_o["v"]),
                                                     leaves(ref_o["v"])))}


def _served_case(mesh, arch):
    """A REDUCED config served through ``generate`` (prefill, then decode
    steps over the caches laid out on the mesh) on ``DTensor``
    parameters, beside the unsharded run: tokens and every step's
    logits."""
    from repro_torch import dist as D
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompt
    from repro_torch.models import init_model
    from repro_torch.models.hints import activation_rules, default_rules
    from repro_torch.models.transformer import logical_specs
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              moe_impl="local")
    params = init_model(cfg, 1, device="cpu")
    prompt, _ = make_prompt(cfg, 4, 16, 1, "cpu")
    want = generate(cfg, params, prompt, 4, keep_logits=True)
    rules = D.make_rules(mesh, serve=True)
    dparams = D.distribute(params, D.param_pspecs(params, logical_specs(cfg),
                                                  rules), mesh)
    with activation_rules(mesh, default_rules(False, serve=True)) as fb:
        got = generate(cfg, dparams, prompt, 4, keep_logits=True)
    return {"tokens_equal": bool(np.array_equal(got.tokens, want.tokens)),
            "logits_err": max(float((a - b).abs().max())
                              for a, b in zip(got.logits, want.logits)),
            "fallbacks": list(fb)}


HINT_CASES = [((8, 32, 48), ("batch", None, None)),
              ((6, 32, 104), ("batch", None, "vocab")),
              ((8, 32, 103), ("batch", None, "vocab")),
              ((8, 12), ("heads", "mlp")),
              ((8, 4, 16), ("batch", "tokens", None)),
              ((3, 8), ("batch", "vocab"))]


def _hint_case(mesh):
    from repro_torch import dist as D
    from repro_torch.models.hints import activation_rules, default_rules, hint
    out = []
    with activation_rules(mesh, default_rules(False)):
        for shape, axes in HINT_CASES:
            x = D.distribute({"x": torch.zeros(shape)}, {"x": D.P()},
                             mesh)["x"]
            y = hint(x, axes)
            spec = [[] for _ in shape]
            for name, pl in zip(mesh.mesh_dim_names, y.placements):
                if pl.is_shard():
                    spec[pl.dim].append(name)
            out.append([None if not s else s[0] if len(s) == 1 else s
                        for s in spec])
    return out


def main() -> int:
    rank, world, init, data_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        data = dict(np.load(os.path.join(data_dir, "moe.npz")))
        result = {"moe-ep": _moe_case(mesh, data, True),
                  "moe-tp": _moe_case(mesh, data, False),
                  "dense-replicated-heads": _dense_case(mesh, False),
                  "dense-split-heads": _dense_case(mesh, True),
                  "dense-microbatches": _micro_case(mesh),
                  "served": {arch: _served_case(mesh, arch) for arch in
                             ("qwen1.5-0.5b", "deepseek-v2-236b",
                              "jamba-v0.1-52b")},
                  "hint": _hint_case(mesh)}
        if rank == 0:
            with open(os.path.join(data_dir, "result.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
