"""The port's training core against the JAX package on the same numpy
inputs (REDUCED configs, f32): ``cross_entropy``; ``forward`` /
``train_loss`` and every gradient leaf, with remat on and off and both
attention paths; ``lr_at_step`` and ``adamw_update`` (f32 params, and bf16
params with the f32 master); three ``make_train_step`` steps and
``microbatches=2``; the synthetic data streams, byte for byte; and the
``launch.train`` entry point in both modes, whose printed lines must be
the JAX package's, including a crash and resume through ``--ckpt-dir``.

Tolerances: f32 reductions in another order — losses and logits to
rtol 1e-5 / atol 1e-6, gradients to rtol 1e-5 / atol 1e-6, the optimizer
to rtol 1e-6 / atol 1e-7; parameters after train steps at lr 1e-3 to
rtol 1e-5 / atol 1e-4, a tenth of one step (AdamW's m/√v normalizes a
gradient's size away, so an element whose gradient is near f32 rounding
level steps on the sign of that rounding); bytes and data exactly. The JAX references are
computed once per module (most of their cost is the compile)."""

import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import ShardedTokenStream as JShardedTokenStream
from repro.data import SyntheticLMStream as JSyntheticLMStream
from repro.launch import train as jtrain
from repro.models import forward as jforward
from repro.models import init_model as jinit_model
from repro.models import train_loss as jtrain_loss
from repro.models.layers import cross_entropy as jcross_entropy
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import lr_at_step as jlr_at_step
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import make_train_step as jmake_train_step
from repro_torch import tree as tu
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data import ShardedTokenStream, SyntheticLMStream
from repro_torch.launch import train as ttrain
from repro_torch.models import forward, train_loss
from repro_torch.models import attention as attn
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               lr_at_step)
from repro_torch.runtime import TrainConfig, make_train_step

TOL = dict(rtol=1e-5, atol=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=1e-5, atol=1e-4)        # params after steps at lr 1e-3
B, SEQ = 2, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, impl):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               attn_impl=impl, attn_block=8)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              attn_impl=impl, attn_block=8)
    return jcfg, cfg


def _batch(cfg, step=0):
    return SyntheticLMStream(vocab=cfg.vocab, seq=SEQ, batch=B,
                             seed=5).batch_at(step)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (4 * rng.normal(size=(3, 7, 29))).astype(np.float32)
    labels = rng.integers(0, 29, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, "cross_entropy")


def test_cross_entropy_all_masked_is_zero():
    logits = torch.zeros((2, 3, 5))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    assert float(cross_entropy(logits, labels, torch.zeros((2, 3)))) == 0.0


# ---------------------------------------------------------------------------
# forward / train_loss and gradients
# ---------------------------------------------------------------------------

CASES = [("qwen1.5-0.5b", "naive", True), ("qwen1.5-0.5b", "naive", False),
         ("qwen2-1.5b", "chunked", True)]


@pytest.fixture(scope="module")
def grad_refs():
    """JAX logits, loss and gradients of each case (one jitted
    value-and-grad per case)."""
    out = {}
    for arch, impl, remat in CASES:
        jcfg, _ = _cfgs(arch, impl)
        jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(7))
        batch = _batch(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_and_logits(p, b, jcfg=jcfg, remat=remat):
            return (jtrain_loss(jcfg, p, b, remat=remat),
                    jforward(jcfg, p, b, remat=remat)[0])

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_and_logits, has_aux=True))(jparams, jb)
        out[(arch, impl, remat)] = (_np(jparams), batch, float(loss),
                                    np.asarray(logits), _np(grads))
    return out


@pytest.mark.parametrize("arch,impl,remat", CASES)
def test_forward_loss_and_gradients_match_jax(grad_refs, arch, impl, remat):
    jparams, batch, jloss, jlogits, jgrads = grad_refs[(arch, impl, remat)]
    _, cfg = _cfgs(arch, impl)
    params = params_from_numpy(jparams, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, aux = forward(cfg, params, tb, remat=remat)
    _close(logits.detach(), jlogits, "logits")
    assert float(aux) == 0.0
    flat, treedef = tu.flatten(params)
    leaves = [p.requires_grad_(True) for p in flat]
    loss = train_loss(cfg, treedef.unflatten(leaves), tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.detach(), jloss, "loss")
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, "gradient")


def test_training_never_reaches_the_flash_kernels():
    """On the card ``attend_full`` takes the flash kernel only for a
    prefill that needs no gradient (meta tensors stand for tensors off
    the CPU); the kernel wrappers refuse operands that require grad."""
    q = torch.empty((1, 4, 2, 8), device="meta")
    assert attn.flash_route(q, make_cache=8)
    assert not attn.flash_route(q, make_cache=None)           # training
    assert not attn.flash_route(q.requires_grad_(True), make_cache=8)
    assert not attn.flash_route(torch.empty((1, 4, 2, 8)), make_cache=8)
    from repro_torch.kernels import ops
    x = torch.zeros((1, 2, 4, 8), requires_grad=True)
    pos = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(x, x, x)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(x[:, :, :1], x, x, pos,
                         torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    for cfg_kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1),
                   dict(lr=3e-4, warmup_steps=0, total_steps=7)):
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 250):
            want = jlr_at_step(JAdamWConfig(**cfg_kw), jnp.asarray(step))
            got = lr_at_step(AdamWConfig(**cfg_kw),
                             torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, want, f"lr at {step}", OPT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    rng = np.random.default_rng(11)
    shapes = {"w": (5, 3), "b": (3,), "deep": {"k": (2, 2, 2)}}
    p0 = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda t: isinstance(t, tuple))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p0)
    tp = tu.tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)),
                     p0)
    jcfg = JAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        clip_norm=0.5)
    tcfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                       clip_norm=0.5)
    js, ts = jinit_opt_state(jp), init_opt_state(tp)
    for k in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (3 * rng.normal(size=a.shape)).astype(np.float32), p0)
        jp, js, jm = jadamw_update(
            jp, jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), g),
            js, jcfg)
        tp, ts, tm = adamw_update(
            tp, tu.tree_map(lambda a: torch.from_numpy(a).to(
                getattr(torch, dtype)), g), ts, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm", OPT_TOL)
        _close(tm["lr"], jm["lr"], "lr", OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for name in ("m", "v", "master"):
        for got, want in zip(tu.leaves(ts[name]),
                             jax.tree_util.tree_leaves(js[name])):
            assert got.dtype == torch.float32
            _close(got, want, name, OPT_TOL)
    for got, want in zip(tu.leaves(tree_to_numpy(tp)),
                         jax.tree_util.tree_leaves(_np(jp))):
        if dtype == "bfloat16":   # the cast of a master within OPT_TOL
            assert got.dtype.kind == "V"
            got = (got.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32)
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got, want, rtol=2 ** -8)
        else:
            _close(got, want, "params", OPT_TOL)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_refs():
    """Three JAX train steps (remat, 1 microbatch) and one with 2
    microbatches, REDUCED qwen1.5."""
    jcfg, _ = _cfgs("qwen1.5-0.5b", "naive")
    jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(3))
    opt = JAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    one = jax.jit(jmake_train_step(jcfg, JTrainConfig(optimizer=opt)))
    two = jax.jit(jmake_train_step(jcfg, JTrainConfig(optimizer=opt,
                                                      microbatches=2)))
    p, s = jparams, jinit_opt_state(jparams)
    losses = []
    for step in range(3):
        b = {k: jnp.asarray(v) for k, v in _batch(jcfg, step).items()}
        p, s, m = one(p, s, b)
        losses.append(float(m["loss"]))
    b0 = {k: jnp.asarray(v) for k, v in _batch(jcfg, 0).items()}
    pm, _, mm = two(jparams, jinit_opt_state(jparams), b0)
    return {"init": _np(jparams), "losses": losses, "params": _np(p),
            "opt": _np(s), "micro_loss": float(mm["loss"]),
            "micro_params": _np(pm)}


def _tb(cfg, step):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg, step).items()}


def test_three_train_steps_match_jax(step_refs):
    _, cfg = _cfgs("qwen1.5-0.5b", "naive")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step_fn = make_train_step(cfg, TrainConfig(optimizer=opt))
    p = params_from_numpy(step_refs["init"], device="cpu")
    s = init_opt_state(p)
    for step in range(3):
        p, s, m = step_fn(p, s, _tb(cfg, step))
        _close(m["loss"], step_refs["losses"][step], f"loss {step}")
    for got, want in zip(tu.leaves(p),
                         jax.tree_util.tree_leaves(step_refs["params"])):
        _close(got, want, "params after 3 steps", STEP_TOL)
    assert int(s["step"]) == 3
    assert all(not t.requires_grad for t in tu.leaves(p))


def test_microbatched_step_matches_monolithic_and_jax(step_refs):
    _, cfg = _cfgs("qwen1.5-0.5b", "naive")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    init = params_from_numpy(step_refs["init"], device="cpu")
    p1, _, m1 = make_train_step(cfg, TrainConfig(optimizer=opt))(
        init, init_opt_state(init), _tb(cfg, 0))
    p2, _, m2 = make_train_step(cfg, TrainConfig(optimizer=opt,
                                                 microbatches=2))(
        init, init_opt_state(init), _tb(cfg, 0))
    # equal token counts per microbatch: mean of means == full mean
    _close(m2["loss"], m1["loss"], "micro vs mono loss")
    _close(m2["loss"], step_refs["micro_loss"], "micro loss vs jax")
    for a, b, w in zip(tu.leaves(p2), tu.leaves(p1),
                       jax.tree_util.tree_leaves(step_refs["micro_params"])):
        _close(a, b, "micro vs mono params", STEP_TOL)
        _close(a, w, "micro params vs jax", STEP_TOL)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 32, 4, 7),
                                                  (151936, 17, 3, 0),
                                                  (97, 5, 1, 123)])
def test_streams_are_byte_identical(vocab, seq, batch, seed):
    j = JSyntheticLMStream(vocab=vocab, seq=seq, batch=batch, seed=seed)
    t = SyntheticLMStream(vocab=vocab, seq=seq, batch=batch, seed=seed)
    for step, rank in ((0, 0), (12, 0), (3, 1), (70000, 5)):
        a, b = j.batch_at(step, rank), t.batch_at(step, rank)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()


def test_sharded_streams_are_byte_identical():
    jb = JSyntheticLMStream(vocab=1000, seq=16, batch=8, seed=5)
    tb = SyntheticLMStream(vocab=1000, seq=16, batch=8, seed=5)
    for r in range(4):
        a = JShardedTokenStream(jb, rank=r, world=4).batch_at(3)
        b = ShardedTokenStream(tb, rank=r, world=4).batch_at(3)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# The launch.train entry point
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"step +(\d+) loss ([\d.]+) gnorm ([\d.]+) "
                       r"lr (\S+) \(")
ROUND_LINE = re.compile(r"\[(pod\d+)\] round (\d+) loss ([\d.]+)")


def _run(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    main()
    return capsys.readouterr().out.splitlines()


def _same_lines(got, want):
    """Equal lines, except for wall-clock times and the last printed
    digit of a loss or a grad norm (f32 sums in another order)."""
    strip = lambda s: re.sub(r"\(?\d+\.\ds\)?", "<t>", s)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        mg, mw = STEP_LINE.search(g), STEP_LINE.search(w)
        rg, rw = ROUND_LINE.search(g), ROUND_LINE.search(w)
        if mg and mw:
            assert mg.group(1) == mw.group(1) and mg.group(4) == mw.group(4)
            assert abs(float(mg.group(2)) - float(mw.group(2))) <= 2e-4
            assert abs(float(mg.group(3)) - float(mw.group(3))) <= 2e-3
        elif rg and rw:
            assert rg.group(1, 2) == rw.group(1, 2)
            assert abs(float(rg.group(3)) - float(rw.group(3))) <= 2e-4
        else:
            assert strip(g) == strip(w)


def _losses(lines):
    return {int(m.group(1)): m.group(2)
            for m in map(STEP_LINE.search, lines) if m}


@pytest.fixture
def same_init(monkeypatch):
    """Both entry points start from the JAX package's initial
    parameters."""
    def init(cfg, seed, device):
        jcfg = jget_config("qwen1.5-0.5b", reduced=True)
        assert cfg.name == jcfg.name
        jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(seed))
        return params_from_numpy(_np(jparams), device=device)
    monkeypatch.setattr(ttrain, "_init", init)


def test_train_sync_cli_matches_jax_with_crash_and_resume(
        tmp_path, capsys, monkeypatch, same_init):
    common = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "2",
              "--seq", "16", "--log-every", "1", "--ckpt-every", "2",
              "--snap-every", "2", "--chunk", "256"]
    cpu = ["--device", "cpu"]
    jdir, tdir, crash = (str(tmp_path / d) for d in ("j", "t", "crash"))
    jout = _run(jtrain.main, common + ["--steps", "6", "--ckpt-dir", jdir],
                capsys, monkeypatch)
    tout = _run(ttrain.main, common + ["--steps", "6", "--ckpt-dir", tdir]
                + cpu, capsys, monkeypatch)
    _same_lines(tout, jout)
    uninterrupted = _losses(tout)

    # a run that ends after step 3 leaves snapshot seq 0 (step 2) and
    # delta seq 1 (step 4); rerun for six steps, it restores their join
    # and runs steps 4 and 5 again. All six steps are in the warmup, so
    # the schedule is the same: it prints the uninterrupted run's lines.
    _run(ttrain.main, common + ["--steps", "4", "--ckpt-dir", crash] + cpu,
         capsys, monkeypatch)
    resumed = _run(ttrain.main, common + ["--steps", "6", "--ckpt-dir",
                                          crash] + cpu, capsys, monkeypatch)
    assert resumed[0] == "[restore] resumed at step 4 (ckpt seq 1)"
    _same_lines(resumed[1:3], jout[4:6])
    assert _losses(resumed) == {4: uninterrupted[4], 5: uninterrupted[5]}

    # the JAX package's checkpoint directory resumes in the port
    cross = _run(ttrain.main, common + ["--steps", "7", "--ckpt-dir", jdir]
                 + cpu, capsys, monkeypatch)
    assert cross[0] == "[restore] resumed at step 6 (ckpt seq 2)"
    assert STEP_LINE.search(cross[1]).group(1) == "6"


def test_train_delta_cli_matches_jax(capsys, monkeypatch, same_init):
    argv = ["--mode", "delta", "--steps", "4", "--local-steps", "2",
            "--pods", "2", "--seq", "16", "--batch", "2", "--topk", "0.1",
            "--ship-policy", "bp+rr"]
    jout = _run(jtrain.main, argv, capsys, monkeypatch)
    tout = _run(ttrain.main, argv + ["--device", "cpu"], capsys, monkeypatch)
    _same_lines(tout, jout)
    assert tout[-1].startswith("[done] 2 rounds × 2 local steps on 2 pods")
    assert "all pods converged to identical outer params (4 dots merged)" \
        in tout[-1]


def test_train_cli_defaults_to_the_card():
    args = ttrain.parse_args([])
    assert args.device == "cuda" and args.mode == "sync"
