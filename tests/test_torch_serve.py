"""The port's serving entry point on the CPU: it runs at REDUCED qwen1.5 and
prints the JAX package's serve.py lines; its prompt is that script's (same
``--seed``, same token ids); its greedy loop, given the JAX package's
parameters, yields the JAX loop's tokens; teacher forcing with its own
tokens reproduces a run; ``--replicate`` gossips the batch's session
table to every status "done"; and keyed sessions and socket mode, which
wait for slice C, exit with an error naming it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_model as jinit_model
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import init_model

ROOT = Path(__file__).resolve().parents[1]


def test_serve_runs_on_the_cpu_and_prints_its_lines():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "6"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "[serve] arch=qwen1.5-reduced batch=2 prompt=16 gen=6"
    assert lines[1].startswith("  prefill: ") and "tok/s on cpu" in lines[1]
    assert lines[2].startswith("  sample continuation (req 0): [")
    assert len(ast.literal_eval(lines[2].split(": ", 1)[1])) == 6


def test_replicate_gossips_the_session_table_to_done():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "4", "--prompt-len", "8", "--gen", "3", "--replicate",
         "3"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.splitlines()[3]
    assert line.startswith("  [δ-CRDT] session table replicated over 3 "
                           "gateways (25% loss, policy=bp+rr, frame_bytes=")
    statuses = ast.literal_eval(line.split("): ", 1)[1])
    assert statuses == {f"req{r}": "done" for r in range(4)}


@pytest.mark.parametrize("policy", ["bp+rr", "digest-sync", "every:2"])
@pytest.mark.parametrize("wire", [True, False])
def test_replicate_sessions_converges_under_each_policy(policy, wire):
    statuses, payload = serve.replicate_sessions(5, 3, policy, seed=2,
                                                 wire=wire, device="cpu")
    assert statuses == {f"req{r}": "done" for r in range(5)}
    assert payload > 0


def test_replicate_rejects_a_basic_mode_policy(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--replicate", "3",
                    "--ship-policy", "digest:4096"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv, slice_", [
    (["--sessions", "8"], "slice C"),
    (["--listen", "127.0.0.1:7000", "--peers", "b@127.0.0.1:7001"],
     "slice C"),
    (["--arch", "gemma2-27b"], "slice E"),
])
def test_unported_modes_exit_naming_their_slice(argv, slice_, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert slice_ in capsys.readouterr().err


def test_prompt_is_the_jax_serves():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    prompt, _ = serve.make_prompt(cfg, 4, 32, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    want = np.asarray(jnp.asarray(rng.integers(0, cfg.vocab, (4, 32)),
                                  jnp.int32))
    np.testing.assert_array_equal(prompt["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-1.5b"])
def test_generate_yields_the_jax_loops_tokens(arch):
    """The JAX serve.py greedy loop and the port's ``generate`` on the same
    parameters and prompt give the same tokens."""
    b, prompt_len, gen = 2, 12, 6
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                            reduced=True)
    jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    prompt, _ = serve.make_prompt(cfg, b, prompt_len, seed=0, device="cpu")
    run = serve.generate(cfg, params, prompt, gen, keep_logits=True)

    logits, caches = jprefill(jcfg, jparams,
                              {"tokens": jnp.asarray(prompt["tokens"])},
                              max_len=prompt_len + gen)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok)]
    for k in range(gen - 1):
        pos = jnp.full((b, 1), prompt_len + k, jnp.int32)
        logits, caches = jdecode_step(jcfg, jparams, tok, pos, caches)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(run.tokens, np.concatenate(want, axis=1))
    assert len(run.logits) == gen and run.logits[0].shape == (b, cfg.vocab)
    np.testing.assert_allclose(run.logits[-1].numpy(),
                               np.asarray(logits[:, -1]), rtol=1e-4,
                               atol=1e-4)


def test_teacher_forcing_with_own_tokens_reproduces_the_run():
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = init_model(cfg, 3, device="cpu")
    prompt, _ = serve.make_prompt(cfg, 3, 10, seed=3, device="cpu")
    run = serve.generate(cfg, params, prompt, 5, keep_logits=True)
    forced = serve.generate(cfg, params, prompt, 5, keep_logits=True,
                            forced=torch.from_numpy(run.tokens))
    np.testing.assert_array_equal(forced.tokens, run.tokens)
    for a, b in zip(forced.logits, run.logits):
        assert torch.equal(a, b)
