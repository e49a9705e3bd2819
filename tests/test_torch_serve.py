"""The port's serving entry point on the CPU: it runs at REDUCED qwen1.5 and
prints the JAX package's serve.py lines; its prompt is that script's (same
``--seed``, same token ids); its greedy loop, given the JAX package's
parameters, yields the JAX loop's tokens; teacher forcing with its own
tokens reproduces a run; ``--replicate`` gossips the batch's session
table to every status "done"; ``--sessions`` (with ``--session-ttl``)
prints the JAX package's per-gateway key counts, frame bytes and
tombstone counts on the same seed; and three socket-mode processes on
loopback agree on one session fingerprint through ``--status-file``."""

import argparse
import ast
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
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


# ---------------------------------------------------------------------------
# Keyed sessions, the key lifecycle and socket mode
# ---------------------------------------------------------------------------

def _keyed_lines(module, **kw):
    args = argparse.Namespace(**{
        "replicate": 0, "session_replication": 2, "session_ttl": None,
        "ship_policy": "bp+rr", "seed": 0, "wire": True, **kw})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module._keyed_sessions(args)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("kw", [
    dict(sessions=24, session_ttl=5.0),
    dict(sessions=24),
    dict(sessions=40, session_ttl=6.0, seed=4,
         ship_policy="bp+rr+digest-sync:4"),
    dict(sessions=16, replicate=4, session_replication=3, seed=2),
    dict(sessions=30, session_ttl=5.0, seed=1, ship_policy="digest-sync"),
    dict(sessions=12, wire=False, seed=3),
], ids=["ttl", "no-ttl", "hybrid-ttl", "4-gateways", "digest-sync-ttl",
        "objects"])
def test_keyed_sessions_print_the_reference_lines(kw):
    """Per-gateway key counts, frame bytes and tombstone counts equal the
    JAX package's, line for line. Object mode (``--no-wire``) reports
    structural atoms of each package's own objects, which differ by
    design: there the key counts and the line's shape are held equal."""
    got, want = _keyed_lines(serve, **kw), _keyed_lines(jserve, **kw)
    if kw.get("wire", True):
        assert got == want
    else:
        assert got[0] == want[0]
        assert got[1].split("payload_atoms")[0] \
            == want[1].split("payload_atoms")[0]
    assert len(got) == (3 if kw.get("session_ttl") else 2)


def test_sessions_ttl_cli_on_the_cpu_prints_the_reference_lines():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "3", "--sessions",
         "24", "--session-ttl", "5"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()[3:]
    assert lines == _keyed_lines(jserve, sessions=24, session_ttl=5.0)
    assert "all 24 sessions expired and were reaped" in lines[2]


def test_socket_mode_rejects_bad_member_lists(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--listen", "a@127.0.0.1:7000"])
    assert e.value.code == 2
    assert "BOTH" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--listen", "a@127.0.0.1:7000",
                    "--peers", "b@127.0.0.1:7001", "--no-wire"])
    assert e.value.code == 2


def _free_udp_ports(n):
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def test_three_socket_processes_agree_on_one_fingerprint(tmp_path):
    """Three ``serve --listen/--peers`` processes on loopback UDP with
    10% injected loss: every status file reaches every session "done"
    under one fingerprint, and the ``--metrics`` snapshot carries the
    ``repro_net_*`` families."""
    n_sessions = 12
    members = [f"gw{k}@127.0.0.1:{p}"
               for k, p in enumerate(_free_udp_ports(3))]
    status = [tmp_path / f"gw{k}.json" for k in range(3)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--listen", me, "--peers", ",".join(m for m in members if m != me),
         "--sessions", str(n_sessions), "--ship-policy",
         "bp+rr+digest-sync:4", "--udp-loss", "0.1", "--tick", "0.05",
         "--run-for", "8", "--status-file", str(st), "--metrics"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for me, st in zip(members, status)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert f"done: {n_sessions}/{n_sessions} keys resident" in out
    seen = [json.loads(st.read_text()) for st in status]
    assert all(s["all_done"] and s["keys"] == n_sessions for s in seen)
    assert len({s["fingerprint"] for s in seen}) == 1
    for s in seen:
        assert "repro_net_frames_sent_total" in s["metrics"]
        assert s["bytes_by_kind"].get("delta", 0) > 0
