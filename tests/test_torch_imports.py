"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` imports with ``jax`` and the JAX package blocked, and
none of them loads either. ``chip_smoke.py`` refuses to run, printing no
result, without a card."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")) \
                or name == "repro" or name.startswith("repro."):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "repro")
                or m.startswith(("jax.", "jaxlib.", "repro.")))
print(len(names), loaded)
assert not loaded, loaded
"""


def test_port_and_smoke_import_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")], "repro_torch."))
    assert n_modules == expected >= 15


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (as here) — and in a directory holding nothing of the
    repository but the script — it exits non-zero with no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("name", [
    "topology", "core.hiergossip", "lifecycle.reaper", "sync",
    "sync.membership", "sync.metrics", "obs", "obs.registry", "obs.trace",
    "obs.probes", "obs.scrape", "obs.analyze", "net", "net.stats",
    "net.transport", "net.node", "tree", "optim", "optim.adamw", "data",
    "data.synthetic", "runtime", "runtime.steps", "checkpoint",
    "checkpoint.store", "sync.compression", "sync.localsgd",
    "launch.train",
])
def test_replication_stack_modules_are_walked(name):
    """The modules of the replication stack and of training (slices
    E-train and D) are part of the package the probe above imports with
    ``jax`` and ``repro`` blocked."""
    walked = {m.name for m in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")], "repro_torch.")}
    assert f"repro_torch.{name}" in walked
