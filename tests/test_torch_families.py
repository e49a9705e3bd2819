"""The remaining dense configs of the port — gemma2-27b (local/global
windows, softcaps, post-norms, GeGLU, scaled tied embeddings),
stablelm-1.6b (layer norm, partial rotary, QKV bias),
phi-3-vision-4.2b (a patch-embedding prefix) and musicgen-large (frame
embeddings in, sinusoidal positions, GELU) — and the SSM family —
mamba2-130m (pure SSD mixer blocks, no MLP, tied embeddings) and
jamba-v0.1-52b (SSD and attention layers interleaved, dense and MoE
MLPs alternating) — against the JAX package at REDUCED size in f32:
forward, ``train_loss`` and its gradients, the chunked path, prefill
then decode at every position (the SSM configs from a chunk-aligned
split), and the parameter and cache layout (the checks and their
tolerances are in ``torch_family_checks``). Prefill-then-decode skips
phi-3-vision, as the JAX package's own smoke test does: its prefix mode
is served through ``generate``, which ``test_torch_serve`` holds to the
JAX loop. gemma2's 16-slot local ring wraps in the decode steps. Also
the helpers the ported modules lacked: ``layers.shape_of`` and
``tensor_lattice.{version_lamport, packed_size_bytes}``, exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import tensor_lattice as jtl
from repro.models import init_model as jinit_model
from repro.models import layers as jlayers
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import tensor_lattice as tl
from repro_torch.models import layers
from torch_family_checks import (check_chunked_forward,
                                 check_forward_and_gradients, check_layout,
                                 check_prefill_then_decode, np_tree,
                                 prefill_split)

DENSE = ["gemma2-27b", "stablelm-1.6b", "phi-3-vision-4.2b",
         "musicgen-large"]
SSM = ["mamba2-130m", "jamba-v0.1-52b"]
NEW = DENSE + ["mixtral-8x22b", "deepseek-v2-236b"] + SSM


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_forward_loss_and_gradients_match_jax(arch):
    check_forward_and_gradients(arch)


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_chunked_forward_matches_jax(arch):
    check_chunked_forward(arch)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-1.6b",
                                  "musicgen-large"] + SSM)
def test_prefill_then_decode_every_position_match_jax(arch, impl):
    check_prefill_then_decode(arch, impl)


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_init_model_and_caches_lay_out_like_jax(arch):
    check_layout(arch)


def test_ssm_prefill_split_is_chunk_aligned():
    """The shared check's split: half of the sequence for attention
    configs, rounded down to the SSD chunk for SSM ones (24 // 2 = 12
    → 8 at REDUCED's chunk of 8)."""
    assert prefill_split(get_config("qwen2-1.5b", reduced=True)) == 12
    for arch in SSM:
        cfg = get_config(arch, reduced=True)
        assert cfg.ssm.chunk == 8 and prefill_split(cfg) == 8


@pytest.mark.parametrize("arch", NEW)
def test_full_configs_keep_the_published_widths(arch):
    """The CONFIG the card serves is the JAX package's, and its size is
    the published one (the counts the chip run reports)."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(arch))
    assert cfg.param_counts() == jget_config(arch).param_counts()
    assert arch in ARCH_IDS


# ---------------------------------------------------------------------------
# helpers the ported modules lacked
# ---------------------------------------------------------------------------

def test_shape_of_matches_jax():
    jparams = jinit_model(jget_config("deepseek-v2-236b", reduced=True),
                          jax.random.PRNGKey(0))[0]
    params = params_from_numpy(np_tree(jparams), device="cpu")
    assert layers.shape_of(params) == jlayers.shape_of(jparams)


@pytest.mark.parametrize("lamport,rank", [(0, 0), (1, 3), (7, 1023),
                                          (2 ** 20, 5)])
def test_version_lamport_matches_jax(lamport, rank):
    v = tl.make_version(lamport, rank)
    assert v == jtl.make_version(lamport, rank)
    assert tl.version_lamport(v) == jtl.version_lamport(v) == lamport


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_size_bytes_matches_jax(dtype):
    rng = np.random.default_rng(9)
    w = rng.normal(size=(12, 16)).astype(np.float32)
    idx = np.array([1, 4, 5])
    rows = rng.normal(size=(3, 16)).astype(np.float32)
    sizes = []
    for mod, arr in ((jtl, lambda a: jnp.asarray(a, dtype)),
                     (tl, lambda a: torch.from_numpy(a).to(
                         getattr(torch, dtype)))):
        x = mod.TensorState.bottom().write_full(0, "w", arr(w),
                                                chunk_size=16)
        delta = x.write_delta(1, "w", arr(rows), chunk_idx=idx)
        wire = mod.pack_delta(delta)
        assert len(wire["tensors"]["w"][0]) == 3
        sizes.append(mod.packed_size_bytes(wire))
    itemsize = 4 if dtype == "float32" else 2
    assert sizes[0] == sizes[1] == 8 + 1 + 3 * 4 + 3 * 16 * itemsize + 3 * 4
