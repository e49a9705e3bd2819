"""The arithmetic of the two flash kernels' Hopper designs, in plain
PyTorch on the CPU (the kernels themselves run only on the card:
``test_torch_cuda.py``, ``chip_smoke.py``).

* Split decode: the wrapper's tile and split rules, per-split online
  softmax partials over tiles, and the merge in split order — held against
  the JAX package's ``flash_decode_fwd`` in interpret mode (as its own
  tests run it) at f32, rtol = atol = 2e-5, on ring, window, softcap,
  empty-row and all-masked-split inputs made with numpy.
* Tensor-core prefill precision: bf16 / f16 operands, f32 scores and
  softmax in base 2 over 64-key tiles, P split into hi + lo halves of the
  input dtype for the P V product — held against ``attention_ref`` to one
  unit in the last place of the output dtype at max|out|
  (``chip_smoke.py``'s bar) at its small prefill shapes and options.
* The prefill route rule and the decode tile and split rules.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

NEG_INF = -2.0 ** 30
LOG2E = 1.4426950408889634
TOL = dict(rtol=2e-5, atol=2e-5)
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}   # at 1.0


# ---------------------------------------------------------------------------
# Split decode
# ---------------------------------------------------------------------------

def split_decode(q, k, v, q_pos, k_pos, *, scale=None, window=None,
                 softcap=None, tile=None, per=None):
    """The decode kernel's arithmetic: slots in splits of ``per`` (the
    wrapper's rule unless given), each split an online softmax over tiles
    of ``tile`` slots giving partials (m, l, acc) per query head; then the
    splits merged in order. q [b,h,1,hd]; k,v [b,kv,C,hd]."""
    b, h, _, hd = q.shape
    kv, C = k.shape[1], k.shape[2]
    G = h // kv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    window = fa.NO_WINDOW if window is None else window
    tile = tile or fa.decode_tile(hd, q.element_size())
    if per is None:
        splits, per = fa.decode_splits(b, kv, C, tile)
    else:
        splits = max(1, -(-C // per))
    qg = q.float().reshape(b, kv, G, hd)
    kf, vf = k.float(), v.float()
    valid = (k_pos >= 0) & (k_pos <= q_pos) & (q_pos - k_pos < window)
    parts = []
    for s in range(splits):
        m = torch.full((b, kv, G), NEG_INF)
        l = torch.zeros((b, kv, G))
        acc = torch.zeros((b, kv, G, hd))
        for t0 in range(s * per, min(C, (s + 1) * per), tile):
            t1 = min(t0 + tile, (s + 1) * per, C)
            x = torch.einsum("bkgd,bktd->bkgt", qg, kf[:, :, t0:t1]) * scale
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            x = torch.where(valid[:, None, None, t0:t1], x, -torch.inf)
            m_new = torch.maximum(m, x.amax(dim=-1))
            p = torch.exp(x - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgt,bktd->bkgd", p, vf[:, :, t0:t1])
            m = m_new
        parts.append((m, l, acc))
    M = torch.full((b, kv, G), NEG_INF)
    for m, _, _ in parts:
        M = torch.maximum(M, m)
    L = torch.zeros((b, kv, G))
    O = torch.zeros((b, kv, G, hd))
    for m, l, acc in parts:                 # split order
        w = torch.exp(m - M)
        L = L + w * l
        O = O + w[..., None] * acc
    out = O / torch.where(L > 0, L, 1.0)[..., None]
    return out.reshape(b, h, 1, hd).to(q.dtype)


def _ring(b, kv, C, hd, filled, seed, empty_rows=()):
    """A ring cache after ``filled`` tokens (token t in slot t % C, the
    latest of each slot kept); rows in ``empty_rows`` hold none."""
    rng = np.random.default_rng(seed)
    k = np.zeros((b, kv, C, hd), np.float32)
    v = np.zeros((b, kv, C, hd), np.float32)
    used = np.arange(min(filled, C))
    pos = np.full((b, C), -1, np.int32)
    pos[:, used] = used + C * ((filled - 1 - used) // C)
    k[:, :, used] = rng.normal(size=(b, kv, used.size, hd))
    v[:, :, used] = rng.normal(size=(b, kv, used.size, hd))
    pos[list(empty_rows)] = -1
    return k, v, pos


SPLIT_CASES = [
    # id, b, h, kv, C, hd, filled, window, options, empty rows
    ("ring", 2, 8, 2, 256, 64, 256, None, {}, ()),
    ("masked-split", 1, 8, 2, 256, 64, 256, 40, {}, ()),
    ("wrapped-window", 1, 4, 2, 384, 64, 700, 200, {}, ()),
    ("softcap-scale", 2, 12, 2, 256, 128, 230, None,
     {"softcap": 30.0, "scale": 0.0825}, ()),
    ("empty-row", 3, 4, 2, 256, 64, 150, 64, {}, (1,)),
]
# the wrapper's tile and split rules, and small tiles and splits that give
# several tiles a split and many splits
LAYOUTS = [None, (32, 64), (32, 32)]


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["wrapper", "tile32-per64", "tile32-per32"])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_decode_matches_jax_flash_decode(case, layout):
    _, b, h, kv, C, hd, filled, window, opts, empty = case
    k, v, kpos = _ring(b, kv, C, hd, filled, seed=C + filled,
                       empty_rows=empty)
    q = np.random.default_rng(filled).normal(size=(b, h, 1, hd)).astype(
        np.float32)
    qpos = np.full((b, 1), filled, np.int32)
    tile, per = layout or (None, None)
    got = split_decode(*map(torch.from_numpy, (q, k, v, qpos, kpos)),
                       window=window, tile=tile, per=per, **opts)
    want = jops.flash_decode(
        *(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), window=window,
        block_k=64, interpret=True, **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for r in empty:
        assert not got[r].any()              # no valid slot: exactly zero


def test_split_decode_cases_reach_their_edges():
    """The cases above do hold several splits, and one whose slots are
    all masked."""
    assert fa.decode_splits(2, 2, 256, fa.decode_tile(64, 4)) == (2, 128)
    _, _, pos = _ring(1, 2, 256, 64, 256, seed=0)
    valid = (pos >= 0) & (pos <= 256) & (256 - pos < 40)
    assert not valid[:, :128].any() and valid[:, 128:].any()
    assert fa.decode_splits(1, 2, 384, fa.decode_tile(64, 4))[0] == 3


# ---------------------------------------------------------------------------
# Tensor-core prefill precision
# ---------------------------------------------------------------------------

def tc_prefill(q, k, v, *, scale=None, window=None, softcap=None, bk=64):
    """The tensor-core prefill's arithmetic: 16-bit q, k, v; f32 scores
    and online softmax in base 2 over ``bk``-key tiles; P as hi + lo
    halves of q's dtype multiplied into an f32 accumulator; one rounding
    at the end."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    G = h // kv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    qf = q.float()
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    for k0 in range(0, sk, bk):
        cols = torch.arange(k0, min(k0 + bk, sk))[None, :]
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        ok = cols <= rows
        if window is not None:
            ok &= rows - cols < window
        x = torch.where(ok, x * LOG2E, -torch.inf)
        m_new = torch.maximum(m, x.amax(dim=-1))
        p = torch.exp2(x - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(q.dtype)
        lo = (p - hi.float()).to(q.dtype)
        vt = vf[:, :, k0:k0 + bk]
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", hi.float(), vt) + torch.einsum(
            "bhqk,bhkd->bhqd", lo.float(), vt)
        m = m_new
    return (acc / torch.where(l > 0, l, 1.0)[..., None]).to(q.dtype)


# chip_smoke.py's small prefill shapes (b, h, kv, s, hd) and options
PREFILL_SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 256, 64), (1, 4, 1, 512, 128),
                  (1, 2, 2, 128, 32)]
PREFILL_OPTIONS = [{}, {"window": 48}, {"softcap": 30.0}, {"scale": 0.0825}]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("opts", PREFILL_OPTIONS,
                         ids=lambda o: str(o) or "plain")
@pytest.mark.parametrize("b,h,kv,s,hd", PREFILL_SHAPES)
def test_tc_prefill_recipe_meets_the_one_ulp_bar(b, h, kv, s, hd, opts,
                                                 dtype):
    rng = np.random.default_rng(s * h + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dtype) for shape in ((b, h, s, hd), (b, kv, s, hd),
                                             (b, kv, s, hd)))
    got = tc_prefill(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ULP[dtype] * float(want.float().abs().max())


# ---------------------------------------------------------------------------
# Route, tile and split rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.float16, 64, "tc"), (torch.float16, 128, "tc"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float16, 256, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.float16, 8, "simt")])
def test_prefill_route_rule(dtype, hd, route):
    assert fa.prefill_route(dtype, hd) == route


@pytest.mark.parametrize("hd,elem,tile", [
    (64, 2, 128), (128, 2, 128), (256, 2, 64), (64, 4, 128), (128, 4, 64),
    (256, 4, 32), (36, 2, 128), (8, 2, 128)])
def test_decode_tile_rule(hd, elem, tile):
    assert fa.decode_tile(hd, elem) == tile
    row = (-(-hd * elem // 16) + 1) * 16
    assert tile == 32 or 2 * tile * row <= fa.DECODE_STAGE_BYTES


@pytest.mark.parametrize("b,kv,C,tile", [
    (4, 16, 1032, 128), (2, 2, 1016, 128), (1, 1, 1, 128), (2, 2, 20, 128),
    (2, 2, 300, 128), (1, 8, 32768, 128), (3, 2, 96, 64), (1, 2, 0, 128),
    (1, 1, 10 ** 6, 128), (132, 1, 64, 128), (66, 1, 4096, 32)])
def test_decode_split_rule(b, kv, C, tile):
    splits, per = fa.decode_splits(b, kv, C, tile)
    assert splits >= 1 and per >= tile and per % tile == 0
    assert splits * per >= C                     # every slot has a split
    assert C == 0 or (splits - 1) * per < C      # and no split is empty
    want = -(-2 * fa.SMS // (b * kv))
    if C >= want * tile * 2:                     # room for the target
        assert splits * b * kv >= 2 * fa.SMS


def test_decode_splits_at_the_served_shapes():
    """qwen1.5-0.5b (4 rows, 16 KV heads, 1,032 slots) and qwen2-1.5b (2
    rows, 2 KV heads, 1,016 slots) in bf16: more blocks than b x h; qwen2's
    six heads a KV head on a 32-block grid take four threads a slot."""
    assert fa.decode_splits(4, 16, 1032, fa.decode_tile(64, 2)) == (9, 128)
    assert fa.decode_splits(2, 2, 1016, fa.decode_tile(128, 2)) == (8, 128)
    assert 9 * 16 * 4 > 4 * 16 and 8 * 2 * 2 > 2 * 12
    assert fa.decode_threads_per_slot(1, 64, 9 * 16 * 4) == 1
    assert fa.decode_threads_per_slot(6, 128, 8 * 2 * 2) == 4


@pytest.mark.parametrize("group,hd,blocks,tps", [
    (1, 64, 576, 1), (6, 128, 32, 4), (6, 128, 512, 1), (2, 256, 10, 1),
    (4, 128, 131, 4), (4, 128, 132, 1), (3, 128, 1, 1), (16, 36, 4, 4)])
def test_decode_threads_per_slot_rule(group, hd, blocks, tps):
    assert fa.decode_threads_per_slot(group, hd, blocks) == tps


@pytest.mark.parametrize("sms", [114, 132, 144])
def test_decode_rules_follow_the_sm_count(sms):
    """The split and threads-per-slot rules scale with the card's SMs
    (an H100 PCIe has 114, an SXM 132): a long cache fills two blocks an
    SM, and four threads a slot stop at one block an SM."""
    for b, kv in ((1, 1), (2, 2), (4, 16)):
        splits, per = fa.decode_splits(b, kv, 1 << 20, 128, sms)
        assert splits * b * kv >= 2 * sms
        assert splits * b * kv < 4 * sms or b * kv > 2 * sms
    assert fa.decode_threads_per_slot(6, 128, sms - 1, sms) == 4
    assert fa.decode_threads_per_slot(6, 128, sms, sms) == 1
    assert fa.decode_splits(1, 1, 1 << 20, 128) == fa.decode_splits(
        1, 1, 1 << 20, 128, fa.SMS)


def test_cpu_route_counts_no_kernel_route():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 16, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    before = dict(fa.routes)
    fa.flash_attention(q, k, v)
    assert fa.routes == before


def test_flash_probe_variants_match_the_kernel_source():
    """``flash_probe.py`` builds copies of the flash source with one phase
    taken out by exact substitutions: each must still match the source."""
    path = Path(__file__).resolve().parents[1] / "flash_probe.py"
    spec = importlib.util.spec_from_file_location("flash_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    text = probe.SOURCE.read_text()
    for name, (_, subs) in probe.VARIANTS.items():
        assert (probe.variant_source(text, subs) == text) == (name == "full")
