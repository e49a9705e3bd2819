"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. Imports only torch and the port, so it runs where JAX is not
installed: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``
(skips without a card). Values, versions and max|x| are held bit-exact;
Σx² to rtol 1e-4 (the kernel sums in another order)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_join as dj
from repro_torch.kernels import ops, ref

SUMSQ_RTOL = 1e-4
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# (rows, chunk): one row; ragged rows; a width whose rows are not whole
# 16-byte units (element loads); a narrow one
SHAPES = [(1, 1024), (777, 1024), (301, 100), (64, 7)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _operands(n, chunk, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    av = torch.randn((n, chunk), generator=g, device=dev).to(dtype)
    bv = torch.randn((n, chunk), generator=g, device=dev).to(dtype)
    avr = torch.randint(0, 9, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    bvr = torch.randint(0, 9, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    return av, avr, bv, bvr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,chunk", SHAPES)
def test_join_kernels_match_plain(card, dtype, n, chunk):
    av, avr, bv, bvr = _operands(n, chunk, dtype, card, n * chunk)
    before = dict(dj.launches)
    j = dj.delta_join(av, avr, bv, bvr)
    f = dj.fused_join_digest(av, avr, bv, bvr)
    want = ref.fused_join_digest_ref(av, avr, bv, bvr)
    torch.cuda.synchronize()
    for got in (j[0], f[0]):
        assert torch.equal(_bits(got), _bits(want[0]))
    assert torch.equal(j[1], want[1]) and torch.equal(f[1], want[1])
    assert torch.equal(f[2], want[2])
    torch.testing.assert_close(f[3], want[3], rtol=SUMSQ_RTOL, atol=0)
    assert dj.launches["delta_join"] == before["delta_join"] + 1
    assert dj.launches["fused_join_digest"] == \
        before["fused_join_digest"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,chunk", SHAPES)
def test_chunk_digest_kernel_matches_plain(card, dtype, n, chunk):
    x = _operands(n, chunk, dtype, card, n + chunk)[0]
    ma, ss = dj.chunk_digest(x)
    wma, wss = ref.chunk_digest_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(ma, wma)
    torch.testing.assert_close(ss, wss, rtol=SUMSQ_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,chunk", SHAPES)
def test_scatter_kernel_matches_plain_and_keeps_old_columns(card, dtype, n,
                                                            chunk):
    n = max(n, 16)
    av, avr, bv, bvr = _operands(n, chunk, dtype, card, 7 * n)
    ma, ss = ref.chunk_digest_ref(av)
    rng = np.random.default_rng(n)
    r = n // 3
    idx = np.sort(rng.choice(n - 1, size=r, replace=False))
    free = int(np.setdiff1d(np.arange(n), idx)[0])
    idx = torch.as_tensor(np.concatenate([idx, np.full(5, free)]),
                          dtype=torch.int32, device=card)
    d_vals = torch.cat([bv[:r], bv.new_zeros((5, chunk))])
    d_vers = torch.cat([bvr[:r], bvr.new_zeros(5)])
    cols = (av, avr, ma, ss)
    old = [c.clone() for c in cols]
    got = dj.scatter_join(*cols, idx, d_vals, d_vers)
    want = ref.scatter_join_ref(*cols, idx, d_vals, d_vers)
    torch.cuda.synchronize()
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(_bits(x), _bits(y))
    torch.testing.assert_close(got[3], want[3], rtol=SUMSQ_RTOL, atol=0)
    for c, o in zip(cols, old):
        assert torch.equal(_bits(c), _bits(o))


@pytest.mark.cuda
def test_digest_sums_agree_across_kernels(card):
    """chunk_digest, fused_join_digest and scatter_join reduce a row in
    the same order, so the Σx² column the resident top-k ranks on does
    not depend on which kernel last wrote a row."""
    av, avr, bv, bvr = _operands(300, 1024, torch.float32, card, 3)
    _, _, fma, fss = dj.fused_join_digest(av, avr, bv, bvr)
    merged = torch.where((bvr > avr)[:, None], bv, av)
    dma, dss = dj.chunk_digest(merged)
    idx = torch.arange(300, dtype=torch.int32, device=card)
    zero = torch.zeros(300, device=card)
    _, _, sma, sss = dj.scatter_join(merged, avr, zero, zero.clone(), idx,
                                     merged, avr)
    assert torch.equal(fss, dss) and torch.equal(sss, dss)
    assert torch.equal(fma, dma) and torch.equal(sma, dma)


@pytest.mark.cuda
def test_ops_stage_host_operands_and_count_them(card):
    av, avr, bv, bvr = _operands(8, 64, torch.float32, card, 11)
    snap = ops.counters.snapshot()
    ov, over = ops.delta_join(av, avr.cpu(), bv, bvr)
    diff = ops.counters.since(snap)
    assert ov.device.type == "cuda"
    assert diff == {"launches": 1, "h2d_bytes": 32, "d2h_bytes": 0}
    with pytest.raises(ValueError):
        dj.delta_join(av, avr.cpu(), bv, bvr)
