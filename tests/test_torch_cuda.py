"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. Imports only torch and the port, so it runs where JAX is not
installed: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``
(skips without a card). Values, versions and max|x| are held bit-exact;
Σx² to rtol 1e-4 (the kernel sums in another order). The flash kernels
are held in f32 at rtol = atol = 2e-5 (TF32 off for the plain side), and
in bf16 / f16 to one unit in the last place of the output dtype at
max|out| (both sides compute in f32 and round once)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_join as dj
from repro_torch.kernels import flash_attention as fa
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# one unit in the last place at 1.0 (f32: the JAX package's 2e-5 bar)
ULP = {torch.float32: None, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def _assert_attention_close(got, want):
    if ULP[got.dtype] is None:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        tol = ULP[got.dtype] * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol)


def _randn(shape, dtype, dev, gen):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


FLASH_CASES = [
    # b, h, kv, s, hd, options
    (1, 4, 4, 256, 64, {}),                                # MHA
    (2, 8, 2, 256, 64, {"window": 48}),                    # GQA + window
    (1, 4, 1, 512, 128, {"softcap": 30.0}),                # MQA + softcap
    (1, 2, 2, 128, 32, {"scale": 0.0825}),
    (2, 6, 2, 100, 16, {"window": 40, "softcap": 20.0}),   # ragged
    (1, 2, 1, 130, 256, {}),                               # widest head
    (1, 3, 3, 33, 8, {}),                                  # narrow head
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kv,s,hd,opts", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, dtype, b, h, kv, s, hd,
                                              opts):
    g = torch.Generator(device=card).manual_seed(s * h + hd)
    q = _randn((b, h, s, hd), dtype, card, g)
    k = _randn((b, kv, s, hd), dtype, card, g)
    v = _randn((b, kv, s, hd), dtype, card, g)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, want)
    assert fa.launches["flash_attention"] == before + 1


def _ring(b, kv, C, hd, filled, dtype, dev, gen, empty_rows=()):
    """A ring cache after ``filled`` tokens (token t in slot t % C, the
    latest token of each slot kept); rows in ``empty_rows`` hold none."""
    k = torch.zeros((b, kv, C, hd), device=dev, dtype=dtype)
    v = torch.zeros_like(k)
    pos = np.full((b, C), -1, np.int32)
    used = np.arange(min(filled, C))
    pos[:, used] = used + C * ((filled - 1 - used) // C)
    pos[list(empty_rows)] = -1
    k[:, :, used] = _randn((b, kv, used.size, hd), dtype, dev, gen)
    v[:, :, used] = _randn((b, kv, used.size, hd), dtype, dev, gen)
    return k, v, torch.from_numpy(pos).to(dev)


DECODE_CASES = [
    # b, h, kv, C, hd, filled, options, rows with no valid slot
    (2, 4, 4, 256, 64, 256, {}, ()),                        # full cache
    (2, 8, 2, 256, 64, 100, {}, ()),                        # empty slots
    (1, 4, 1, 512, 128, 300, {"softcap": 30.0}, ()),
    (1, 4, 2, 128, 64, 300, {"window": 128}, ()),           # wrapped ring
    (2, 12, 2, 1032, 128, 1010, {"scale": 0.0825}, ()),     # ragged tiles
    (3, 4, 2, 96, 256, 50, {"window": 16}, (1,)),           # no valid slot
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kv,C,hd,filled,opts,empty", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(card, dtype, b, h, kv, C, hd,
                                           filled, opts, empty):
    g = torch.Generator(device=card).manual_seed(C + filled)
    k, v, kpos = _ring(b, kv, C, hd, filled, dtype, card, g, empty)
    q = _randn((b, h, 1, hd), dtype, card, g)
    qpos = torch.full((b, 1), filled, dtype=torch.int32, device=card)
    before = fa.launches["flash_decode"]
    got = fa.flash_decode(q, k, v, qpos, kpos, **opts)
    want = ref.decode_ref(q, k, v, qpos, kpos, **opts)
    torch.cuda.synchronize()
    _assert_attention_close(got, want)
    for r in empty:
        assert not got[r].any()        # exactly zero
    assert fa.launches["flash_decode"] == before + 1


@pytest.mark.cuda
def test_flash_kernels_take_the_models_layouts(card):
    """Strided [b, s, H, hd] / [b, C, KV, hd] views give the contiguous
    call's result, returned in the caller's memory order — on both
    prefill routes (bf16: tensor cores, f32: CUDA cores)."""
    g = torch.Generator(device=card).manual_seed(9)
    b, s, H, KV, hd = 2, 70, 6, 2, 64
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        q = _randn((b, s, H, hd), dtype, card, g)
        k = _randn((b, s, KV, hd), dtype, card, g)
        v = _randn((b, s, KV, hd), dtype, card, g)
        views = [t.transpose(1, 2) for t in (q, k, v)]
        before = fa.routes[f"flash_attention_{route}"]
        out = fa.flash_attention(*views)
        assert fa.routes[f"flash_attention_{route}"] == before + 1
        assert out.transpose(1, 2).is_contiguous()
        assert torch.equal(out, fa.flash_attention(
            *[t.contiguous() for t in views]))
        pos = torch.arange(s, dtype=torch.int32,
                           device=card)[None].repeat(b, 1)
        qpos = torch.full((b, 1), s - 1, dtype=torch.int32, device=card)
        dec = fa.flash_decode(views[0][:, :, -1:], views[1], views[2], qpos,
                              pos)
        assert torch.equal(dec, fa.flash_decode(
            views[0][:, :, -1:].contiguous(), views[1].contiguous(),
            views[2].contiguous(), qpos, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.float16, 64, "tc"), (torch.float16, 128, "tc"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float16, 256, "simt")])
def test_prefill_takes_the_route_of_its_rule(card, dtype, hd, route):
    """bf16 / f16 at head_dim 64 or 128 launch the tensor-core kernel,
    everything else the CUDA-core one; both match the plain version."""
    assert fa.prefill_route(dtype, hd) == route
    g = torch.Generator(device=card).manual_seed(hd)
    q = _randn((1, 4, 200, hd), dtype, card, g)
    k = _randn((1, 2, 200, hd), dtype, card, g)
    v = _randn((1, 2, 200, hd), dtype, card, g)
    before = dict(fa.routes)
    got = fa.flash_attention(q, k, v, window=90)
    torch.cuda.synchronize()
    _assert_attention_close(got, ref.attention_ref(q, k, v, window=90))
    other = "simt" if route == "tc" else "tc"
    assert fa.routes[f"flash_attention_{route}"] == \
        before[f"flash_attention_{route}"] + 1
    assert fa.routes[f"flash_attention_{other}"] == \
        before[f"flash_attention_{other}"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_unaligned_tensor_core_operands_take_the_cuda_core_route(card,
                                                                 dtype):
    """bf16 / f16 at head_dim 64 whose operands start 8 bytes past a
    16-byte boundary: the prefill runs on the CUDA cores (counted under
    that route) and matches the plain version."""
    g = torch.Generator(device=card).manual_seed(3)
    wide = _randn((1, 2, 64, 72), dtype, card, g)
    q = wide[..., 4:68]                   # 8-byte offset: not 16-byte aligned
    assert fa.prefill_route(dtype, 64) == "tc"
    before = dict(fa.routes)
    got = fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    _assert_attention_close(got, ref.attention_ref(q, q, q))
    assert fa.routes["flash_attention_simt"] == \
        before["flash_attention_simt"] + 1
    assert fa.routes["flash_attention_tc"] == before["flash_attention_tc"]


@pytest.mark.cuda
def test_decode_rules_take_the_cards_sm_count(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert fa.sm_count(card) == sms
    assert fa.decode_splits(1, 1, 1 << 20, 128, sms)[0] >= 2 * sms


SPLIT_CASES = [
    # b, h, kv, C, hd, filled, options, rows with no valid slot
    (2, 4, 2, 1, 64, 1, {}, ()),                            # C = 1
    (2, 6, 2, 20, 128, 20, {}, ()),                         # C < one split
    (2, 4, 2, 300, 64, 300, {"softcap": 30.0}, ()),         # ragged split
    (1, 8, 2, 256, 64, 256, {"window": 40}, ()),            # masked splits
    (2, 4, 1, 128, 128, 300, {"window": 100}, (1,)),        # ring + window
    (2, 6, 2, 70, 36, 60, {}, ()),                          # unaligned rows
    (1, 16, 8, 32768, 64, 32000, {"window": 20000}, ()),    # 4-tile splits
    (1, 32, 4, 65536, 64, 65000, {"softcap": 30.0}, ()),    # G = 8, 4 tiles
    (1, 32, 2, 300, 36, 250, {"window": 200}, ()),          # 4 threads a slot
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kv,C,hd,filled,opts,empty", SPLIT_CASES)
def test_flash_decode_split_edges(card, dtype, b, h, kv, C, hd, filled, opts,
                                  empty):
    """The split decode at the edges of its split: one slot, fewer slots
    than a split, a short last split, splits with no valid slot (ahead of
    a window), a wrapped ring with a window and an empty row, rows that do
    not start 16-byte aligned (element copies), splits of several tiles
    streaming through the ring, and four threads a slot (long dots, few
    blocks)."""
    g = torch.Generator(device=card).manual_seed(C + hd)
    k, v, kpos = _ring(b, kv, C, hd, filled, dtype, card, g, empty)
    q = _randn((b, h, 1, hd), dtype, card, g)
    qpos = torch.full((b, 1), filled, dtype=torch.int32, device=card)
    got = fa.flash_decode(q, k, v, qpos, kpos, **opts)
    want = ref.decode_ref(q, k, v, qpos, kpos, **opts)
    torch.cuda.synchronize()
    _assert_attention_close(got, want)
    for r in empty:
        assert not got[r].any()        # exactly zero


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_is_deterministic(card, dtype):
    """Two identical launches give the same bits: the splits merge in one
    fixed order, with no float atomics."""
    g = torch.Generator(device=card).manual_seed(5)
    k, v, kpos = _ring(2, 2, 1016, 128, 1008, dtype, card, g)
    q = _randn((2, 12, 1, 128), dtype, card, g)
    qpos = torch.full((2, 1), 1008, dtype=torch.int32, device=card)
    assert fa.decode_splits(2, 2, 1016, fa.decode_tile(128, 2))[0] > 1
    one = fa.flash_decode(q, k, v, qpos, kpos)
    two = fa.flash_decode(q, k, v, qpos, kpos)
    assert torch.equal(_bits(one), _bits(two))


# ---------------------------------------------------------------------------
# The causal joins' containment mask (repro_torch.core.dotcols)
# ---------------------------------------------------------------------------

def _mask_operands(n, n_rids, with_cloud, seed, top=False):
    """``n`` sorted packed dots over ``n_rids`` replicas (the last ones of
    a 2^15-entry rid table when ``top``), a dense vv column, and a sorted
    cloud of dots above it."""
    from repro_torch.core.dotcols import SEQ_BITS
    rng = np.random.default_rng(seed)
    size = 1 << 15 if top else n_rids
    hot = np.arange(size - n_rids, size, dtype=np.int64)
    vv = np.zeros(size, np.int64)
    vv[hot] = rng.integers(0, 1 << 20, n_rids)
    dots = np.unique((hot[rng.integers(0, n_rids, n)] << SEQ_BITS)
                     | rng.integers(1, 1 << 21, n).astype(np.int64))
    cloud = np.zeros(0, np.int64)
    if with_cloud:
        above = dots[(dots & ((1 << SEQ_BITS) - 1)) > vv[dots >> SEQ_BITS]]
        cloud = np.unique(rng.choice(above, min(above.size, 4099)))
    return vv, cloud, dots


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 131071, 262147])
@pytest.mark.parametrize("with_cloud", [False, True])
@pytest.mark.parametrize("top", [False, True])
def test_device_mask_matches_numpy(card, n, with_cloud, top):
    from repro_torch.core import dotcols
    vv, cloud, dots = _mask_operands(n, 7, with_cloud, n + top, top)
    want = dotcols.missing_mask(vv, cloud, dots, backend="numpy")
    with dotcols.mask_device(card):
        got = dotcols.missing_mask(vv, cloud, dots, backend="torch")
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_auto_dispatched_mask_launches_on_the_card_and_counts_staging(card):
    """At ``_DEVICE_MIN_ROWS`` rows the default scope sends the mask to
    the card: one launch, the three int64 columns staged, the bool mask
    fetched back. One row fewer stays on numpy with no launch."""
    from repro_torch.core import dotcols
    vv, cloud, dots = _mask_operands(3 * dotcols._DEVICE_MIN_ROWS, 5, True,
                                     11)
    dots = dots[:dotcols._DEVICE_MIN_ROWS]
    want = dotcols.missing_mask(vv, cloud, dots, backend="numpy")
    before = dotcols.launches["missing_mask"]
    snap = ops.counters.snapshot()
    np.testing.assert_array_equal(dotcols.missing_mask(vv, cloud, dots),
                                  want)
    moved = ops.counters.since(snap)
    assert dotcols.launches["missing_mask"] == before + 1
    assert moved["launches"] == 1
    assert moved["h2d_bytes"] == vv.nbytes + cloud.nbytes + dots.nbytes
    assert moved["d2h_bytes"] == dots.size
    dotcols.missing_mask(vv, cloud, dots[:-1])
    assert dotcols.launches["missing_mask"] == before + 1


# ---------------------------------------------------------------------------
# Resident stores gossiping over TCP loopback
# ---------------------------------------------------------------------------

NET_KEYS = 4
NET_ROWS = 1024                         # per key: [4096, 1024] f32 in all
NET_CHUNK = 1024


def _net_store_run(dev, policy, rounds, rows_per_write, seed):
    """Three ``GossipNode``s over TCP on loopback, each with a resident
    basic-mode store on ``dev`` that loaded the same initial state; each
    round every member writes ``rows_per_write`` rows of one key (a
    delta-group of two δ-mutations) and the mesh gossips until every
    version digest agrees. Returns the stores, a numpy last-writer-wins
    replay of every write, and the kernel launches the run made, read
    from the kernels' own counts and from ``trace_kernel_launches``."""
    import asyncio
    import random

    from repro_torch.core import LatticeStore, StoreReplica, TensorState
    from repro_torch.core.digest import store_digest
    from repro_torch.core.propagation import make_policy, stable_seed
    from repro_torch.core.tensor_lattice import ChunkedTensor, make_version
    from repro_torch.net import start_cluster, stop_cluster, wait_converged
    from repro_torch.obs import Tracer, trace_kernel_launches
    from repro_torch.wire import WireCodec

    rng = np.random.default_rng(seed)
    init = rng.standard_normal((NET_KEYS, NET_ROWS, NET_CHUNK),
                               dtype=np.float32)
    want_vals = init.copy()
    want_vers = np.full((NET_KEYS, NET_ROWS), make_version(1, 0), np.int32)

    def factory(node_id, neighbors):
        return StoreReplica(
            node_id, list(neighbors), causal=False, resident=True,
            device=dev, wire=WireCodec(to_device=True, device=dev),
            policy=make_policy(policy),
            rng=random.Random(stable_seed(node_id)))

    async def scenario():
        nodes = await start_cluster(3, transport="tcp", tick=0.05,
                                    replica_factory=factory,
                                    start_gossip=False, seed=seed)
        try:
            for n in nodes:
                n.replica.operation(lambda _s: LatticeStore.of({
                    f"k{k}": TensorState.of({"w": ChunkedTensor(
                        torch.from_numpy(init[k]), torch.full(
                            (NET_ROWS,), make_version(1, 0),
                            dtype=torch.int32))}, lamport=1)
                    for k in range(NET_KEYS)}))
            for n in nodes:
                await n.start()

            def agreed():
                d0 = store_digest(nodes[0].replica.store)
                return all(store_digest(n.replica.store) == d0
                           for n in nodes[1:])

            for _ in range(rounds):
                for rank, n in enumerate(nodes):
                    k = int(rng.integers(NET_KEYS))
                    sel = np.sort(rng.choice(NET_ROWS, rows_per_write,
                                             replace=False))
                    cut = rows_per_write * 5 // 8
                    i1, i2 = sel[:cut], sel[rows_per_write - cut:]
                    v1 = rng.standard_normal((len(i1), NET_CHUNK),
                                             dtype=np.float32)
                    v2 = rng.standard_normal((len(i2), NET_CHUNK),
                                             dtype=np.float32)
                    cur = n.replica.get(f"k{k}", TensorState)
                    d1 = cur.write_delta(rank, "w", torch.from_numpy(v1)
                                         .to(dev), chunk_idx=i1)
                    d2 = d1.write_delta(rank, "w", torch.from_numpy(v2)
                                        .to(dev), chunk_idx=i2)
                    n.replica.put(f"k{k}", d1.join(d2))
                    for idx, v, d in ((i1, v1, d1), (i2, v2, d2)):
                        ver = make_version(d.lamport, rank)
                        take = ver > want_vers[k, idx]
                        want_vals[k, idx[take]] = v[take]
                        want_vers[k, idx[take]] = ver
                await wait_converged(nodes, timeout=60.0, poll=0.02,
                                     settle=agreed)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            for n in nodes:
                n.check_healthy()
            return [n.replica.store for n in nodes]
        finally:
            await stop_cluster(nodes)

    tracer = Tracer(node="net", capacity=1 << 16)
    before = dict(dj.launches)
    uninstall = trace_kernel_launches(tracer)
    try:
        stores = asyncio.run(scenario())
    finally:
        uninstall()
    launched = {k: dj.launches[k] - before[k] for k in before}
    traced = {}
    for e in tracer.events():
        traced[e["op"]] = traced.get(e["op"], 0) + 1
    return stores, want_vals, want_vers, launched, traced


@pytest.mark.cuda
@pytest.mark.parametrize("rounds,rows_per_write", [(4, 64), (2, 512)])
def test_resident_stores_converge_over_tcp_equal_to_the_replay(
        card, rounds, rows_per_write):
    """Under ``digest-sync``: basic-mode push policies re-ship the whole
    store whenever their buffer is empty (``ROADMAP.md`` §3), which at
    16 MB a member every tick floods loopback."""
    from repro_torch.kernels import resident

    stores, vals, vers, launched, traced = _net_store_run(
        "cuda", "digest-sync", rounds=rounds,
        rows_per_write=rows_per_write, seed=3 + rounds)
    for store in stores:
        cache = resident.ensure(store, "cuda")
        assert [(key, s, e) for key, _, s, e in cache.layout] == [
            (f"k{k}", k * NET_ROWS, (k + 1) * NET_ROWS)
            for k in range(NET_KEYS)]
        assert np.array_equal(cache.vers.cpu().numpy(), vers.reshape(-1))
        assert np.array_equal(cache.vers_host, vers.reshape(-1))
        got = cache.vals.cpu().numpy().reshape(vals.shape)
        assert np.array_equal(got.view(np.int32), vals.view(np.int32))
    assert launched["scatter_join"] > 0 and launched["delta_join"] > 0
    assert launched["chunk_digest"] > 0
    for name, n in launched.items():
        assert traced.get(name, 0) == n, (name, n, traced)
