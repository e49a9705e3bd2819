"""Wire compatibility of the port with the JAX package: store, value,
digest and engine frames encode to identical bytes in both packages
(f32, f16 and bf16 columns, compressed or not, digest-filtered), and a
frame either package encodes decodes in the other to the same state."""

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.digest as rdigest
import repro.core.store as rstore
import repro.core.tensor_lattice as rtl
import repro.wire.codec as rcodec
import repro.wire.frames as rframes
import repro_torch.core.digest as tdigest
import repro_torch.wire.codec as tcodec
import repro_torch.wire.frames as tframes
from repro_torch import convert
from repro_torch.dtypes import to_numpy

CHUNK = 16
NP_DTYPE = {"float32": np.float32, "float16": np.float16,
            "bfloat16": ml_dtypes.bfloat16}


def plain_store(seed, dtype="float32", version=1, sparse_keys=("k1",),
                sizes=(3, 5, 2)):
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(sizes):
        key = f"k{i}"
        tensors = {}
        for t in ("a", "b"):
            if key in sparse_keys:
                idx = np.sort(rng.choice(n, size=2, replace=False)).astype(
                    np.int32)
                vals = rng.normal(size=(2, CHUNK)).astype(NP_DTYPE[dtype])
                tensors[t] = (vals, np.full(2, version * 4 + 3, np.int32),
                              (idx, n))
            else:
                vals = rng.normal(size=(n, CHUNK)).astype(NP_DTYPE[dtype])
                vers = rng.integers(0, 4, size=n).astype(np.int32) + version
                vals[vers == 0] = 0
                tensors[t] = (vals, vers, None)
        out[key] = (tensors, version + i)
    return out


def ref_store(entries, life=()):
    out = {}
    for key, (tensors, lamport) in entries.items():
        chunks = {}
        for name, (vals, vers, sp) in tensors.items():
            chunks[name] = (rtl.ChunkedTensor(vals, vers) if sp is None
                            else rtl.sparse_chunks(sp[1], sp[0], vals, vers))
        out[key] = rtl.TensorState.of(chunks, lamport=lamport)
    return rstore.LatticeStore.of(out, dict(life))


def port_store(entries, life=()):
    return convert.store_from_numpy(entries, life, device="cpu")


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def canonical(store):
    """Dense bits per (key, tensor) of either package's store."""
    out = {}
    for key, val in store.entries:
        for name, ct in val.chunks:
            if ct.is_sparse:
                ct = ct.to_dense()
            v = _np(ct.values)
            out[(key, name)] = (v.view(f"u{v.dtype.itemsize}").tobytes(),
                                _np(ct.versions).tobytes())
        out[(key, "·lamport")] = val.lamport
    out["·life"] = tuple(store.life)
    return out


LIFE = [("k0", (2, 11.5)), ("k2", (0, 3.0))]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
def test_store_body_bytes_identical_and_cross_decodable(dtype, compress):
    p = plain_store(1, dtype)
    r, t = ref_store(p, LIFE), port_store(p, LIFE)
    rb = rcodec.encode_store(r, compress=compress)
    tb = tcodec.encode_store(t, compress=compress)
    assert tb == rb
    # port decodes the reference's bytes and vice versa
    assert canonical(tcodec.decode_store(rb)) == canonical(r)
    back = rcodec.decode_store(tb)
    if dtype == "bfloat16":       # the reference reads '<V2' as raw voids
        assert canonical(back) == canonical(r)
    else:
        assert back == r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_value_bodies_identical_for_store_and_bare_tensorstate(dtype):
    p = plain_store(2, dtype, sparse_keys=())
    r, t = ref_store(p), port_store(p)
    assert tcodec.encode_value(t) == rcodec.encode_value(r)
    assert tcodec.encode_value(t.get("k1")) == rcodec.encode_value(
        r.get("k1"))
    got = tcodec.decode_value(rcodec.encode_value(r.get("k1")))
    assert canonical(tstore_of(got)) == canonical(rstore.LatticeStore.of(
        {"k": r.get("k1")}))
    assert tcodec.decode_value(rcodec.encode_value(("x", 3))) == ("x", 3)


def tstore_of(ts):
    from repro_torch.core.store import LatticeStore
    return LatticeStore.of({"k": ts})


def test_digest_bodies_identical_and_filter_responses_identical():
    p = plain_store(3)
    q = plain_store(4, version=2, sparse_keys=("k0",))
    r, t = ref_store(p, LIFE), port_store(p, LIFE)
    rq, tq = ref_store(q), port_store(q)
    rd, td = rdigest.store_digest(rq), tdigest.store_digest(tq)
    assert tcodec.encode_digest(td) == rcodec.encode_digest(rd)
    # each package decodes the other's digest to the same columns
    td2 = tcodec.decode_digest(rcodec.encode_digest(rd))
    assert td2 == td and td2.life == rd.life
    # the responder's filtered body (digest-sync) is byte-identical
    rresp = rcodec.encode_store(r, known_versions=rd.tensors,
                                known_opaque=rd.opaque,
                                known_life=rd.life)
    tresp = tcodec.encode_store(t, known_versions=td.tensors,
                                known_opaque=td.opaque, known_life=td.life)
    assert tresp == rresp
    assert tcodec.store_body_is_empty(tresp) == rcodec.store_body_is_empty(
        rresp)


def test_empty_store_and_life_only_bodies():
    from repro_torch.core.store import LatticeStore as TStore
    assert tcodec.encode_store(TStore()) == rcodec.encode_store(
        rstore.LatticeStore())
    assert tcodec.store_body_is_empty(tcodec.encode_store(TStore()))
    life_only = TStore.life_delta("gone", (3, float("-inf")))
    rlife = rstore.LatticeStore.life_delta("gone", (3, float("-inf")))
    assert tcodec.encode_store(life_only) == rcodec.encode_store(rlife)
    assert not tcodec.store_body_is_empty(tcodec.encode_store(life_only))


@pytest.mark.parametrize("msg_kind", ["basic", "causal", "state", "handoff",
                                      "digest", "digest-resp", "ack",
                                      "reap", "reap-ack"])
def test_engine_frames_identical_both_ways(msg_kind):
    p = plain_store(5)
    q = plain_store(6, version=3, sparse_keys=())
    r, t = ref_store(p, LIFE), port_store(p, LIFE)
    rq, tq = ref_store(q), port_store(q)
    msgs = {
        "basic": (("delta", r), ("delta", t), {}),
        "causal": (("delta", r, 7, rq), ("delta", t, 7, tq), {}),
        "state": (("delta", r), ("delta", t), {"full_state": True}),
        "handoff": (("handoff", r), ("handoff", t), {}),
        "digest": (("digest", rdigest.store_digest(rq)),
                   ("digest", tdigest.store_digest(tq)), {}),
        "digest-resp": (("digest-resp", r, rdigest.store_digest(rq)),
                        ("digest-resp", t, tdigest.store_digest(tq)), {}),
        "ack": (("ack", 42), ("ack", 42), {}),
        "reap": (("reap", "k1", 2, 5.0), ("reap", "k1", 2, 5.0), {}),
        "reap-ack": (("reap-ack", "k1", 2, 5.0, 1),
                     ("reap-ack", "k1", 2, 5.0, 1), {}),
    }
    rmsg, tmsg, kw = msgs[msg_kind]
    rf = rframes.WireCodec().encode_msg(rmsg, **kw)
    tf = tframes.WireCodec().encode_msg(tmsg, **kw)
    assert bytes(tf) == bytes(rf) and tf.kind == rf.kind
    got = tframes.WireCodec(to_device=True, device="cpu").decode_msg(rf)
    want = rframes.WireCodec().decode_msg(rf)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        if isinstance(w, rstore.LatticeStore):
            assert canonical(g) == canonical(w)
        elif isinstance(w, rdigest.StoreDigest):
            assert set(g.tensors) == set(w.tensors) and g.life == w.life
        else:
            assert g == w


def test_frame_validation_and_stream_resync():
    t = port_store(plain_store(7))
    frame = tframes.WireCodec().encode_msg(("delta", t))
    assert tframes.peek_kind(frame) == "delta"
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(tframes.FrameError):
        tframes.decode_frame(bytes(bad))
    stream = tframes.FrameStream()
    out = stream.feed(b"junk" + bytes(bad) + bytes(frame[:10]))
    out += stream.feed(bytes(frame[10:]))
    assert [bytes(f) for f in out] == [bytes(frame)]
    assert stream.corrupt == 1


def test_decode_to_device_attaches_columns_and_counts_staging():
    from repro_torch.kernels import ops
    p = plain_store(8, sparse_keys=("k0", "k1", "k2"))
    buf = rcodec.encode_store(ref_store(p))
    snap = ops.counters.snapshot()
    d = tcodec.decode_store(buf, to_device=True, device="cpu")
    staged = ops.counters.since(snap)["h2d_bytes"]
    (g,) = d.__dict__["_device_cols"]
    assert isinstance(g.vals_dev, torch.Tensor)
    assert staged == g.vals_dev.numel() * 4 + g.vers_dev.numel() * 4
    assert canonical(d) == canonical(rcodec.decode_store(buf))


# ---------------------------------------------------------------------------
# Causal dot-store bodies and digest sections
# ---------------------------------------------------------------------------

def causal_values(C, seed):
    """One value of each causal wire type, built by the same seeded
    δ-mutations in package ``C`` (its ``crdts`` module)."""
    import random
    rng = random.Random(seed)
    out = {}
    s = C.AWORSet()
    for _ in range(12):
        s = s.join(s.add_delta(rng.choice("ab"), rng.randrange(9)))
    out["set"] = s.join(s.rmv_delta("a", sorted(s.elements())[0]))
    w = C.RWORSet()
    for _ in range(6):
        e = rng.randrange(4)
        w = w.join(w.add_delta("b", e) if rng.random() < 0.6
                   else w.rmv_delta("b", e))
    out["rw"] = w
    m = C.MVRegister()
    for v in ("x", ("y", 2), 3.5):
        m = m.join(m.write_delta(rng.choice("ab"), v))
    out["reg"] = m
    out["ew"] = C.EWFlag().enable_full("a").disable_full("b").enable_full(
        "c")
    out["dw"] = C.DWFlag().disable_full("a")
    o = C.ORMap()
    for r in range(6):
        for status in ("queued", "done"):
            o = o.join(o.apply_delta(f"gw{r % 3}", f"req{r}", C.MVRegister,
                                     "write_delta", status))
    out["map"] = o.join(o.rmv_delta("gw0", "req4"))
    return out


def _causal_stores(seed, life=()):
    from repro.core import crdts as rcrdts
    from repro_torch.core import crdts as tcrdts
    from repro_torch.core.store import LatticeStore as TStore
    rv, tv = causal_values(rcrdts, seed), causal_values(tcrdts, seed)
    return (rstore.LatticeStore.of(rv, dict(life)), TStore.of(tv, dict(life)),
            rv, tv)


def _canon_value(v):
    from repro_torch.core import dotcols as tdc
    from repro_torch.core.digest import _canon
    return _canon(tdc.value_to_obj(v))


@pytest.mark.parametrize("compress", [False, True])
def test_causal_bodies_identical_and_cross_decodable(compress):
    """Every causal type rides as a dot-column body byte-identical to the
    JAX package's (mixed with tensors and life entries), and each package
    decodes the other's bytes to equal values."""
    from repro.core import dotcols as rdc
    from repro.core.digest import _canon as rcanon
    from repro_torch.core.store import LatticeStore as TStore
    _, _, rv, tv = _causal_stores(11)
    p = plain_store(1)
    r = rstore.LatticeStore.of({**rv, **dict(ref_store(p).entries)},
                               dict(LIFE))
    t = TStore.of({**tv, **dict(port_store(p).entries)}, dict(LIFE))
    rb = rcodec.encode_store(r, compress=compress)
    tb = tcodec.encode_store(t, compress=compress)
    assert tb == rb
    back = tcodec.decode_store(rb)
    assert back.life == t.life
    for key, val in tv.items():
        got = back.get(key)
        assert got.store.columnar and got == val
        want = rcodec.decode_store(tb).get(key)
        assert _canon_value(got) == rcanon(rdc.value_to_obj(want))
    assert canonical(back.restrict(["k0", "k1", "k2"])) == canonical(
        tcodec.decode_store(tcodec.encode_store(port_store(p, LIFE))))


def _ahead(C, vals, seed):
    """``vals`` a few δ-mutations further: a removed map key, a new
    element, a rewritten register."""
    import random
    rng = random.Random(seed)
    out = dict(vals)
    m = out["map"]
    out["map"] = m.join(m.rmv_delta("gw1", "req1"))
    s = out["set"]
    out["set"] = s.join(s.add_delta("c", rng.randrange(9)))
    g = out["reg"]
    out["reg"] = g.join(g.write_delta("c", "z"))
    return out


def test_causal_digest_sections_identical_and_filter_identical():
    """Digests of causal keys are byte-identical, decode to equal
    per-dot summaries either way, and the responder's per-dot filtered
    body is byte-identical; joining it gives the responder's state."""
    from repro.core import crdts as rcrdts
    from repro_torch.core import crdts as tcrdts
    from repro_torch.core.store import LatticeStore as TStore
    _, _, rv, tv = _causal_stores(12)
    r = rstore.LatticeStore.of(_ahead(rcrdts, rv, 5))
    t = TStore.of(_ahead(tcrdts, tv, 5))
    rd = rdigest.store_digest(rstore.LatticeStore.of(rv))
    req = TStore.of(tv)
    td = tdigest.store_digest(req)
    assert set(td.causal) == set(tv) and not td.opaque
    assert tcodec.encode_digest(td) == rcodec.encode_digest(rd)
    td2 = tcodec.decode_digest(rcodec.encode_digest(rd))
    assert td2 == td
    rresp = rcodec.encode_store(r, known_opaque=rd.opaque,
                                known_life=rd.life, known_causal=rd.causal)
    tresp = tcodec.encode_store(t, known_opaque=td.opaque,
                                known_life=td.life, known_causal=td.causal)
    assert tresp == rresp
    assert not tcodec.store_body_is_empty(tresp)
    shipped = tcodec.decode_store(tresp)
    assert shipped.keys() == {"map", "set", "reg"}
    joined = req.join(shipped)
    assert joined == req.join(t) == t
    # the object-mode responder ships the same sub-delta
    assert req.join(tdigest.digest_diff(t, td)) == joined
    # a requester that holds everything gets nothing at all
    ahead = tdigest.store_digest(t)
    assert tcodec.store_body_is_empty(tcodec.encode_store(
        req, known_causal=ahead.causal, known_opaque=ahead.opaque,
        known_life=ahead.life))


def test_opaque_crdt_bodies_round_trip_port_to_port():
    """Non-causal CRDTs ride as pickles of the port's classes: they round
    trip in the port and hash like the JAX package's values (their bytes
    name each package's module, so they differ by design)."""
    from repro.core import crdts as rcrdts
    from repro.core.digest import opaque_hash as rhash
    from repro_torch.core import crdts as tcrdts
    from repro_torch.core.digest import opaque_hash as thash
    from repro_torch.core.store import LatticeStore as TStore

    def values(C):
        g = C.GCounter().inc_full("a", 3).inc_full("b")
        return {"g": g, "pn": C.PNCounter().inc_full("a", 2).dec_full("b"),
                "gs": C.GSet().add_full(("x", 1)),
                "lww": C.LWWSet().add_full("a", 4, "e").rmv_full("b", 5, "f"),
                "reg": C.LWWRegister().write_full("a", 7, {"k": 1})}
    tv, rv = values(tcrdts), values(rcrdts)
    t = TStore.of(tv)
    back = tcodec.decode_store(tcodec.encode_store(t))
    assert back == t
    assert tframes.WireCodec().decode_msg(
        tframes.WireCodec().encode_msg(("delta", tv["g"])))[1] == tv["g"]
    for key in tv:
        assert type(back.get(key)) is type(tv[key])
        assert thash(tv[key]) == rhash(rv[key])
    assert tcodec.encode_store(t) != rcodec.encode_store(
        rstore.LatticeStore.of(rv))
