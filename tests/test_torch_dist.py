"""The port's distribution layer against the JAX package's, on the same
inputs and without a process group (the meshes are axis-size mappings):

* ``spec_for`` / ``make_rules`` (single pod, multi-pod, ``serve=True``) /
  ``param_pspecs`` / ``batch_pspecs`` for every config id, full and
  REDUCED, on (16, 16) and (2, 16, 16): the port's ``logical_specs`` and
  ``meta`` parameters against the reference's ``init_model`` specs under
  ``jax.eval_shape`` (as its ``abstract_model`` captures them), fallback
  lists included; ``opt_state_pspecs``;
* ``collective_bytes`` / ``collective_count`` / ``cross_pod_bytes`` on
  the HLO of ``tests/test_dist.py`` and on explicit, iota and
  transposed-iota replica groups; ``recorded_collective_bytes`` charges
  the same ring costs;
* ``roofline`` with explicit constants, and the H100 defaults;
* ``applicable`` over every id × shape, ``input_specs`` shapes and dtypes
  against the reference's ``ShapeDtypeStruct``s, ``smoke_batch`` bit for
  bit;
* the ``report.py`` tables on the same JSON rows (the port's wording
  names the H100 mesh);
* ``models.hints``: ``hint_spec`` follows the reference's mapping rule.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPE_CASES as JSHAPES
from repro.configs import applicable as japplicable
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import smoke_batch as jsmoke_batch
from repro.dist import hlo as jhlo
from repro.dist import shardings as jsh
from repro.dist.roofline import roofline as jroofline
from repro.launch import report as jreport
from repro.launch.dryrun import abstract_model
from repro.optim.adamw import opt_state_pspecs as jopt_pspecs
from repro_torch.configs import (ARCH_IDS, SHAPE_CASES, applicable,
                                 get_config, input_specs, smoke_batch)
from repro_torch.dist import hlo, shardings as sh
from repro_torch.dist.roofline import HBM_BW, ICI_BW, PEAK_FLOPS, roofline
from repro_torch.launch import report
from repro_torch.models import init_model
from repro_torch.models.hints import default_rules, hint_spec
from repro_torch.models.transformer import logical_specs
from repro_torch.optim import opt_state_pspecs
from repro_torch.tree import leaves

from test_dist import HLO

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _Mesh:
    """What ``repro.dist.shardings`` reads of a mesh: ``.shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _as_tuple(spec):
    return tuple(spec)


def _jspecs(jtree):
    return [_as_tuple(s) for s in jax.tree_util.tree_leaves(
        jtree, is_leaf=lambda x: isinstance(x, JP))]


def _specs(tree):
    return [_as_tuple(s) for s in leaves(tree, is_leaf=sh.is_spec)]


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,logical", [
    ((160, 5120, 1536), ("expert", "embed", "mlp")),
    ((8, 6144, 16384), ("expert", "embed", "mlp")),
    ((5120, 1536), ("embed", "mlp")),
    ((48, 128), ("embed", "mlp")),
    ((1024,), ("lora",)),
    ((103, 48), ("vocab", "embed")),
    ((7, 24, 40), ("layers", "heads", None)),
])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("serve", [False, True])
def test_spec_for_and_make_rules_match_jax(shape, logical, mesh, serve):
    jr = jsh.make_rules(_Mesh(MESHES[mesh]), serve=serve)
    r = sh.make_rules(MESHES[mesh], serve=serve)
    assert (r.batch_axes, r.candidates) == (jr.batch_axes, jr.candidates)
    assert _as_tuple(sh.spec_for(shape, logical, r)) == \
        _as_tuple(jsh.spec_for(shape, logical, jr))
    assert r.fallbacks == jr.fallbacks


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_pspecs_match_jax_for_every_config(arch, reduced):
    jparams, jlogical = abstract_model(jget_config(arch, reduced=reduced))
    cfg = get_config(arch, reduced=reduced)
    params = init_model(cfg, device="meta")
    logical = logical_specs(cfg)
    # the logical-name tree, leaf for leaf
    jl = [tuple(t) for t in jax.tree_util.tree_leaves(
        jlogical, is_leaf=lambda x: isinstance(x, tuple))]
    assert [tuple(t) for t in leaves(logical, is_leaf=lambda x:
                                     isinstance(x, tuple))] == jl
    assert [tuple(p.shape) for p in leaves(params)] == \
        [tuple(p.shape) for p in jax.tree_util.tree_leaves(jparams)]
    for name, shape in MESHES.items():
        for serve in (False, True):
            jr = jsh.make_rules(_Mesh(shape), serve=serve)
            r = sh.make_rules(shape, serve=serve)
            jps = jsh.param_pspecs(jparams, jlogical, jr)
            ps = sh.param_pspecs(params, logical, r)
            assert _specs(ps) == _jspecs(jps), (name, serve)
            assert r.fallbacks == jr.fallbacks, (name, serve)
            jo = jopt_pspecs(jps)
            o = opt_state_pspecs(ps)
            for k in ("m", "v", "master"):
                assert _specs(o[k]) == _jspecs(jo[k])
            assert _as_tuple(o["step"]) == _as_tuple(jo["step"]) == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPE_CASES))
def test_batch_pspecs_and_input_specs_match_jax(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jcase, case = JSHAPES[shape], SHAPE_CASES[shape]
    assert applicable(cfg, case) == japplicable(jcfg, jcase)
    if not applicable(cfg, case)[0]:
        return
    jb, b = jinput_specs(jcfg, jcase), input_specs(cfg, case)
    jl = jax.tree_util.tree_leaves(jb)
    tl = leaves(b)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert [str(x.dtype).replace("torch.", "") for x in tl] == \
        [str(x.dtype) for x in jl]
    assert all(x.device.type == "meta" for x in tl)
    for mshape in MESHES.values():
        jr, r = jsh.make_rules(_Mesh(mshape)), sh.make_rules(mshape)
        assert _specs(sh.batch_pspecs(b, r)) == \
            _jspecs(jsh.batch_pspecs(jb, jr))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_long_context_matches_jax(arch):
    for shape in SHAPE_CASES:
        assert applicable(get_config(arch), SHAPE_CASES[shape]) == \
            japplicable(jget_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("train", [True, False])
def test_smoke_batch_is_bit_equal(arch, train):
    for reduced in (True, False):
        jcfg = jget_config(arch, reduced=reduced)
        cfg = get_config(arch, reduced=reduced)
        s = max(16, cfg.prefix_len + 8)
        jb = jsmoke_batch(jcfg, 2, s, seed=3, train=train)
        b = smoke_batch(cfg, 2, s, seed=3, train=train)
        assert sorted(b) == sorted(jb)
        for k in b:
            got = b[k]
            want = np.asarray(jb[k])
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16).numpy()
                want = want.view(np.int16)
            else:
                got = got.numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), k


# ---------------------------------------------------------------------------
# HLO ring costs and recorded collectives
# ---------------------------------------------------------------------------

GROUPS = """
  %a = f32[64,128]{1,0} all-gather(%x), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %b = bf16[256]{0} all-reduce(%y), replica_groups=[32,16]<=[512], to_apply=%sum
  %c = f32[16,8]{1,0} reduce-scatter(%z), replica_groups=[16,32]<=[32,16]T(1,0), dimensions={0}
  %d = f32[32]{0} all-to-all(%w), replica_groups=[2,256]<=[2,256]T(1,0)
  %e = (f32[4]{0}, u32[]) all-reduce-start(%v), replica_groups={{0,256}}
  %f = f32[4]{0} all-reduce-done(%e)
"""


@pytest.mark.parametrize("text", [HLO, GROUPS], ids=["test_dist", "groups"])
@pytest.mark.parametrize("n", [8, 512])
def test_collective_accounting_matches_jax(text, n):
    assert hlo.collective_bytes(text, n) == jhlo.collective_bytes(text, n)
    assert hlo.collective_count(text) == jhlo.collective_count(text)
    for pod in (4, 256):
        assert hlo.cross_pod_bytes(text, n, pod) == \
            jhlo.cross_pod_bytes(text, n, pod)


def test_recorded_collectives_take_the_ring_costs():
    recs = [("all-gather", 64 * 128 * 4, 4), ("all-reduce", 256 * 2, 16),
            ("reduce-scatter", 16 * 8 * 4, 32), ("all-to-all", 32 * 4, 256),
            ("all-reduce", 100.0, 1)]
    total, per_kind = hlo.recorded_collective_bytes(recs)
    want = {"all-gather": 64 * 128 * 4 * 3 / 4,
            "all-reduce": 2 * 256 * 2 * 15 / 16,
            "reduce-scatter": 16 * 8 * 4 * 31,
            "all-to-all": 32 * 4 * 255 / 256}
    assert per_kind == pytest.approx(want)
    assert total == pytest.approx(sum(want.values()))
    # the same lines as HLO text give the same charges
    text = "\n".join(
        f"%{i} = f32[{int(b) // 4}]{{0}} {k}(%x), replica_groups=[1,{g}]<=[{g}]"
        for i, (k, b, g) in enumerate(recs))
    assert jhlo.collective_bytes(text, 512)[1] == pytest.approx(per_kind)


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak_memory", [None, 3.5e9])
def test_roofline_matches_jax_with_explicit_constants(peak_memory):
    args = ("a", "s", "16x16", 256,
            {"flops": 197e12 * 0.5, "bytes accessed": 819e9 * 2.0},
            50e9 * 0.1, {"all-gather": 1e9, "all-reduce": 3e9},
            197e12 * 0.5 * 256 * 0.8, 4096)
    consts = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
    got = roofline(*args, peak_memory=peak_memory, **consts)
    want = jroofline(*args, peak_memory=peak_memory, **consts)
    assert json.loads(got.to_json()) == json.loads(want.to_json())


def test_roofline_defaults_are_one_h100():
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 450e9)
    rep = roofline("a", "s", "1x1", 1, {"flops": 989e12,
                                           "bytes accessed": 3.35e12},
                      450e9 * 2, {}, 989e12, 10)
    assert (rep.compute_s, rep.memory_s, rep.collective_s) == \
        pytest.approx((1.0, 1.0, 2.0))
    assert rep.bound == "collective"


# ---------------------------------------------------------------------------
# report.py
# ---------------------------------------------------------------------------

def _rows():
    base = {"arch": "qwen2-1.5b", "shape": "train_4k", "status": "ok",
            "compile_s": 8.1, "memory_analysis": {"temp_size_in_bytes": None},
            "collective_wire_bytes_per_chip": 1.2e11,
            "sharding_fallbacks": ["x"]}
    rows = []
    for mesh, bound, shape in (("16x16", "collective", "train_4k"),
                               ("16x16", "memory", "decode_32k"),
                               ("16x16", "memory", "train_4k"),
                               ("2x16x16", "compute", "prefill_32k")):
        rows.append({**base, "mesh": mesh, "shape": shape,
                     "cost_analysis": {"flops": 2e15,
                                       "bytes accessed": 2.9e13},
                     "collective_breakdown": {"all-gather": 1.1e11,
                                              "all-reduce": 4.7e10},
                     "roofline": {"compute_s": 2.0, "memory_s": 8.8,
                                  "collective_s": 0.5, "bound": bound,
                                  "useful_frac": 0.019,
                                  "roofline_frac": 0.0043}})
    rows.append({"arch": "gemma2-27b", "shape": "long_500k",
                 "mesh": "16x16", "status": "skipped", "reason": "r"})
    return rows


WORDING = [("compile s | HLO GFLOPs/chip | HBM GB/chip | wire GB/chip | "
            "temp GB/dev", "trace s | GFLOPs/H100 | HBM GB/H100 | "
            "wire GB/H100 | temp GB/H100"),
           ("at the MXU roof", "at the tensor-core roof")]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_tables_match_jax(mesh):
    rows = _rows()
    want_d, got_d = jreport.dryrun_table(rows), report.dryrun_table(rows)
    want_r = jreport.roofline_table(rows, mesh)
    got_r = report.roofline_table(rows, mesh)
    for old, new in WORDING:
        want_d, want_r = want_d.replace(old, new), want_r.replace(old, new)
    assert got_d == want_d
    assert got_r == want_r


def test_report_marks_cells_with_layout_fallbacks():
    rows = _rows()
    rows[0] = {**rows[0], "layout_fallbacks": ["attn heads(12, 2): not "
                                               "divisible by heads=16"]}
    d_lines = report.dryrun_table(rows).splitlines()[2:]
    r_lines = report.roofline_table(rows, "16x16").splitlines()[2:]
    assert [l.startswith("| qwen2-1.5b † |") for l in d_lines] == \
        [True, False, False, False, False]
    assert [l.startswith("| qwen2-1.5b † |") for l in r_lines] == \
        [True, False, False]
    assert "layout_fallbacks" in report.fallback_note(rows)
    assert report.fallback_note(_rows()) == ""


def test_report_reads_a_directory(tmp_path):
    for i, row in enumerate(_rows()):
        (tmp_path / f"{i}.json").write_text(json.dumps(row))
    assert report.load(str(tmp_path)) == jreport.load(str(tmp_path))


# ---------------------------------------------------------------------------
# Activation hints (the mapping rule; the placements on a mesh:
# test_torch_mesh.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((8, 32, 48), ("batch", None, None)),
    ((6, 32, 103), ("batch", None, "vocab")),
    ((8, 32, 96), ("batch", None, "vocab")),
    ((8, 12), ("heads", "mlp")),
    ((8, 4, 16), ("batch", "tokens", None)),
])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_hint_spec_follows_the_reference_rule(shape, axes, multi_pod):
    mesh = {"pod": 2, "data": 2, "model": 4} if multi_pod else \
        {"data": 2, "model": 4}
    rules = default_rules(multi_pod)
    # the reference's rule, written out: a dim takes its mapped axes when
    # its size divides their product and none is used yet
    want, used = [], set()
    for dim, name in zip(shape, axes):
        m = rules.get(name) if name else None
        ms = () if m is None else ((m,) if isinstance(m, str) else m)
        size = int(np.prod([mesh[a] for a in ms])) if ms else 1
        if not ms or dim % size or used & set(ms):
            want.append(None)
            continue
        used |= set(ms)
        want.append(m)
    assert tuple(hint_spec(shape, axes, mesh, rules)) == tuple(want)
