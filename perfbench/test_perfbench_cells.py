"""Each cell's run rehearsed on the CPU at REDUCED sizes, through the
harness's functions (the command refuses to run without a card): a sound
run comes out correct under the cell's own limits; a run with the timed
path broken underneath, and the control in the program's place, come out
not correct."""

import copy
import time

import pytest
import torch

from perfbench import control, harness, tiny

CELLS = ["stablelm-1.6b.localsgd", "mixtral-8x22b.decode",
         "stablelm-1.6b.sync", "mixtral-8x22b.prefill"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rehearse(workload: str, seconds: float = 0.5) -> dict:
    run = harness.Run(cell=tiny.cell(workload), seed=2 ** 33 + 5,
                      seconds=seconds, trace=False, device="cpu",
                      t0=time.perf_counter())
    harness.execute(run)
    return harness.finish(run)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, one_thread):
    out = rehearse(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in tiny.cell(workload).end_to_end}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


# -- faults planted under the timed path --------------------------------------

def _state_unchanged(monkeypatch):
    import repro_torch.runtime as rt
    real = rt.make_train_step

    def make(cfg, tcfg):
        step = real(cfg, tcfg)

        def unchanged(params, opt_state, batch):
            _, _, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics
        return unchanged
    monkeypatch.setattr(rt, "make_train_step", make)


def _half_batch(monkeypatch):
    import repro_torch.runtime as rt
    real = rt.make_train_step

    def make(cfg, tcfg):
        step = real(cfg, tcfg)

        def half(params, opt_state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, opt_state, {k: v[:n] for k, v in batch.items()})
        return half
    monkeypatch.setattr(rt, "make_train_step", make)


def _no_exchange(monkeypatch):
    from repro_torch.core import sim
    monkeypatch.setattr(sim.Simulator, "send", lambda self, s, d, m: None)


def _cache_unchanged(monkeypatch):
    import repro_torch.models as models
    real = models.decode_step

    def step(cfg, params, tokens, pos, caches):
        logits, _ = real(cfg, params, tokens, pos, copy.deepcopy(caches))
        return logits, caches
    monkeypatch.setattr(models, "decode_step", step)


def _token_altered(monkeypatch):
    import repro_torch.models as models
    # restored at teardown to what it is now
    monkeypatch.setattr(models, "decode_step", models.decode_step)
    control.token_altered()


FAULTS = [
    ("stablelm-1.6b.sync", _state_unchanged),
    ("stablelm-1.6b.sync", _half_batch),
    ("stablelm-1.6b.localsgd", _state_unchanged),
    ("stablelm-1.6b.localsgd", _half_batch),
    ("stablelm-1.6b.localsgd", _no_exchange),
    ("mixtral-8x22b.decode", _cache_unchanged),
    ("mixtral-8x22b.decode", _token_altered),
    ("mixtral-8x22b.prefill", _cache_unchanged),
    ("mixtral-8x22b.prefill", _token_altered),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch,
                                      one_thread):
    fault(monkeypatch)
    out = rehearse(workload)
    assert not out["correct"], out["checks"]


# -- the control: the reference at float8 in the program's place ---------------

@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, one_thread):
    readings: dict = {}
    cell = tiny.cell(workload)
    driver = cell.mix["driver"]
    undo = [(control._patch_serve if driver == "serve"
             else control._patch_train)(readings, True)]
    if driver == "localsgd":
        undo.append(control._patch_outer(readings, True))
    try:
        run = harness.Run(cell=cell, seed=2 ** 33 + 9, seconds=0.5,
                          trace=False, device="cpu", t0=time.perf_counter())
        harness.execute(run)
    finally:
        for u in undo:
            u()
    fp8 = readings["control_fp8"]
    assert any(fp8[name] > limit for name, limit in cell.limits.items()
               if name in fp8), (fp8, cell.limits)
