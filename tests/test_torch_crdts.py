"""The port's δ-CRDT catalogue (``repro_torch.core.crdts``) against the JAX
package's, type by type. Seeded random executions — the same operations
on the same arguments, drawn from one ``random.Random`` — run through both
packages and must reach equal canonical states (``digest._canon``, which
flattens dataclasses by type and field name) and equal ``opaque_hash``.
Within the port every δ-mutator obeys the decomposition law
``m(X) == X ⊔ mᵟ(X)`` and every join is idempotent, commutative and
associative. Everything is exact.

The adapter table below is the port's own: for each type, the mutators
as ``(name, draw)`` where ``draw(rng, rid, X)`` gives the arguments and
``name`` selects ``<name>_delta`` / ``<name>_full``."""

import random

import pytest

from repro.core import crdts as rcrdts
from repro.core.digest import _canon as rcanon
from repro.core.digest import opaque_hash as rhash
from repro_torch import core as tcore
from repro_torch.core import crdts as tcrdts
from repro_torch.core.digest import _canon as tcanon
from repro_torch.core.digest import opaque_hash as thash

RIDS = ("a", "b", "c")
SEEDS = [0, 1, 2]


def _elem(rng, rid, X):
    return (rid, rng.randrange(6))


def _elem_seen(rng, rid, X):
    """An element the replica holds (removes of unseen ones are no-ops),
    else a fresh draw."""
    held = sorted(X.elements(), key=repr)
    if held and rng.random() < 0.7:
        return (rid, held[rng.randrange(len(held))])
    return (rid, rng.randrange(6))


def _stamped(rng, rid, X):
    # stamps drawn wide: an LWW register's join is commutative only
    # while no two writes share a (timestamp, replica) stamp
    return (rid, rng.randrange(1, 10 ** 9), rng.randrange(6))


# an ORMap key holds one embedded type (its dot-store shape is fixed):
# key -> (type, its δ-mutators with their argument draws)
EMBEDDED = {
    "k0": ("AWORSet", (("add_delta", 1), ("rmv_delta", 1))),
    "k1": ("MVRegister", (("write_delta", 1),)),
    "k2": ("EWFlag", (("enable_delta", 0), ("disable_delta", 0))),
    "k3": ("DWFlag", (("disable_delta", 0), ("enable_delta", 0))),
}


def _embedded(C, rng, rid, X):
    """An ORMap op: a δ-mutator of the causal type embedded at a key."""
    key = f"k{rng.randrange(len(EMBEDDED))}"
    typ, ops = EMBEDDED[key]
    op, n_args = ops[rng.randrange(len(ops))]
    args = tuple(rng.randrange(5) for _ in range(n_args))
    return (rid, key, getattr(C, typ), op, *args)


# type -> [(mutator, draw(rng, rid, X) -> args)]; the arguments of ORMap's
# ``apply`` name a class of the package the state lives in
ADAPTERS = {
    "GCounter": [("inc", lambda rng, rid, X: (rid, rng.randrange(1, 4)))],
    "PNCounter": [("inc", lambda rng, rid, X: (rid, rng.randrange(1, 4))),
                  ("dec", lambda rng, rid, X: (rid, rng.randrange(1, 4)))],
    "GSet": [("add", lambda rng, rid, X: (rng.randrange(8),))],
    "TwoPSet": [("add", lambda rng, rid, X: (rng.randrange(8),)),
                ("rmv", lambda rng, rid, X: (
                    sorted(X.added)[rng.randrange(len(X.added))]
                    if X.added else rng.randrange(8),))],
    "AWORSetTombstone": [("add", _elem), ("rmv", _elem_seen)],
    "AWORSet": [("add", _elem), ("rmv", _elem_seen)],
    "RWORSet": [("add", _elem), ("rmv", _elem_seen)],
    "MVRegister": [("write", _elem)],
    "LWWRegister": [("write", _stamped)],
    "LWWSet": [("add", _stamped), ("rmv", _stamped)],
    "EWFlag": [("enable", lambda rng, rid, X: (rid,)),
               ("disable", lambda rng, rid, X: (rid,))],
    "DWFlag": [("enable", lambda rng, rid, X: (rid,)),
               ("disable", lambda rng, rid, X: (rid,))],
    "ORMap": [("apply", None),
              ("rmv", lambda rng, rid, X: (
                  rid, f"k{rng.randrange(4)}"))],
}
TYPES = [t.__name__ for t in tcrdts.ALL_CRDT_TYPES]


def _mutate(C, X, rid, rng, full=False):
    """One random δ-mutation of ``X`` at replica ``rid``; returns
    ``(delta, full_state)`` — the full mutator's result when ``full``."""
    name, draw = ADAPTERS[type(X).__name__][
        rng.randrange(len(ADAPTERS[type(X).__name__]))]
    args = (_embedded(C, rng, rid, X) if draw is None
            else draw(rng, rid, X))
    delta = getattr(X, f"{name}_delta")(*args)
    if not full:
        return delta, None
    if name == "apply":       # apply_full takes the delta mutator's name
        return delta, X.apply_full(*args)
    return delta, getattr(X, f"{name}_full")(*args)


def _execution(C, typ, seed, steps=40):
    """Three replicas of ``typ``: each step one replica δ-mutates and
    joins its delta, or joins another replica's state."""
    rng = random.Random(seed)
    reps = [getattr(C, typ).bottom() for _ in RIDS]
    for _ in range(steps):
        i = rng.randrange(len(reps))
        if rng.random() < 0.25:
            reps[i] = reps[i].join(reps[rng.randrange(len(reps))])
        else:
            delta, _ = _mutate(C, reps[i], RIDS[i], rng)
            reps[i] = reps[i].join(delta)
    return reps


def test_catalogue_and_exports_match_reference():
    assert TYPES == [t.__name__ for t in rcrdts.ALL_CRDT_TYPES]
    assert [t.__name__ for t in tcrdts.CAUSAL_WIRE_TYPES] == [
        t.__name__ for t in rcrdts.CAUSAL_WIRE_TYPES]
    import repro.core as rcore
    for name in ("CausalContext", "Dot", "DotFun", "DotMap", "DotSet",
                 "causal_join", "DeltaCRDT", *TYPES, "ALL_CRDT_TYPES"):
        assert name in rcore.__all__ and name in tcore.__all__
        assert getattr(tcore, name) is not None


@pytest.mark.parametrize("typ", TYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_execution_matches_reference(typ, seed):
    t = _execution(tcrdts, typ, seed)
    r = _execution(rcrdts, typ, seed)
    for tx, rx in zip(t, r):
        assert tcanon(tx) == rcanon(rx)
        assert thash(tx) == rhash(rx)
    # converge every replica and compare again
    tj = t[0].join(t[1]).join(t[2])
    rj = r[0].join(r[1]).join(r[2])
    assert tcanon(tj) == rcanon(rj) and thash(tj) == rhash(rj)
    assert all(x.leq(tj) for x in t)


@pytest.mark.parametrize("typ", TYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_decomposition_law(typ, seed):
    """m(X) == X ⊔ mᵟ(X) for every δ-mutator, from reachable states."""
    rng = random.Random(1000 + seed)
    for X in _execution(tcrdts, typ, seed, steps=25):
        for _ in range(6):
            rid = RIDS[rng.randrange(len(RIDS))]
            delta, full = _mutate(tcrdts, X, rid, rng, full=True)
            assert full == X.join(delta)
            X = full


@pytest.mark.parametrize("typ", TYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_join_laws(typ, seed):
    a, b, c = _execution(tcrdts, typ, seed + 77)
    assert a.join(a) == a
    assert a.join(b) == b.join(a)
    assert a.join(b).join(c) == a.join(b.join(c))
    assert a.leq(a.join(b)) and b.leq(a.join(b))
    bottom = type(a).bottom()
    assert bottom.join(a) == a and bottom.leq(a)
