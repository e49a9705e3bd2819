"""The per-key lifecycle lattice: (tombstone epoch, LWW expiry).

A production keyed store must let keys *leave* as well as join, but the
paper's join-semilattice states only grow — Almeida et al.'s journal
version names state growth/GC as the price of monotone joins. This module
is the smallest lattice that buys non-monotone *system* behaviour from
monotone *joins*: every key of a :class:`~repro_torch.core.store.LatticeStore`
carries a lifecycle value

    Life = (epoch: int, expiry: float)

ordered **lexicographically** — epochs are a total order, and within one
epoch the expiry is a monotone max (LWW extend-on-write). The per-key
store state is then the lexicographic product ``Life ×lex Value``:

* equal epochs   → expiries max-join and values join pointwise (normal
                   CRDT life; a ``touch`` extends the expiry, never
                   shrinks it);
* higher epoch   → wins wholesale: the winner's (expiry, value) replace
                   the loser's entirely. A *tombstone* is epoch ``e+1``
                   with a ⊥ value — one compact ``(key, epoch, expiry)``
                   triple that absorbs every straggler delta still at
                   epoch ``e`` (the ⊥-absorption the reaper relies on).

Lexicographic products of a chain with a lattice are lattices, so every
individual join is still a join: idempotent, commutative, associative,
safe under loss/duplication/reordering. What is *not* monotone is the
system-level resident size — joining a tombstone makes the store smaller.

Keys never touched by the lifecycle subsystem sit at ``LIFE_BOTTOM =
(0, -inf)`` (canonically absent), so stores that never expire anything
are byte- and semantics-identical to the pre-lifecycle format.

The reaper protocol that *produces* tombstones (owner proposal + replica
set ack quorum) arrives with a later slice of the port; this module is
deliberately dependency-free so :mod:`repro_torch.core.store` can import it.
"""

from __future__ import annotations

from typing import Tuple

# Life = (epoch, expiry). Plain tuples: Python tuple comparison IS the
# lexicographic order, so join = max() and leq = <= need no wrapper class.
Life = Tuple[int, float]

NO_EXPIRY = float("-inf")          # "no TTL set": the expiry bottom
LIFE_BOTTOM: Life = (0, NO_EXPIRY)  # epoch 0, no expiry — the default


def life_join(a: Life, b: Life) -> Life:
    """Lex max: higher epoch wins wholesale; equal epochs max expiries.
    (``max`` on tuples is exactly this; the store's life joins and the
    digest filters go through here so the order has one home.)"""
    return a if a >= b else b


def is_live(life: Life) -> bool:
    """A life value that has an expiry to enforce (reap-eligible once it
    passes). Epoch alone does not make a key mortal."""
    return life[1] != NO_EXPIRY


def expired(life: Life, now: float) -> bool:
    """True iff the key has a TTL and it has passed."""
    return is_live(life) and now >= life[1]


def touch(life: Life, now: float, ttl: float) -> Life:
    """Extend-on-write: the new expiry within the current epoch. Always
    ≥ the old life (monotone), so concurrent touches merge to the latest
    deadline."""
    return (life[0], max(life[1], now + ttl))


def tombstone(life: Life, reaped_at: float) -> Life:
    """The life value a commit writes: next epoch, stamped with the acked
    expiry (kept for observability; a revival's touch supersedes it)."""
    return (life[0] + 1, reaped_at)
