"""Key lifecycle:

* ``lattice`` — the per-key ``(epoch, expiry)`` lattice that
  :class:`~repro_torch.core.store.LatticeStore` carries beside each value;
  a tombstone is a bumped epoch with no value.
* ``reaper`` — the owner-driven reap protocol: the key's rendezvous owner
  proposes a reap once the expiry passes, collects ``reap-ack`` frames
  from the key's whole write replica set, and only then commits the
  tombstone as an ordinary δ-mutation.
"""

from .lattice import (LIFE_BOTTOM, Life, NO_EXPIRY, expired, is_live,
                      life_join, tombstone, touch)
from .reaper import ReaperProtocol

__all__ = ["LIFE_BOTTOM", "Life", "NO_EXPIRY", "expired", "is_live",
           "life_join", "tombstone", "touch", "ReaperProtocol"]
