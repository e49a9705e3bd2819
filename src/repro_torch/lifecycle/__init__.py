"""Key lifecycle: the per-key ``(epoch, expiry)`` lattice that
:class:`~repro_torch.core.store.LatticeStore` carries beside each value.
The reaper protocol arrives with a later slice."""

from .lattice import (LIFE_BOTTOM, Life, NO_EXPIRY, expired, is_live,
                      life_join, tombstone, touch)

__all__ = ["LIFE_BOTTOM", "Life", "NO_EXPIRY", "expired", "is_live",
           "life_join", "tombstone", "touch"]
