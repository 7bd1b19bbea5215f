"""Bounded FIFO cache for reuse across CLI invocations (a copy of
`if_defense_tpu/utils/cache.py`).

The inference CLI caches its loaded victim across ``main()`` calls in one
process, so scoring many npz files against one victim loads the checkpoint
once. The bound matters: the cached values hold device-resident weights,
so a long sweep over many victims must evict rather than pin them all
(FIFO is enough: sweeps revisit one configuration many times in a row, not
round-robin).
"""

from __future__ import annotations

from typing import Callable, Hashable


class BoundedCache:
    """FIFO-evicting dict: at most ``maxsize`` entries, oldest out."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._d: dict = {}

    def get_or_build(self, key: Hashable, build: Callable):
        """Return the cached value for ``key``, building (and inserting,
        evicting the oldest entry if full) on a miss."""
        if key not in self._d:
            if len(self._d) >= self.maxsize:
                self._d.pop(next(iter(self._d)))
            self._d[key] = build()
        return self._d[key]

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d
