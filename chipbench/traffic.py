"""The traffic generator: what a mix file's parameters turn into.

A mix is ``"loop": "closed"`` (``clients`` callers, each with one request
in flight, sending the next when its reply is ready) or ``"loop":
"open"`` (arrivals on a schedule, whatever the system does).  The seed
orders the work and never sizes it: an open mix's gaps are the same
quantiles of the arrival law for every seed, shuffled, so every seed
offers the same number of requests over the same span."""
from __future__ import annotations

import numpy as np


def due_times(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Seconds after the window opens at which each request is due."""
    if mix["arrivals"] != "poisson":
        raise ValueError(f"no arrival law {mix['arrivals']!r}")
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng([int(seed), 0]).shuffle(gaps)
    due = np.cumsum(gaps)
    return due[due < seconds]


class ImageOrder:
    """Pool indices for successive requests: a permutation of the pool
    drawn from the seed, walked round and round, so neighbours in a batch
    are distinct images."""

    def __init__(self, pool_size: int, seed: int):
        self._perm = np.random.default_rng([int(seed), 1]) \
            .permutation(pool_size)
        self._k = 0

    def next(self) -> int:
        i = int(self._perm[self._k % len(self._perm)])
        self._k += 1
        return i


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from
    the seed, whatever their number."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self._seen = 0
        self._rng = np.random.default_rng([int(seed), 2])

    def offer(self, make) -> None:
        """Offer one item, built by ``make()`` only if it is kept."""
        self._seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self._rng.integers(0, self._seen))
        if j < self.k:
            self.items[j] = make()
