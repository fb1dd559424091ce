"""The one request generator: a mix's parameters and a seed in, the
same requests out for the same seed.

A request is `{"weights": (P, dim), "levels": (L,)}`: portfolios drawn
from Dirichlet(alpha, ..., alpha), and levels from the mix's ladder. With
`"level_draw": "cycle"` each portfolio row gets one level, taken in turn
from the ladder shuffled anew each time it is used up, so every seed
asks for each level equally often (L = P); with `"all"` every request
asks for the whole ladder (a P x L grid).
"""

from __future__ import annotations

import numpy as np

# independent streams of one seed
STREAMS = {"warmup": 1, "window": 2, "sample": 3}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), STREAMS[stream]])


class Traffic:
    """The requests of one stream of `seed` under `mix`, for a book of
    `dim` assets."""

    def __init__(self, mix: dict, dim: int, seed: int, stream: str):
        self.mix = mix
        self.dim = dim
        self.rng = rng(seed, stream)
        self.ladder = np.asarray(mix["levels"], dtype=np.float64)
        self._pending = []

    def _level(self) -> float:
        if not self._pending:
            self._pending = list(self.rng.permutation(self.ladder))
        return float(self._pending.pop())

    def next(self) -> dict:
        P = int(self.mix["portfolios"])
        alpha = float(self.mix["dirichlet"])
        weights = self.rng.dirichlet(np.full(self.dim, alpha), size=P)
        if self.mix["level_draw"] == "all":
            levels = self.ladder.copy()
        elif self.mix["level_draw"] == "cycle":
            levels = np.array([self._level() for _ in range(P)])
        else:
            raise ValueError(f"level_draw {self.mix['level_draw']!r}: "
                             "'cycle' or 'all'")
        return {"weights": weights, "levels": levels}
