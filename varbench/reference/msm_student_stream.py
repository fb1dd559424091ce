"""Plain reference of an MSM book under a Student-t copula whose density
does not fit in memory: `msm_student`'s semantics and interface (`Book`
with `x`, `box_min`, `T`, `n`, `dim`, and `solve`), with the density
never held whole.

`msm_student.Book` builds the copula density of every day once, T n^dim
float64 cells; at T = 500 and 300 points on three axes that is 108 GB.
Here each sweep forms it anew, one block of days at a time, under the
same `CHUNK_CELLS`, by `msm_student`'s own density function applied to
that block's forecasts; the masks, the contraction and the solve are
`msm_student`'s, unchanged. So every answer equals `msm_student`'s to
the bit where both fit, at the cost of one density formation per day
block per sweep.

It imports nothing of the program under test: plain float64 PyTorch on
the device it is given, with scipy's Student-t quantile.
"""

from __future__ import annotations

import copy

from varbench.reference import msm_student
from varbench.reference.msm_student import CHUNK_CELLS, solve  # noqa: F401


class Book(msm_student.Book):
    """`msm_student.Book` with `C` a view that forms the density of the
    days it is indexed with, when it is indexed."""

    def _density(self, fbs, vols, nu, corr):
        return _DayBlocks(self, fbs, vols, nu, corr)


class _DayBlocks:
    """The copula density of a book's days, formed per slice of days by
    `msm_student.Book._density` on that slice's forecasts."""

    def __init__(self, book, fbs, vols, nu, corr):
        self.book = book
        self.args = (fbs, vols, nu, corr)

    def __getitem__(self, days):
        if not isinstance(days, slice):
            raise TypeError("the density is indexed by a slice of days")
        fbs, vols, nu, corr = self.args
        block = copy.copy(self.book)
        block.T = len(range(*days.indices(self.book.T)))
        return msm_student.Book._density(block, fbs[days], vols, nu, corr)
