"""The work a VaR request's solve needs, whatever implements it.

A request has L series (rows), T days, an n-point grid in dim d and S
sweeps: the two stage sweeps and the bisection's halvings. Every sweep
asks, for each row, day and point of the d - 1 outer grid axes, for the
masked sum of one grid row of the day: the cells of the inner axis that
lie in the row's interval. Its bounds-invariant table (the day's density
folded with the state weights, or any form of it) has T n^d entries.

The least that must be read is the smaller of two counts:

* the whole table once per request (as a kernel that holds a day and
  bisects it in place reads it);
* two cells per row lookup over all sweeps (the interval rule on row
  prefix sums reads the prefix at each end), where a row whose interval
  holds no grid point needs none.

Every other input and output counts once: the bounds, the weights, the
levels, x and the (L, T) result. The operations are the row lookups, at
`lookups(n)` each. No kernel name, launch layout or table layout enters
the count, so a design that reads its table cannot need less.
"""

from __future__ import annotations

import math

import torch

from varbench.work import peaks


def lookups(n: int) -> int:
    """Operations of one row lookup: the row's offset, the two dynamic
    bounds (a subtraction and a division each), the clamp to the box, two
    binary searches of ceil(log2(n + 1)) compares and the difference of
    the two prefixes."""
    return 7 + 2 * math.ceil(math.log2(n + 1))


def row_lookups(x, bounds, weights, box_min: float) -> int:
    """Row lookups of one sweep whose interval holds a grid point: over
    the rows of bounds (L, T, 2) under weights (L, d), the days and the
    outer grid points, those whose inner cut (max((lower - prev) / w0,
    box_min), (upper - prev) / w0] holds some point of x (ascending),
    with prev = sum_a x_a w[1 + a] over the outer axes. A NaN bound
    holds none."""
    L, d = weights.shape
    x = x.to(torch.float64)
    prev = torch.zeros((L,) + (1,) * (d - 1), dtype=torch.float64,
                       device=x.device)
    for a in range(d - 1):
        shape = (1,) * a + (x.shape[0],) + (1,) * (d - 2 - a)
        prev = prev + x.reshape(shape) * weights[:, 1 + a].reshape(
            (L,) + (1,) * (d - 1))
    lead = (slice(None), slice(None)) + (None,) * (d - 1)
    w0 = weights[:, 0].reshape((L, 1) + (1,) * (d - 1))
    up = (bounds[..., 1][lead] - prev[:, None]) / w0
    lo = torch.clamp_min((bounds[..., 0][lead] - prev[:, None]) / w0,
                         box_min)
    # points of x in (lo, up]: those <= up less those <= lo
    hi_k = torch.searchsorted(x, up.contiguous(), right=True)
    lo_k = torch.searchsorted(x, lo.contiguous(), right=True)
    full = (hi_k > lo_k) & torch.isfinite(up) & torch.isfinite(lo)
    return int(full.sum())


def solve_work(T: int, n: int, d: int, L: int, lookups_done: int,
               itemsize: int = 8) -> dict:
    """Bytes and operations of one request of L rows over T days on an
    n^d grid, whose sweeps made `lookups_done` row lookups with a
    non-empty interval (summed over the S sweeps; at most S L T
    n^(d - 1))."""
    table = T * n ** d
    cells = min(table, 2 * lookups_done)
    other = n + L * d + L + 2 * L * T + L * T
    return {"bytes": itemsize * (cells + other),
            "operations": lookups_done * lookups(n),
            "table_cells": table, "cells_read": cells}


def bound_seconds(work: dict, itemsize: int = 8) -> float:
    """The least time of the work on the card: the larger of its bytes at
    the memory's rate and its operations at the float64 (itemsize 8) or
    float32 (itemsize 4) rate."""
    rate = peaks.F64_FLOP_PER_S if itemsize == 8 else peaks.F32_FLOP_PER_S
    return max(work["bytes"] / peaks.HBM_BYTES_PER_S,
               work["operations"] / rate)
