"""The solve's work count (varbench/work/solve.py)."""

import math

import pytest
import torch

from varbench.work import peaks
from varbench.work import solve as work


def test_lookups_hand_worked():
    # 7 + 2 ceil(log2(n + 1))
    assert work.lookups(3) == 7 + 2 * 2
    assert work.lookups(100) == 7 + 2 * 7
    assert work.lookups(1) == 7 + 2 * 1


def test_lookup_branch_hand_worked():
    # T = 2, n = 3, d = 2, L = 1: table 18 cells; 4 non-empty lookups read
    # 8 cells; x 3, weights 2, level 1, bounds 4, result 2
    w = work.solve_work(T=2, n=3, d=2, L=1, lookups_done=4)
    assert w["table_cells"] == 18
    assert w["cells_read"] == 8
    assert w["bytes"] == 8 * (8 + 3 + 2 + 1 + 4 + 2)
    assert w["operations"] == 4 * work.lookups(3)


def test_whole_table_branch_hand_worked():
    # the same request after S = 3 sweeps of every row: 3 * 1 * 2 * 3 = 18
    # lookups would read 36 cells, more than the 18 of the table
    w = work.solve_work(T=2, n=3, d=2, L=1, lookups_done=18)
    assert w["cells_read"] == 18
    assert w["bytes"] == 8 * (18 + 3 + 2 + 1 + 4 + 2)
    assert w["operations"] == 18 * work.lookups(3)


def test_dim3_lookup_branch():
    # at dim 3 a row lookup reads 2 of the n^3 cells of its day
    T, n, L, S = 4, 5, 2, 3
    lookups = S * L * T * n * n
    w = work.solve_work(T=T, n=n, d=3, L=L, lookups_done=lookups)
    assert w["table_cells"] == T * n ** 3
    assert w["cells_read"] == min(T * n ** 3, 2 * lookups)


def test_bound_is_the_larger_rate():
    w = {"bytes": 3.35e12, "operations": 0}
    assert work.bound_seconds(w) == pytest.approx(1.0)
    w = {"bytes": 0, "operations": 2 * peaks.F64_FLOP_PER_S}
    assert work.bound_seconds(w) == pytest.approx(2.0)
    assert work.bound_seconds(w, itemsize=4) == pytest.approx(
        2 * peaks.F64_FLOP_PER_S / peaks.F32_FLOP_PER_S)


def _brute(x, bounds, weights, box_min):
    """Row lookups with a non-empty interval, one by one."""
    L, T, _ = bounds.shape
    d = weights.shape[1]
    n = len(x)
    count = 0
    for l in range(L):
        for t in range(T):
            lo_b, up_b = float(bounds[l, t, 0]), float(bounds[l, t, 1])
            for idx in range(n ** (d - 1)):
                outer = [(idx // n ** (d - 2 - a)) % n for a in range(d - 1)]
                prev = 0.0
                for a, i in enumerate(outer):
                    prev = prev + float(x[i]) * float(weights[l, 1 + a])
                up = (up_b - prev) / float(weights[l, 0])
                lo = max((lo_b - prev) / float(weights[l, 0]), box_min)
                if math.isnan(up) or math.isnan(lo):
                    continue
                count += any(lo < float(v) <= up for v in x)
    return count


@pytest.mark.parametrize("d", [2, 3])
def test_row_lookups_match_one_by_one(d):
    g = torch.Generator().manual_seed(d)
    x = torch.linspace(-5.0, 5.0, 7, dtype=torch.float64)
    L, T = 3, 4
    lo = -6.0 * torch.rand((L, T), generator=g, dtype=torch.float64)
    up = lo + 3.0 * torch.rand((L, T), generator=g, dtype=torch.float64)
    bounds = torch.stack([lo, up], dim=-1)
    weights = torch.rand((L, d), generator=g, dtype=torch.float64) + 0.1
    got = work.row_lookups(x, bounds, weights, -5.0)
    assert got == _brute(x, bounds, weights, -5.0)
    assert 0 < got < L * T * 7 ** (d - 1)


def test_empty_intervals_count_zero():
    x = torch.linspace(-5.0, 5.0, 11, dtype=torch.float64)
    w = torch.tensor([[0.5, 0.5]], dtype=torch.float64)
    # (lower, upper] between two grid points for every outer point: each
    # inner interval has width 0.2 / 0.5 = 0.4 < the step 1, placed
    # between points
    prev = 0.5 * x
    empty = 0
    for p in prev:
        lo, up = float(p) + 0.5 * 0.1, float(p) + 0.5 * 0.5
        empty += work.row_lookups(
            x, torch.tensor([[[lo, up]]], dtype=torch.float64), w, -5.0)
    assert empty == 0
    # a slab with a NaN bound holds nothing
    nan = torch.tensor([[[math.nan, 0.0]]], dtype=torch.float64)
    assert work.row_lookups(x, nan, w, -5.0) == 0
    # and an upper bound under the box holds nothing either
    low = torch.tensor([[[-100.0, -9.0]]], dtype=torch.float64)
    assert work.row_lookups(x, low, w, -5.0) == 0
