"""The dim-3 rebuild kernel's truncated walk, on the CPU.

The rebuild kernel (`cuda_quadrature3.masked_contract3_rebuild`, csrc
`contract3_rebuild_kernel`) forms, per (day, i0, i1) row, only the cells
[0, max_l hi) its lookups read, takes each row's flag from the flag table
(`contract3_row_flags`, a byte per row: a cell of the WHOLE row outside
[-1, 1] or NaN) and sums each 64-row tile in the kernels' lane order.
`walk_model` is that walk in PyTorch (cells past the walk are NaN, so a
read past it would show); it is held bit-equal to the full-row model of
the kernel (`test_torch_wide_grid.rebuild_model`) on stage bounds,
bisection bands with lo > 0, rows with NaN columns and huge cells past
hi, and all-empty tiles, and to the JAX transform-cached sweeps at the
parity bar. Also here: the flag twin against U, the three routes at
their byte limits, and `chip_smoke.walk_cells` (the needed-cell count of
the rebuild's bound) against a brute-force count. Small sizes: n = 24
and 40 (one tile, lanes r and r + 32), T = 4."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.ops.grids import garch_grid, msm_grid
from tests.test_torch_wide_grid import in_order, rebuild_model, tile_sums

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12  # the port's parity bar (tests/test_torch_dim3.py)
T, Q = 4, 3
CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35],
                  [0.25, 0.35, 1.0]])
W = np.array([[0.5, 0.3, 0.2], [0.2, 0.5, 0.3], [0.4, 0.4, 0.2],
              [0.6, 0.15, 0.25]])


def _smoke():
    """chip_smoke.py as a module (it imports nothing heavy at load)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _case(family, n=40, seed=3, edit=None):
    """(port operands, JAX sweep of one row (bounds (T, 2), weights
    (3,))) for the MSM (q = 3) or GARCH family, Student-t, on the port's
    own grid; `edit(cols, p)` pokes the columns first."""
    rng = np.random.default_rng(seed)
    spec = tq.CopulaSpec("student", (6.5, _t(CORR3)))
    jspec = jq.CopulaSpec("student", (6.5, jnp.asarray(CORR3)))
    if family == "msm":
        x, dx = msm_grid(n)
        vols = np.sort(rng.uniform(0.5, 2.0, (3, Q)), axis=1)
        dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
            np.sqrt(2 * np.pi) * vols[:, :, None])
        fbs = rng.dirichlet(np.ones(Q), size=(T, 3))
        fc = rng.dirichlet(np.ones(Q ** 3), size=T)
        cols = list(tq.msm_day_columns(_t(fbs), _t(x), _t(vols), spec))
        p = None
    else:
        x, dx = garch_grid(n)
        fv = rng.uniform(0.6, 1.8, (T, 3))
        tcols, p = tq.garch_day_columns(_t(fv), _t(x), spec)
        cols = list(tcols)
    if edit is not None:
        edit(cols, p)
    jcols = tuple(jnp.asarray(c.numpy()) for c in cols)
    if family == "msm":
        ops = cq3.contract3_operands(tuple(cols), _t(x), _t(dx), spec,
                                     densities=_t(dens),
                                     forecast_combos=_t(fc))

        def jax_sweep(b, w):
            return np.asarray(jq.msm_integrals_tcached(
                b, jcols, fc, x, dx, dens, w, jspec))
    else:
        ops = cq3.contract3_operands(tuple(cols), _t(x), _t(dx), spec,
                                     p_cols=p)
        jp = jnp.asarray(p.numpy())

        def jax_sweep(b, w):
            return np.asarray(jq.garch_integrals_tcached(
                b, jcols, jp, x, dx, w, jspec))
    return ops, jax_sweep


def _intervals(ops, bounds, weights, box_min=-5.0):
    """Per bound row l: (lo, hi, used) (T, r, n) of each row's interval,
    the kernel's arithmetic; used: hi > lo and no NaN bound."""
    x = ops.x
    x0 = x if ops.rows is None else x[ops.rows[0]:ops.rows[1]]
    out = []
    for b, w in zip(bounds, weights):
        prev = x0[:, None] * w[1] + x[None, :] * w[2]
        dup = (b[:, 1, None, None] - prev) / w[0]
        dlo = torch.maximum((b[:, 0, None, None] - prev) / w[0],
                            torch.tensor(box_min, dtype=torch.float64))
        hi = torch.searchsorted(x, dup.contiguous(), right=True)
        lo = torch.searchsorted(x, dlo.contiguous(), right=True)
        used = (hi > lo) & ~torch.isnan(dup) & ~torch.isnan(dlo)
        out.append((lo, hi, used))
    return out


def walk_model(ops, bounds, weights, flags=None, box_min=-5.0):
    """(L, T) as the truncated rebuild sums: each row walked over [0,
    max_l hi) of its non-empty intervals (cells past the walk NaN), its
    running prefix read at lo - 1 and hi - 1, or, flagged in `flags`
    (default: the flag twin), its cells summed over [lo, hi) in index
    order; each 64-row tile one partial in the kernel's lane order, the
    partials added in (i0, tile) order."""
    U = cq3.contract3_weights_reference(ops)  # (T, r, n, n)
    if flags is None:
        flags = cq3.contract3_row_flags_reference(ops)
    n = ops.x.shape[0]
    j = torch.arange(n)
    spans = _intervals(ops, bounds, weights, box_min)
    reach = torch.stack([torch.where(u, hi, torch.zeros_like(hi))
                         for _, hi, u in spans]).amax(dim=0)
    walked = torch.where(j < reach[..., None], U,
                         torch.full((), float("nan"), dtype=torch.float64))
    S = torch.cumsum(walked, dim=-1)
    out = []
    for lo, hi, used in spans:
        last = (hi - 1).clamp(min=0)[..., None]
        s_hi = torch.gather(S, -1, last)[..., 0]
        s_lo = torch.gather(S, -1, (lo - 1).clamp(min=0)[..., None])[..., 0]
        prefix = torch.where(lo > 0, s_hi - s_lo, s_hi)
        inside = (j >= lo[..., None]) & (j < hi[..., None])
        cells = torch.gather(torch.cumsum(
            torch.where(inside, walked, torch.zeros(())), dim=-1), -1,
            last)[..., 0]
        rs = torch.where(flags, cells, prefix)
        rs = torch.where(used, rs, torch.zeros_like(rs))
        out.append(in_order(tile_sums(rs, 64).reshape(rs.shape[0], -1)))
    return torch.stack(out)


def _same_bits(a, b):
    """Equal bits, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _bounds(kind, L, seed=7):
    """(L, T, 2) bounds of one kind: the solve's stage sweeps, bisection
    bands near the records' VaR (lo > 0 on every row), or bands below
    the grid (every interval empty, or empty on two of the days)."""
    rng = np.random.default_rng(seed)
    if kind == "stage":
        up = np.array([-3.0, -3.5, -2.0, -3.0])[:L, None].repeat(T, 1)
        lo = np.full((L, T), -100.0)
    elif kind == "band":
        lo = rng.uniform(-1.9, -1.1, (L, T))
        up = lo + rng.uniform(0.01, 0.3, (L, T))
    else:
        lo = np.full((L, T), -100.0)
        up = np.full((L, T), -60.0)
        up[:, :2] = rng.uniform(-2.5, -1.2, (L, 2))
    return _t(np.stack([lo, up], -1))


def _poke(cols, p):
    """Past hi: a non-finite column of asset 2 (Student fin = 0, NaN
    cells) on day 0 and an overflowing one (lu = -1000, inf cells; GARCH:
    nan_to_num's DBL_MAX) on day 1, both near the top of the grid; and a
    non-finite asset-1 point on day 2, a whole flagged row."""
    cols[1][0, 2, -2] = False
    cols[2][1, 2, -3] = -1000.0
    cols[1][2, 1, 5] = False


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("kind", ["stage", "band", "poked", "empty"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_walk_equals_the_full_row_model(family, kind, L):
    """The truncated walk with the flag table gives the full-row model's
    bits: every row takes the branch its whole-row flag gives it."""
    ops, _ = _case(family, edit=_poke if kind == "poked" else None)
    bounds = _bounds("stage" if kind == "poked" else kind, L)
    w = _t(W[:L])
    got = walk_model(ops, bounds, w)
    for l in range(L):
        want = rebuild_model(ops, bounds[l], w[l], 64)
        assert _same_bits(got[l], want), (l, got[l] - want)
    if kind == "empty":
        assert bool((got[:, 2:] == 0.0).all())
        assert bool((got[:, :2] != 0.0).all())


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_flag_table_is_what_keeps_the_bits(family):
    """With flags read off the walked cells only, a NaN or huge cell past
    hi goes unseen and its rows are read as prefix differences: other
    bits than the full-row model's. The flag table reads whole rows."""
    ops, _ = _case(family, edit=_poke)
    bounds, w = _bounds("stage", 4), _t(W)
    U = cq3.contract3_weights_reference(ops)
    spans = _intervals(ops, bounds, w)
    reach = torch.stack([torch.where(u, hi, torch.zeros_like(hi))
                         for _, hi, u in spans]).amax(dim=0)
    seen = torch.arange(U.shape[-1]) < reach[..., None]
    walked_flags = (seen & ~(U.abs() <= cq.MAX_CELL)).any(dim=-1)
    whole = cq3.contract3_row_flags_reference(ops)
    assert bool((whole & ~walked_flags).any())
    naive = walk_model(ops, bounds, w, flags=walked_flags)
    want = torch.stack([rebuild_model(ops, bounds[l], w[l], 64)
                        for l in range(4)])
    assert not _same_bits(naive, want)
    assert _same_bits(walk_model(ops, bounds, w), want)


@pytest.mark.parametrize("kind", ["stage", "band", "poked"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_walk_matches_jax(family, kind):
    """The walk model against JAX's transform-cached sweeps, row by row
    (four bound rows, unequal weights), at the parity bar."""
    ops, jax_sweep = _case(family, edit=_poke if kind == "poked" else None)
    bounds = _bounds("stage" if kind == "poked" else kind, 4)
    got = walk_model(ops, bounds, _t(W))
    for l in range(4):
        want = jax_sweep(bounds[l].numpy(), W[l])
        np.testing.assert_allclose(got[l].numpy(), want, rtol=RTOL,
                                   atol=1e-300)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("days, rows", [(slice(None), None),
                                        (slice(1, 3), None),
                                        (slice(None), (3, 11))])
def test_row_flags_twin(family, days, rows):
    """The flag twin is the test of interval.cuh on every row of U (the
    table twin, held to JAX elsewhere): on all days, a day subset and a
    range of outer rows."""
    ops, _ = _case(family, n=24, edit=_poke)
    if rows is not None:
        ops = ops._replace(rows=rows)
    U = cq3.contract3_weights_reference(ops, days)
    want = ((U.abs() > 1.0) | torch.isnan(U)).any(dim=-1)
    got = cq3.contract3_row_flags_reference(ops, days)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert bool(got.any()) and not bool(got.all())


def test_row_flags_on_the_cpu_are_the_twin():
    """A CPU tensor takes the plain twin and launches nothing; the CPU
    operands carry no flags (the CPU sweep is the plain twin)."""
    ops, _ = _case("msm", n=24, edit=_poke)
    assert ops.flags is None and ops.U is None
    before = cq.launch_count(cq3.contract3_row_flags)
    assert torch.equal(cq3.contract3_row_flags(ops),
                       cq3.contract3_row_flags_reference(ops))
    assert cq.launch_count(cq3.contract3_row_flags) == before


@pytest.mark.parametrize("T_, n, rows, free, route", [
    (500, 100, None, 4_040_000_000, "table"),  # U exactly fits
    (500, 100, None, 4_039_999_999, "rebuild"),  # U one byte short
    (500, 100, None, 5_000_000, "rebuild"),  # the flags exactly fit
    (500, 100, None, 4_999_999, "rebuild_full"),  # one byte short
    (500, 300, None, 45_000_000, "rebuild"),  # flags 45 MB
    (500, 300, None, 44_999_999, "rebuild_full"),
    (500, 300, 75, 11_250_000, "rebuild"),  # a grid rank's 75 slabs
    (500, 300, 75, 11_249_999, "rebuild_full"),
    (500, 1024, None, 524_288_000, "rebuild"),  # flags 0.5 GB
    (500, 1024, None, 524_287_999, "rebuild_full"),
])
def test_three_routes(T_, n, rows, free, route):
    """The table when its sweep takes n and U fits; the rebuild with its
    flag table (T rows n bytes) when that fits; else the rebuild walking
    full rows."""
    assert cq3.contract3_route(T_, n, 5, rows, free) == route
    assert cq3.flag_table_bytes(T_, n, rows) == T_ * (rows or n) * n


def _brute_cells(x, bounds, weights, box_min=-5.0, rows=None):
    """Every (t, i0, i1, j) cell tested on its own: j < hi of some bound
    row whose interval holds a grid point; with each slab's longest row,
    the rows and slabs that hold one."""
    n = len(x)
    i0s = range(n) if rows is None else range(*rows)
    cells = cols = used_rows = used_slabs = 0
    for t in range(bounds.shape[1]):
        for i0 in i0s:
            slab = 0
            for i1 in range(n):
                reach = 0
                for (b_lo, b_up), w in zip(bounds[:, t], weights):
                    prev = x[i0] * w[1] + x[i1] * w[2]
                    dup = (b_up - prev) / w[0]
                    dlo = max((b_lo - prev) / w[0], box_min)
                    inside = [dlo < xj <= dup for xj in x]
                    if any(inside):
                        reach = max(reach, sum(xj <= dup for xj in x))
                cells += reach
                used_rows += reach > 0
                slab = max(slab, reach)
            cols += slab
            used_slabs += slab > 0
    return cells, cols, used_rows, used_slabs


@pytest.mark.parametrize("kind, L, rows", [("stage", 1, None),
                                           ("band", 4, None),
                                           ("empty", 2, None),
                                           ("band", 3, (4, 13))])
def test_walk_cells_count(kind, L, rows):
    """The rebuild bound's needed-cell count against a brute-force count
    of the cells each row's intervals read (n = 16, T = 4)."""
    x, _ = msm_grid(16)
    bounds, w = _bounds(kind, L), _t(W[:L])
    got = _smoke().walk_cells(_t(x), bounds, w, rows=rows, day_chunk=3)
    want = _brute_cells(list(x), bounds.numpy(), W[:L], rows=rows)
    assert got == want
    assert 0 <= got[0] <= T * (rows[1] - rows[0] if rows else 16) * 16 ** 2


def test_rebuild_bound_counts_less_than_the_cube():
    """With the walk's count the bound is the cube's or less, and the
    flag pass's bound is the whole cube once."""
    smoke = _smoke()
    full = smoke.rebuild_bound(500, 300, 5, 1, True, False)
    part = smoke.rebuild_bound(500, 300, 5, 1, True, False,
                               walk=(500 * 300 * 300 * 15, 500 * 300 * 60))
    assert part[0] < full[0] and full[1] == "operations"
    flags = smoke.flags_bound(500, 300, 5, True, False)
    assert 0.9 * full[0] < flags[0] < full[0]
