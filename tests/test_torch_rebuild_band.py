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
parity bar. The kernel's walk schedule (`rank_walks`: rows alone below
the 48th longest length, the rest of a tile's cells formed by the whole
block, 64 a step) is modelled step by step (`walk_schedule`,
`walk_tile`): on tiles built to stress it, every cell formed once and
each row's cells added in index order, at interval::row_sum's bits, and
on operands bit-equal to both models. Also here: the flag twin against
U, the three routes at their byte limits, and `chip_smoke.walk_cells`
(the needed-cell count of the rebuild's bound) and `warp_walk_cells`
(the cells a walk of one thread per row spends) against brute-force
counts. Small sizes: n = 24 and 40 (one tile, lanes r and r + 32), T =
4."""

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


def _brute_reaches(x, bounds, weights, box_min=-5.0, rows=None):
    """{(t, i0): [reach of each i1 row]}, every (t, i0, i1, j) cell tested
    on its own: the longest hi of the bound rows whose interval holds a
    grid point."""
    n = len(x)
    i0s = range(n) if rows is None else range(*rows)
    out = {}
    for t in range(bounds.shape[1]):
        for i0 in i0s:
            reaches = []
            for i1 in range(n):
                reach = 0
                for (b_lo, b_up), w in zip(bounds[:, t], weights):
                    prev = x[i0] * w[1] + x[i1] * w[2]
                    dup = (b_up - prev) / w[0]
                    dlo = max((b_lo - prev) / w[0], box_min)
                    inside = [dlo < xj <= dup for xj in x]
                    if any(inside):
                        reach = max(reach, sum(xj <= dup for xj in x))
                reaches.append(reach)
            out[t, i0] = reaches
    return out


def _brute_cells(x, bounds, weights, box_min=-5.0, rows=None):
    """The needed cells, with each slab's longest row, the rows and slabs
    that hold one (`_brute_reaches`)."""
    cells = cols = used_rows = used_slabs = 0
    for reaches in _brute_reaches(x, bounds, weights, box_min,
                                  rows).values():
        cells += sum(reaches)
        used_rows += sum(r > 0 for r in reaches)
        cols += max(reaches)
        used_slabs += max(reaches) > 0
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


@pytest.mark.parametrize("kind, L, rows", [("stage", 1, None),
                                           ("band", 4, None),
                                           ("empty", 2, None),
                                           ("band", 3, (4, 13))])
def test_warp_walk_cells_count(kind, L, rows):
    """The cells a walk of one thread per row spends, against a brute-force
    count: per warp of 32 consecutive i1 rows of a slab (n = 40: a full
    warp and one of 8 rows) its longest reach times 32; never fewer than
    the cells needed."""
    x, _ = msm_grid(40)
    bounds, w = _bounds(kind, L), _t(W[:L])
    smoke = _smoke()
    got = smoke.warp_walk_cells(_t(x), bounds, w, rows=rows, day_chunk=3)
    want = sum(32 * max(reaches[k:k + 32])
               for reaches in _brute_reaches(list(x), bounds.numpy(), W[:L],
                                             rows=rows).values()
               for k in range(0, 40, 32))
    assert got == want
    cells = smoke.walk_cells(_t(x), bounds, w, rows=rows, day_chunk=3)[0]
    assert cells <= got <= 32 * max(cells, 1)
    if kind != "empty":
        assert cells < got
    assert smoke.formation_share(cells, 2.0, 10 * cells, 5.0) == 0.25
    assert smoke.formation_share(cells, None, 1, 1.0) is None


# -- the rebuild's lane-balanced walk (csrc contract3.cu `rank_walks` and the
# walk of contract3_rebuild_kernel), modelled step by step ------------------

SPAN = 64  # rows of a tile, threads of a block: the pairs of a step
OWN_WALK = 48  # kOwnWalk: rows walk alone while this many of 64 walk


def walk_schedule(lens, own_walk=OWN_WALK):
    """The kernel's schedule of one tile whose row r walks [0, lens[r]):
    (own, form, reads). The rows ranked longest first (ties by row); own
    = the length of the `own_walk`-th longest, the columns each row forms
    itself; the pairs past it shared, column by column and rank by rank,
    the segment of k walking rows starting at first[k] = k ls[k] +
    sum(ls[k:]) over the lengths ls past own. form[step][lane]: the (row,
    column) thread `lane` forms at that step, None where it forms none;
    reads[r]: the (step, lane) of each staged cell thread r adds, in the
    order it adds them. Both sides step as the kernel's threads do (the
    formation's incremental columns and ranks, the owner's segment pair
    bases)."""
    rank = [sum(lens[m] > lens[r] or (lens[m] == lens[r] and m < r)
                for m in range(SPAN)) for r in range(SPAN)]
    ls, order = [0] * (SPAN + 1), [0] * SPAN
    for r in range(SPAN):
        ls[rank[r]], order[rank[r]] = lens[r], r
    own = ls[own_walk - 1]
    ls = [max(v - own, 0) for v in ls]
    first = [k * ls[k] + sum(ls[k:SPAN]) for k in range(SPAN)] + [0]
    total = first[0]
    steps = -(-total // SPAN)
    form = [[None] * SPAN for _ in range(steps)]
    for lane in range(SPAN):
        pf, fk, fend = lane, SPAN + 1, 0
        fcol = fm = fq = fr = 0
        for s in range(steps):
            if pf >= total:
                break
            if pf >= fend:
                while True:
                    fk -= 1
                    fend = first[fk - 1]
                    if pf < fend:
                        break
                off = pf - first[fk]
                fcol, fm = own + ls[fk] + off // fk, off % fk
                fq, fr = SPAN // fk, SPAN % fk
            form[s][lane] = (order[fm], fcol)
            pf += SPAN
            fcol += fq
            fm += fr
            if fm >= fk:
                fm -= fk
                fcol += 1
    reads = [[] for _ in range(SPAN)]
    for r in range(SPAN):
        n_r = max(lens[r] - own, 0)
        if n_r == 0:
            continue
        j, wk = 0, SPAN
        while ls[wk - 1] <= j:
            wk -= 1
        wend, wbase = ls[wk - 1], first[wk] - ls[wk] * wk + rank[r]
        pw = wbase
        for s in range(steps):
            while j < n_r and pw < (s + 1) * SPAN:
                reads[r].append((s, pw - s * SPAN))
                j += 1
                if j == wend and j < n_r:
                    while ls[wk - 1] <= j:
                        wk -= 1
                    wend = ls[wk - 1]
                    wbase = first[wk] - ls[wk] * wk + rank[r]
                pw = wbase + j * wk
    return own, form, reads


def _capture(sums, spans, r, j, run, n_r):
    """contract3.cu `capture` (float64: each prefix stored as it is)."""
    nxt = n_r
    for sl, sp in zip(sums, spans):
        lo, hi = sp[r]
        if hi <= lo:
            continue
        if j == lo - 1:
            sl[r] = run
        if j == hi - 1:
            sl[r] = run - sl[r] if lo > 0 else run
        if lo - 1 > j:
            nxt = min(nxt, lo - 1)
        if hi - 1 > j:
            nxt = min(nxt, hi - 1)
    return nxt


def _add_in(to, spans, r, j, c):
    for sl, sp in zip(to, spans):
        lo, hi = sp[r]
        if lo <= j < hi:
            sl[r] += c


def walk_tile(cells, spans, flagged, full=False, own_walk=OWN_WALK):
    """(rows_l, 64) masked sums of one tile as the kernel's walk gives
    them: `cells` (64, n) floats (a row past the tile: anything), spans
    [(lo, hi)] * 64 per bound row (hi <= lo: empty), flagged (64,) the
    flag table's rows (ignored when `full`: every row with an interval
    walked whole and flagged by its own cells). Row r takes its cells
    below `own` as it forms them, then the staged ones from the step and
    lane `walk_schedule` gives, each checked to be the row's next cell,
    all through the kernel's loop body. Returns (sums, own, steps,
    cells shared)."""
    n = len(cells[0])
    reach = [max([hi for lo, hi in (sp[r] for sp in spans) if hi > lo],
                 default=0) for r in range(SPAN)]
    lens = [(n if full else rc) if rc > 0 else 0 for rc in reach]
    own, form, reads = walk_schedule(lens, own_walk)
    staged = [[None if f is None else cells[f[0]][f[1]] for f in st]
              for st in form]
    sums = [[0.0] * SPAN for _ in spans]
    for r in range(SPAN):
        if lens[r] == 0:
            continue
        alone = min(lens[r], own)
        assert [form[s][lane] for s, lane in reads[r]] == \
            [(r, j) for j in range(alone, lens[r])]
        taken = cells[r][:alone] + [staged[s][lane] for s, lane in reads[r]]
        cell_sums = [[0.0] * SPAN for _ in spans]
        run, ok = 0.0, True
        nxt = _capture(sums, spans, r, -1, run, lens[r])
        for j, c in enumerate(taken):
            if not full and flagged[r]:
                _add_in(sums, spans, r, j, c)
                continue
            if full:
                ok &= abs(c) <= cq.MAX_CELL
                if j < reach[r]:
                    _add_in(cell_sums, spans, r, j, c)
            run += c
            if j == nxt:
                nxt = _capture(sums, spans, r, j, run, lens[r])
        if full and not ok:
            for sl, cl in zip(sums, cell_sums):
                sl[r] = cl[r]
    shared = sum(f is not None for st in form for f in st)
    return sums, own, len(form), shared


def rule_tile(cells, spans, flagged, full=False):
    """The same sums by interval::row_sum's rule on the full row: the
    prefix S in index order read at hi - 1 and lo - 1, or, for a flagged
    row (a cell of the WHOLE row outside [-1, 1] or NaN when `full`), its
    cells [lo, hi) in index order."""
    out = []
    for sp in spans:
        row = []
        for r in range(SPAN):
            lo, hi = sp[r]
            if hi <= lo:
                row.append(0.0)
                continue
            if full:
                flag = not all(abs(c) <= cq.MAX_CELL for c in cells[r])
            else:
                flag = flagged[r]
            if flag:
                acc = 0.0
                for c in cells[r][lo:hi]:
                    acc += c
                row.append(acc)
                continue
            pre, acc = [], 0.0
            for c in cells[r]:
                acc += c
                pre.append(acc)
            row.append(pre[hi - 1] - pre[lo - 1] if lo > 0 else pre[hi - 1])
        out.append(row)
    return out


def _tile(n, reach_of, seed=0, los=None, flag_rows=(), poison=True):
    """A synthetic tile: cells uniform in (-0.6, 0.6), one interval per
    row [lo, hi) with hi = reach_of(r) (0: empty) and lo from `los` (r ->
    lo) or 0; flagged rows hold a cell of 7.5 below hi; with `poison`, NaN
    and inf past every row's hi (a walk reading past hi would show)."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(-0.6, 0.6, (SPAN, n))
    his = [reach_of(r) for r in range(SPAN)]
    spans = []
    for r in range(SPAN):
        lo = 0 if los is None else min(los(r), max(his[r] - 1, 0))
        spans.append((lo, his[r]))
        if poison and his[r] < n:
            cells[r, his[r]:] = np.where(
                rng.uniform(size=n - his[r]) < 0.5, np.nan, np.inf)
    flagged = [r in flag_rows for r in range(SPAN)]
    for r in flag_rows:
        cells[r, max(his[r] - 2, 0)] = 7.5
    return [list(map(float, row)) for row in cells], [spans], flagged


TILES = {
    # one active row in 64, past a step of 64 pairs
    "one_row": dict(n=130, reach_of=lambda r: 100 if r == 37 else 0),
    # reaches spread by more than 32 within each warp
    "spread": dict(n=200, reach_of=lambda r: (r * 53) % 199 + 1),
    # a flagged row among unflagged ones
    "flagged": dict(n=90, reach_of=lambda r: 20 + r, flag_rows=(5, 40)),
    # lo - 1 and hi - 1 on the edges of 32-cell chunks and 64-pair steps
    "edges": dict(n=160, reach_of=lambda r: (32, 33, 64, 65, 96, 128)[r % 6],
                  los=lambda r: (0, 33, 32, 64, 65, 97)[r % 6]),
    # every reach a multiple of 32
    "multiples": dict(n=128, reach_of=lambda r: 32 * (1 + r % 4)),
    # warp 0 idle, whole 32-column chunks past every row's reach
    "empty_chunks": dict(n=256, reach_of=lambda r: 0 if r < 32 else 3 + r % 7),
    # rows past the grid's end (a last tile of 44 rows) and equal reaches
    "short_tile": dict(n=50, reach_of=lambda r: 17 if r < 44 else 0),
    # every row walking: 50 rows alone to 64, 14 shared past it, with lo - 1
    # on the last column walked alone and on the first shared one
    "own_edge": dict(n=160, reach_of=lambda r: 64 if r < 50 else 90 + r,
                     los=lambda r: (0, 63, 64, 65)[r % 4], flag_rows=(51,)),
    # every row walking, reaches all different
    "dense": dict(n=200, reach_of=lambda r: 100 + (r * 37) % 90),
}


@pytest.mark.parametrize("own_walk", [OWN_WALK, 1, SPAN])
@pytest.mark.parametrize("full", [False, True], ids=["truncated", "full"])
@pytest.mark.parametrize("name", sorted(TILES))
def test_walk_schedule_keeps_each_rows_order(name, full, own_walk):
    """On tiles built to stress the schedule, every needed cell is formed
    once (by its own row below `own`, shared past it), each row adds its
    cells in index order, and the sums are interval::row_sum's bits; the
    shared cells take their count over 64 steps, rounded up (every lane
    forms at each step but the last). At the kernel's kOwnWalk, at 1 (the
    longest row's length: every row walks alone) and at 64 (rows walk
    alone only below the shortest)."""
    spec = dict(TILES[name])
    n = spec.pop("n")
    cells, spans, flagged = _tile(n, poison=not full, **spec)
    got, own, steps, shared = walk_tile(cells, spans, flagged, full=full,
                                        own_walk=own_walk)
    want = rule_tile(cells, spans, flagged, full=full)
    lens = [(n if full else hi) if hi > lo else 0 for lo, hi in spans[0]]
    assert own == sorted(lens, reverse=True)[own_walk - 1]
    assert shared == sum(max(v - own, 0) for v in lens)
    assert steps == -(-shared // SPAN)
    if own_walk == 1:
        assert shared == 0
    assert _same_bits(torch.tensor(got, dtype=torch.float64),
                      torch.tensor(want, dtype=torch.float64))


def test_walk_schedule_lane_use():
    """A tile with one row walking 100 cells shares them in 2 steps of 64
    lanes, not 100 steps of one; 64 rows of reaches 1..64 walk alone to
    17 (the 48th longest) and share the 1128 cells past it in 18 steps,
    every lane forming at each but the last."""
    lens = [100 if r == 9 else 0 for r in range(SPAN)]
    own, form, reads = walk_schedule(lens)
    assert own == 0 and len(form) == 2 and len(reads[9]) == 100
    assert all(f is not None for f in form[0])
    lens = [r + 1 for r in range(SPAN)]
    own, form, _ = walk_schedule(lens)
    shared = sum(max(v - own, 0) for v in lens)
    assert (own, shared, len(form)) == (17, 1128, 18)
    assert all(f is not None for st in form[:-1] for f in st)


def balanced_model(ops, bounds, weights, flags=None, full=False,
                   box_min=-5.0):
    """(L, T) as the rebuild sums with its lane-balanced walk: every
    (t, i0, 64-row tile) through `walk_tile` on the cells of U (rows
    past n and cells past a row's walk never read), the flags the flag
    twin's (or none, `full`), each tile's sums added in the kernel's lane
    order and the partials in (i0, tile) order."""
    U = cq3.contract3_weights_reference(ops)  # (T, r, n, n)
    if flags is None and not full:
        flags = cq3.contract3_row_flags_reference(ops)
    T_, r_, n = U.shape[:3]
    spans = _intervals(ops, bounds, weights, box_min)
    sums = torch.zeros((len(spans), T_, r_, n), dtype=torch.float64)
    pad = [[float("nan")] * n] * SPAN
    for t in range(T_):
        for i0 in range(r_):
            for r0 in range(0, n, SPAN):
                nr = min(SPAN, n - r0)
                cells = U[t, i0, r0:r0 + nr].tolist() + pad[nr:]
                tile_spans = [
                    [(int(lo[t, i0, r0 + r]), int(hi[t, i0, r0 + r]))
                     if r < nr and bool(used[t, i0, r0 + r]) else (0, 0)
                     for r in range(SPAN)] for lo, hi, used in spans]
                fl = [False] * SPAN if full else \
                    flags[t, i0, r0:r0 + nr].tolist() + [False] * (SPAN - nr)
                got = walk_tile(cells, tile_spans, fl, full=full)[0]
                for l, row in enumerate(got):
                    sums[l, t, i0, r0:r0 + nr] = torch.tensor(row[:nr],
                                                         dtype=torch.float64)
    return torch.stack([in_order(tile_sums(s, 64).reshape(T_, -1))
                        for s in sums])


@pytest.mark.parametrize("full", [False, True], ids=["truncated", "full"])
@pytest.mark.parametrize("kind", ["stage", "band", "poked", "empty"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_balanced_walk_equals_the_models(family, kind, full):
    """The lane-balanced walk, on either walk, gives `walk_model`'s and
    the full-row model's bits at L = 4 (n = 40: one tile of 40 rows)."""
    ops, _ = _case(family, edit=_poke if kind == "poked" else None)
    bounds = _bounds("stage" if kind == "poked" else kind, 4)
    w = _t(W)
    got = balanced_model(ops, bounds, w, full=full)
    assert _same_bits(got, walk_model(ops, bounds, w))
    for l in range(4):
        assert _same_bits(got[l], rebuild_model(ops, bounds[l], w[l], 64))
