"""The fused dim-3 route of the float64 solve on the CPU (`ops/
cuda_solver.py`: `solve_stages3`, `bisect3`, `max_halvings`): the
plumbing of `_full_solve` through it (forced onto the CPU) against the
composed route, the plain twin of the device bisection's launches
(`bisect3_reference`: a candidate state beside the state, row words, each
halving's decisions taken one launch late) against the gated halvings and
the while-loop bit for bit, and the launch count it is given. The kernels
run on the card only (`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    transform_u_columns,
)
from copula_var_tpu_torch.ops.solvers import bracket_state_batched
from copula_var_tpu_torch.utils.profiling import counters, reset_counters

F64 = torch.float64
TOL = 1e-6
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)  # the defaults: brackets reach -7.5
CFG_IN_GRID = (-3.0, -3.5, -2.0, -5.0, 0.0)
CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35], [0.25, 0.35, 1.0]])


def _ops3(family="msm", T=5, n=14, q=2, seed=0, edit=None):
    """Random dim-3 operands on the CPU (no table: the plain sweep);
    `edit(cols)` may poke the transform columns first."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64))

    spec = CopulaSpec("student", (6.5, t(CORR3)))
    cols = list(transform_u_columns(t(rng.uniform(0.002, 0.998, (T, 3, n))),
                                    spec))
    if edit is not None:
        edit(cols)
    x, dx = t(np.linspace(-5.0, 5.0, n)), t(np.full(n, 10.0 / n))
    if family == "garch":
        return cq3.contract3_operands(
            tuple(cols), x, dx, spec,
            p_cols=t(rng.uniform(0.0, 0.5, (T, 3, n))))
    return cq3.contract3_operands(
        tuple(cols), x, dx, spec, densities=t(rng.uniform(0.0, 0.5,
                                                          (3, q, n))),
        forecast_combos=t(rng.dirichlet(np.ones(q**3), size=T)))


def _rows3(L, shared, seed=1):
    rng = np.random.default_rng(seed)
    obj = torch.tensor(rng.choice([0.01, 0.025, 0.05, 0.1, 0.2], L))
    w = torch.tensor(rng.dirichlet([2.0, 2.0, 2.0], size=L))
    return obj, (w[0] if shared else w)


def _bracketed(ops, obj, weights, cfg):
    """The bracket state (lower, upper, prev_res, prev_up, ustack) after
    the plain stage sweeps, its NaN days and the (L, 3) weight rows."""
    (*state, nan), rows = cs._stages(ops, obj, weights, cfg, False, -5.0,
                                     cq3.masked_contract3_reference, F64)
    return [s.contiguous() for s in state], nan, rows


def _plant_frozen_row(state, row, lo=-9.0, up=-7.0):
    """Row `row` of the state bracketed wholly below the grid with a zero
    running result: its first slab is empty on every day, so its results
    are all exactly 0 and the row freezes at the first halving."""
    lower, upper, prev_res, prev_up, ustack = (s.clone() for s in state)
    lower[row], upper[row] = lo, up
    prev_res[row], prev_up[row], ustack[row] = 0.0, up, True
    return [lower, upper, prev_res, prev_up, ustack]


def _three_ways(ops, state, obj, rows):
    """(twin of the device bisection, capped at `max_halvings` of the
    defaults, gated halvings for the host count, the while-loop) on the
    same state."""
    widest = cs._widest(state[0], state[1])
    k = cs.halvings(float(widest), TOL)
    sweep = cq3.masked_contract3_reference
    return (cs.bisect3(ops, *state, obj, rows, TOL, widest=widest,
                       n_iters=cs.max_halvings(CFG, TOL)),
            cs.bisect_fixed_count(ops, *state, obj, rows, TOL, k, sweep),
            cs.bisect_levels_reference(ops, *state, obj, rows, TOL,
                                       sweep=sweep))


def _same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("cfg", [CFG, CFG_IN_GRID], ids=["cfg", "in_grid"])
def test_device_bisection_twin_equals_the_host_routes(family, cfg):
    """Brackets of the stage sweeps, one portfolio per row: the twin of
    the launches against `bisect_fixed_count` and the while-loop, bit for
    bit."""
    ops = _ops3(family)
    obj, weights = _rows3(4, shared=False)
    state, _, rows = _bracketed(ops, obj, weights, cfg)
    got, fixed, loop = _three_ways(ops, state, obj, rows)
    assert torch.equal(got, fixed) and torch.equal(got, loop)


def test_device_bisection_twin_freezes_an_all_zero_row():
    """A row whose first results are all exactly 0 freezes on every route
    (its root the midpoint of its planted bracket), and the others are
    unmoved by it."""
    ops = _ops3()
    obj, weights = _rows3(3, shared=False)
    state, _, rows = _bracketed(ops, obj, weights, CFG)
    planted = _plant_frozen_row(state, 1)
    mid = (torch.tensor(-9.0, dtype=F64) + torch.tensor(-7.0, dtype=F64)) / 2
    b_lo, b_up = planted[0][1], (planted[0][1] + planted[1][1]) / 2.0
    slab = cq3.masked_contract3_reference(
        ops, torch.stack((b_lo, b_up), -1)[None], rows[1:2])
    assert bool((slab == 0.0).all())
    got, fixed, loop = _three_ways(ops, planted, obj, rows)
    assert torch.equal(got, fixed) and torch.equal(got, loop)
    assert bool((got[1] == mid).all())
    alone, _, _ = _three_ways(ops, [s[::2].contiguous() for s in state],
                              obj[::2].contiguous(), rows[::2].contiguous())
    assert torch.equal(got[::2], alone)


def test_device_bisection_twin_exits_before_its_count():
    """The widest bracket belongs to a row that freezes at once, and the
    other rows are narrow: the loop exits after ~10 halvings while the
    count is 21 and the cap 23; the launches past the exit change
    nothing, as the gated halvings and the while-loop."""
    ops = _ops3(T=4)
    obj, weights = _rows3(3, shared=False, seed=3)
    state, _, rows = _bracketed(ops, obj, weights, CFG)
    # rows 0 and 2 narrowed to 1e-3 around their bracket's midpoint
    narrow = [s.clone() for s in state]
    for r in (0, 2):
        c = (state[0][r] + state[1][r]) / 2.0
        narrow[0][r], narrow[1][r] = c - 5e-4, c + 5e-4
    planted = _plant_frozen_row(narrow, 1)  # width 2: 21 halvings
    widest = float(cs._widest(planted[0], planted[1]))
    assert widest == 2.0 and cs.halvings(widest, TOL) == 21
    got, fixed, loop = _three_ways(ops, planted, obj, rows)
    assert torch.equal(got, fixed) and torch.equal(got, loop)
    reset_counters()
    cs.bisect3(ops, *planted, obj, rows, TOL,
               widest=cs._widest(planted[0], planted[1]), n_iters=23)
    assert 0 < counters()["solve.halvings"] <= 11


def test_device_bisection_twin_with_nan_days():
    """A non-finite column makes two days' stage results NaN: their
    brackets are the widest, (min_var, max_var), their results stay NaN
    (not 0: no freeze) and move each bracket down, on every route
    alike."""
    def edit(cols):
        cols[1][:2, 1, 4] = False  # NaN cells on days 0 and 1

    ops = _ops3(edit=edit)
    obj, weights = _rows3(3, shared=False, seed=5)
    state, nan, rows = _bracketed(ops, obj, weights, CFG)
    assert bool(nan[:, :2].all()) and not bool(nan[:, 2:].any())
    got, fixed, loop = _three_ways(ops, state, obj, rows)
    assert _same(got, fixed) and _same(got, loop)


@pytest.mark.parametrize("n_iters", [0, 5, 21])
def test_device_bisection_twin_stops_at_its_cap(n_iters):
    """A cap below the count stops the launches there: the roots are the
    gated halvings' for that many halvings (the route sets the cap to
    `max_halvings`, never below the count)."""
    ops = _ops3()
    obj, weights = _rows3(2, shared=False)
    state, _, rows = _bracketed(ops, obj, weights, CFG_IN_GRID)
    widest = cs._widest(state[0], state[1])
    got = cs.bisect3(ops, *state, obj, rows, TOL, widest=widest,
                     n_iters=n_iters)
    want = cs.bisect_fixed_count(
        ops, *state, obj, rows, TOL,
        min(n_iters, cs.halvings(float(widest), TOL)),
        cq3.masked_contract3_reference)
    assert torch.equal(got, want)


def test_bisect3_takes_float64_operands():
    ops = _ops3()
    obj, weights = _rows3(2, shared=False)
    state, _, rows = _bracketed(ops, obj, weights, CFG)
    with pytest.raises(ValueError, match="f64 engine"):
        cs.bisect3(ops._replace(x=ops.x.float()), *state, obj, rows, TOL,
                   widest=cs._widest(state[0], state[1]), n_iters=23)


@pytest.mark.parametrize("cfg", [
    CFG, CFG_IN_GRID, (-2.5, -3.0, -1.5, -10.0, 1.0),
    (-3.0, -3.5, -2.0, -3.6, -1.9), (-1.0, -4.0, 0.5, -20.0, 3.0)])
@pytest.mark.parametrize("tol", [1e-6, 1e-9, 0.3])
def test_max_halvings_covers_every_bracket(cfg, tol):
    """`max_halvings` is at least the host count of every bracket the
    stage-2 selects can form, and equal to the widest's: the device
    bisection's launches never stop a solve short."""
    fg, sg0, sg1, lo, hi = cfg
    pairs = [(lo, hi), (lo, sg0), (sg0, fg), (sg1, hi), (fg, sg1)]
    k = cs.max_halvings(cfg, tol)
    assert k == max(cs.halvings(b - a, tol) for a, b in pairs)
    # every bracket bracket_state_batched gives, over levels and results
    F1 = torch.tensor([[-1.0, 0.0, 0.02, 0.05, 0.3, 2.0, float("nan")]],
                      dtype=F64).expand(5, 7)
    obj = torch.tensor([0.0, 0.01, 0.05, 0.2, 1.0], dtype=F64)
    for I2 in (0.0, 0.01, 0.1, -0.5):
        lo_, hi_, *_ = bracket_state_batched(
            F1, obj, lambda b: torch.full(b.shape[:-1], I2, dtype=F64), cfg,
            False)
        for a, b in zip(lo_.flatten().tolist(), hi_.flatten().tolist()):
            assert cs.halvings(b - a, tol) <= k
    assert cs.max_halvings(CFG, 1e-6) == 23


def test_bisect3_words():
    """The words the launcher zeroes: per halving and row two, per launch
    and row one, per launch one (csrc `BisectWords::count`)."""
    assert cs.bisect3_words(23, 1) == 2 * 23 + 24 + 24
    assert cs.bisect3_words(0, 5) == 5 + 1
    assert cs.bisect3_words(23, 128) == 2 * 23 * 128 + 24 * 128 + 24


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
def test_fused_dim3_plumbing_of_full_solve(monkeypatch, shared):
    """`_full_solve` on the fused dim-3 route (forced onto the CPU):
    shared weights (3,) become (L, 3) rows for one `solve_stages3` call,
    whose state and widest bracket go to one `bisect3` call with the cap
    `max_halvings(cfg)`; a NaN cell in two days' stage slabs flags those
    days. Roots and NaN days are the composed route's bits."""
    def edit(cols):
        cols[1][:2, 1, 4] = False

    ops = _ops3(edit=edit)
    obj, weights = _rows3(3, shared=shared)
    want = cs.full_solve(ops, obj, weights, CFG, quirks=True)
    state, _ = cs._stages(ops, obj, weights, CFG, True, -5.0,
                          cq3.masked_contract3_reference, F64)
    seen = {"stages": [], "bisect": []}
    stages, bisect = cs.solve_stages3, cs.bisect3

    def stages_seen(ops_, obj_, weights_, *args, **kwargs):
        seen["stages"].append(tuple(weights_.shape))
        return stages(ops_, obj_, weights_, *args, **kwargs)

    def bisect_seen(*args, widest=None, n_iters=None, **kwargs):
        seen["bisect"].append((widest, n_iters))
        return bisect(*args, widest=widest, n_iters=n_iters, **kwargs)

    fused = cs.Route(stages_seen, cq3.masked_contract3_reference, "k4",
                     "device")
    monkeypatch.setattr(cs, "route", lambda *a, **k: fused)
    monkeypatch.setattr(cs, "bisect3", bisect_seen)
    roots, nan = cs.full_solve(ops, obj, weights, CFG, quirks=True)
    assert seen["stages"] == [(3, 3)]
    ((widest, n_iters),) = seen["bisect"]
    assert n_iters == cs.max_halvings(CFG, TOL) == 23
    assert torch.equal(widest, (state[1] - state[0]).max().reshape(1))
    assert bool(nan[:, :2].all()) and not bool(nan[:, 2:].any())
    assert torch.equal(nan, want[1]) and _same(roots, want[0])


def test_fused_dim3_route_keeps_the_fault_harness_seam(monkeypatch):
    """The fused dim-3 route bisects through `_routes`' bisection, the
    seam the benchmark's stale-bisection fault replaces: replaced, the
    roots are the stage-2 brackets' midpoints."""
    ops = _ops3()
    obj, weights = _rows3(2, shared=False)
    fused = cs.Route(cs.solve_stages3, cq3.masked_contract3_reference, "k4",
                     "device")
    monkeypatch.setattr(cs, "route", lambda *a, **k: fused)
    routes = cs._routes

    def stale_routes(ops_, plain):
        sweep, _ = routes(ops_, plain)
        return sweep, lambda ops, lower, upper, *a, **k: (lower + upper) / 2

    monkeypatch.setattr(cs, "_routes", stale_routes)
    roots, _ = cs.full_solve(ops, obj, weights, CFG)
    state, _ = cs._stages(ops, obj, weights, CFG, False, -5.0,
                          cq3.masked_contract3_reference, F64)
    assert torch.equal(roots, (state[0] + state[1]) / 2.0)
