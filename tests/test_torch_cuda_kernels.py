"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one. The
redesigned kernels (K1 `bisect_levels`, K2 `sweep_table` +
`masked_sweep`, K4 `contract3_weights` + `masked_contract3`, the
rebuild sweep `masked_contract3_rebuild` and its row flags
`contract3_row_flags`) are held at odd n, at their largest n and one past
it, q = 1 and 5, L = 1, 3 and 33 (more rows than warps), with NaN, inf
and saturated cells, and launched twice for bit-identical results; K2 on
rows of 193 and 1024 cells; the rebuild at n = 2, 170, 180 and 300, both
its walks (truncated with the flag table, and full rows without it) bit
for bit equal to each other and to the table sweep where both serve (the
dim-3 artifacts at n = 100 too), on row ranges and day blocks, and on
bands where most warps hold one walking row or reaches spread past 32
within a warp (f64 and f32); the flags
equal to their plain twin; and the wide dim-2 and dim-3 solves through K2
sweeps and the rebuild. K2 and K4 are also held on ranges of
outer grid rows (grid sharding): each range against its plain twin, the
ranges' partials summed against the whole launch, and the range of all
rows bit-equal to the whole launch. The float32 instantiations (the f32
engine, `engine="pallas"`) are held to their f32 plain twins: the table
P and the sweep, K1 for a fixed count (bit-equal to the same count of f32
K2 sweeps), the dim-3 table, its sweep, the flags and the rebuild
(bit-equal to the f32 table sweep), the fused f32 solves at dim 2 and 3,
the f32 limits, and each wrapper counting f32 launches apart from f64
ones; the f64 wrappers refuse float32 operands. The fused f64 solves
(`solve_stages` + K1 at dim 2, `solve_stages3` + `bisect3` at dim 3, the
latter on the d3 book at L = 1, 4, 16 and 32) are held bit for bit to
the composed routes, a planted all-zero row freezing on both. This file
imports neither JAX nor the JAX package, so it runs where JAX is not
installed (the repository's conftest imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from copula_var_tpu_torch.data import from_csv
from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    transform_u_columns,
)
from copula_var_tpu_torch.ops.solvers import bracket_state_batched
from copula_var_tpu_torch.parallel.mesh import DayMesh
from copula_var_tpu_torch.utils import profiling
from copula_var_tpu_torch.utils.artifacts import load_artifacts

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
# kernel and plain sweep sum the same float64 terms in different orders
RTOL_SWEEP = 1e-12
# identical masks and bookkeeping: a root moves only if rounding of a
# slab flipped res < obj
ATOL_ROOT = 1e-9


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _ops(dev, family, T=37, n=48, q=5, seed=0, edit=None, table=True,
         rows=None, dtype=torch.float64, days=None):
    """Random day operands on the card; n not a multiple of 32; `edit(V)`
    may poke cells of the day tensors first. With `table` False they are
    built on the CPU and moved, so they carry no prefix table; with
    `rows` (i0, i1) they hold those outer grid rows; `dtype` float32:
    the f32 engine's operands of the same float64 inputs; with `days` (a
    slice) those of a block of the T days."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64),
                            device=dev if table else "cpu")

    if not table:
        ops = _ops("cpu", family, T, n, q, seed, edit, rows=rows)
        return cq.SweepOperands(*[
            v.to(dev) if torch.is_tensor(v) else v for v in ops])

    x = np.sort(rng.uniform(-5.0, 5.0, n))
    dx = np.diff(x, prepend=x[0] - 0.2)
    V = rng.gamma(2.0, 0.05, (T, n, n))
    if edit is not None:
        edit(V)
    if family == "garch":
        return cq.sweep_operands(t(V), t(x), t(dx), rows=rows, dtype=dtype,
                                 days=days)
    dens = rng.uniform(0.0, 0.5, (2, q, n))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    return cq.sweep_operands(t(V), t(x), t(dx), t(dens), t(fc), rows=rows,
                             dtype=dtype, days=days)


def _rows(dev, T, L, seed=1):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-8.0, -1.0, (L, T))
    b = np.stack([lo, lo + rng.uniform(0.0, 4.0, (L, T))], -1)
    w = rng.uniform(0.1, 0.9, (L, 1))
    w = np.concatenate([w, 1.0 - w], axis=1)  # unequal weights per row
    return (torch.tensor(b, device=dev), torch.tensor(w, device=dev))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_masked_sweep_matches_plain(dev, family):
    ops = _ops(dev, family)
    bounds, weights = _rows(dev, ops.V.shape[0], 6)
    before = cq.launch_count(cq.masked_sweep)
    got = cq.masked_sweep(ops, bounds, weights)
    assert cq.launch_count(cq.masked_sweep) == before + 1
    want = cq.masked_sweep_reference(ops, bounds, weights)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL_SWEEP * scale


def test_masked_sweep_nan_cell_poisons_only_its_slabs(dev):
    ops = _ops(dev, "msm", T=8)
    V = ops.V.clone()
    V[:, 5, 5] = float("nan")  # inside some random slabs, outside others
    ops = cq.sweep_operands(V, ops.x, ops.dx, ops.densities,
                            ops.forecast_combos)
    bounds, weights = _rows(dev, 8, 6)
    got = cq.masked_sweep(ops, bounds, weights)
    want = cq.masked_sweep_reference(ops, bounds, weights)
    assert bool(torch.isnan(want).any()) and not bool(torch.isnan(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        RTOL_SWEEP * float(want[fin].abs().max())


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_bisect_levels_matches_plain(dev, family):
    ops = _ops(dev, family)
    T = ops.V.shape[0]
    _, weights = _rows(dev, T, 4)
    obj = torch.tensor([0.01, 0.05, 0.1, 0.2], dtype=torch.float64,
                       device=dev)
    stage1 = torch.tensor([-100.0, CFG[0]], dtype=torch.float64,
                          device=dev).expand(4, T, 2).contiguous()
    F1 = cq.masked_sweep(ops, stage1, weights)
    state = [s.contiguous() for s in bracket_state_batched(
        F1, obj, lambda b: cq.masked_sweep(ops, b.contiguous(), weights),
        CFG, False)[:5]]
    before = cq.launch_count(cs.bisect_levels)
    got = cs.bisect_levels(ops, *state, obj, weights, 1e-6)
    assert cq.launch_count(cs.bisect_levels) == before + 1
    want = cs.bisect_levels_reference(ops, *state, obj, weights, 1e-6)
    assert float((got - want).abs().max()) <= ATOL_ROOT


# the brackets' floor at the grid's edge: below it (CFG's -7.5) a first
# halving can give every day exactly 0, where the plain twin freezes the
# row (the all-zeros break the kernel omits)
CFG_IN_GRID = CFG[:3] + (-5.0, CFG[4])


def _bracketed(ops, dev, L, seed=2):
    """obj (L,), weights (L, 2) and the bracket state after the stage
    sweeps, for L rows of the day operands."""
    T = ops.V.shape[0]
    rng = np.random.default_rng(seed)
    obj = torch.tensor(rng.choice([0.01, 0.025, 0.05, 0.1, 0.2], L),
                       device=dev)
    w = rng.uniform(0.1, 0.9, (L, 1))
    weights = torch.tensor(np.concatenate([w, 1.0 - w], axis=1), device=dev)
    stage1 = torch.tensor([-100.0, CFG[0]], dtype=torch.float64,
                          device=dev).expand(L, T, 2).contiguous()
    F1 = cq.masked_sweep(ops, stage1, weights)
    state = [s.contiguous() for s in bracket_state_batched(
        F1, obj, lambda b: cq.masked_sweep(ops, b.contiguous(), weights),
        CFG_IN_GRID, False)[:5]]
    return obj, weights, state


@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("L", [1, 3, 33])
def test_bisect_levels_rows_and_widths(dev, q, L):
    """Odd n, the GARCH (q = 1) and MSM (q = 5) widths, and more rows than
    the block's warps; a second launch gives the same bits."""
    ops = _ops(dev, "garch" if q == 1 else "msm", T=9, n=37, q=q)
    obj, weights, state = _bracketed(ops, dev, L)
    got = cs.bisect_levels(ops, *state, obj, weights, 1e-6)
    want = cs.bisect_levels_reference(ops, *state, obj, weights, 1e-6)
    assert float((got - want).abs().max()) <= ATOL_ROOT
    assert torch.equal(got, cs.bisect_levels(ops, *state, obj, weights,
                                             1e-6))


def test_bisect_levels_nan_and_inf_cells(dev):
    """Rows holding NaN or inf cells are flagged and summed cell by cell:
    the bookkeeping sees the plain twin's slabs, NaN and inf included."""
    def edit(V):
        V[:3, 4, 9] = np.nan
        V[3:6, 11, 20] = np.inf
        V[6:, 2, 30] = -np.inf

    ops = _ops(dev, "msm", T=9, n=37, edit=edit)
    obj, weights, state = _bracketed(ops, dev, 4)
    got = cs.bisect_levels(ops, *state, obj, weights, 1e-6)
    want = cs.bisect_levels_reference(ops, *state, obj, weights, 1e-6)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((got[fin] - want[fin]).abs().max()) <= ATOL_ROOT


def test_bisect_levels_at_its_largest_grid(dev):
    n_max = cq.bisect_max_grid_points()
    assert n_max >= 168
    ops = _ops(dev, "garch", T=3, n=n_max)
    obj, weights, state = _bracketed(ops, dev, 3)
    got = cs.bisect_levels(ops, *state, obj, weights, 1e-6)
    want = cs.bisect_levels_reference(ops, *state, obj, weights, 1e-6)
    assert float((got - want).abs().max()) <= ATOL_ROOT
    big = _ops(dev, "garch", T=3, n=n_max + 1, table=False)
    with pytest.raises(ValueError, match="shared"):
        cs.bisect_levels(big, *state, obj, weights, 1e-6)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_flagship_through_kernels(dev, est):
    rec = np.load(os.path.join(DATA, "flagship_var.npz"))
    data = from_csv(os.path.join(DATA, "flagship.csv"), n_insample=1135)
    bt = load_artifacts(os.path.join(DATA, f"flagship_artifacts_{est}.npz"),
                        data, device="cuda")
    before = (cq.launch_count(cq.masked_sweep),
              cq.launch_count(cs.bisect_levels),
              cq.launch_count(cs.solve_stages))
    var = bt.calc_var(float(rec["obj_var"]))
    # one card, float64, n = 100: the fused route (solve_stages, then K1
    # counting on the device), no K2 stage sweep
    assert cq.launch_count(cq.masked_sweep) == before[0]
    assert cq.launch_count(cs.bisect_levels) == before[1] + 1
    assert cq.launch_count(cs.solve_stages) == before[2] + 1
    np.testing.assert_allclose(var, rec[f"{est}_var"], rtol=0,
                               atol=ATOL_ROOT)


def test_kernels_reject_what_they_do_not_take(dev):
    with pytest.raises(ValueError, match="interval rule"):  # past kMaxRow
        _ops(dev, "garch", T=2, n=1025)
    bounds, weights = _rows(dev, 2, 1)
    ops = _ops(dev, "garch", T=2)
    with pytest.raises(ValueError, match="prefix table"):
        cq.masked_sweep(ops._replace(P=None), bounds, weights)
    strided = torch.zeros((1, 2, 4), dtype=torch.float64, device=dev)[..., ::2]
    strided.copy_(bounds)
    with pytest.raises(ValueError, match="contiguous"):
        cq.masked_sweep(ops, strided, weights)
    with pytest.raises(ValueError, match="float64"):
        cq.masked_sweep(ops, bounds.float(), weights)


# -- the fused stages (solve_stages) and K1's count on the device -------------

def _launches_now():
    return {w.__name__: cq.launch_count(w) for w in (
        cq.masked_sweep, cs.bisect_levels, cs.solve_stages)}


def _composed(ops, obj, weights, cfg, quirks, tol=1e-6):
    """The route the fused one replaces, called directly: the K2 stage-1
    sweep (once for shared weights (2,), per row for (L, 2)),
    `bracket_state_batched` over K2, then K1 for the host-counted
    halvings. Returns (the bracket state, the (L, 2) weight rows,
    roots)."""
    T, L = ops.days, obj.shape[0]
    stage1 = torch.tensor([-100.0, cfg[0]], dtype=torch.float64,
                          device=obj.device)
    if weights.dim() == 1:
        rows = weights.reshape(1, 2).expand(L, 2).contiguous()
        F1 = cq.masked_sweep(ops, stage1.expand(1, T, 2).contiguous(),
                             weights.reshape(1, 2)).expand(L, T)
    else:
        rows = weights
        F1 = cq.masked_sweep(ops, stage1.expand(L, T, 2).contiguous(), rows)
    state = bracket_state_batched(
        F1, obj, lambda b: cq.masked_sweep(ops, b.contiguous(), rows), cfg,
        quirks)
    roots = cs.bisect_levels(ops, *(t.contiguous() for t in state[:5]), obj,
                             rows, tol)
    return state, rows, roots


def _fused_equals_composed(ops, obj, weights, cfg, quirks=False):
    """solve_stages' outputs bit-equal to the composed route's state and
    widest bracket; the solve (`full_solve`, with shared weights or one
    portfolio per row) takes the fused route, launching
    solve_stages and K1 once each and no K2, and its roots and NaN days
    are the composed route's bits. Returns (roots, nan_days, widest)."""
    state, rows, want = _composed(ops, obj, weights, cfg, quirks)
    got = cs.solve_stages(ops, obj, rows, cfg, quirks)
    for name, g, w in zip(("lower", "upper", "prev_res", "prev_up",
                           "ustack", "nan_days"), got, state):
        assert _same(g, w), name
    widest = got[6]
    assert torch.equal(widest, (state[1] - state[0]).max().reshape(1))
    before = _launches_now()
    roots, nan = cs.full_solve(ops, obj, weights, cfg, quirks=quirks)
    after = _launches_now()
    assert {k: after[k] - before[k] for k in after} == {
        "masked_sweep": 0, "bisect_levels": 1, "solve_stages": 1}
    assert _same(roots, want)
    assert torch.equal(nan, state[5])
    return roots, nan, float(widest)


@pytest.mark.parametrize("quirks", [False, True], ids=["plain", "quirks"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("L", [1, 4, 128])
@pytest.mark.parametrize("n", [53, 100, 169])
def test_solve_stages_route_equals_the_composed_route(dev, n, L, shared,
                                                      quirks):
    """The fused route against K2 stage sweeps + bracket_state_batched +
    the host-counted K1, bit for bit, for one row, a few and the grid
    cell's 128, with one portfolio shared by every row or one per row, and
    the reference's anchor on and off, on a grid not a multiple of 32, the
    flagship's n = 100 and K1's widest, 169; and against the plain twins
    within ATOL_ROOT (brackets inside the grid, so the twin's all-zeros
    break stays off)."""
    ops = _ops(dev, "msm", T=23, n=n)
    rng = np.random.default_rng(L)
    obj = torch.tensor(rng.choice([0.01, 0.025, 0.05, 0.1, 0.2], L),
                       device=dev)
    w = rng.uniform(0.1, 0.9, (L, 1))
    w = np.concatenate([w, 1.0 - w], axis=1)
    weights = torch.tensor(w[0] if shared else w, device=dev)
    roots, nan, _ = _fused_equals_composed(ops, obj, weights, CFG_IN_GRID,
                                           quirks)
    rows = weights.expand(L, 2) if shared else weights
    want, want_nan = cs.full_solve_reference(
        ops, obj, rows.contiguous(), CFG_IN_GRID, quirks=quirks)
    assert torch.equal(nan, want_nan)
    assert float((roots - want).abs().max()) <= ATOL_ROOT


def test_solve_stages_route_with_a_nan_day(dev):
    """A NaN cell inside the stage slabs of two days: those days' results
    are NaN and flagged, as on the composed route, bit for bit."""
    def edit(V):
        V[:2, 4, 9] = np.nan

    ops = _ops(dev, "msm", T=9, n=48, edit=edit)
    obj = torch.tensor([0.01, 0.05, 0.1], dtype=torch.float64, device=dev)
    weights = torch.tensor([[0.5, 0.5], [0.3, 0.7], [0.6, 0.4]],
                           dtype=torch.float64, device=dev)
    roots, nan, _ = _fused_equals_composed(ops, obj, weights, CFG)
    assert bool(nan[:, :2].all()) and not bool(nan[:, 2:].any())


@pytest.mark.parametrize("cls", ["min_sg0", "sg0_fg", "fg_sg1", "sg1_max",
                                 "nan"])
def test_device_count_takes_each_width_class(dev, cls):
    """Levels placed so that every (row, day) bracket, and so the widest,
    falls in one width class of CFG: (min_var, sg0) 4.0, (sg0, fg) 0.5,
    (fg, sg1) 1.0, (sg1, max_var) 2.0, and (min_var, max_var) 7.5 for a
    NaN day. The device count takes the host's count for each, five
    distinct counts, and the roots are the composed route's bits."""
    def edit(V):
        V[1:] = V[0]  # every day the same: one bracket class for all
        if cls == "nan":
            V[3, 4, 9] = np.nan

    ops = _ops(dev, "garch", T=6, n=53, edit=edit)
    w = torch.tensor([0.5, 0.5], dtype=torch.float64, device=dev)
    F = {b: float(cq.masked_sweep(ops, torch.tensor(
        [[[-100.0, b]] * 6], dtype=torch.float64, device=dev),
        w.reshape(1, 2))[0, 0]) for b in (-3.5, -3.0, -2.0)}
    assert 0.0 < F[-3.5] < F[-3.0] < F[-2.0]
    level = {"min_sg0": F[-3.5] / 2, "sg0_fg": (F[-3.5] + F[-3.0]) / 2,
             "fg_sg1": (F[-3.0] + F[-2.0]) / 2, "sg1_max": 2 * F[-2.0],
             "nan": F[-3.5] / 2}[cls]
    width = {"min_sg0": 4.0, "sg0_fg": 0.5, "fg_sg1": 1.0, "sg1_max": 2.0,
             "nan": 7.5}[cls]
    obj = torch.full((3,), level, dtype=torch.float64, device=dev)
    _, nan, widest = _fused_equals_composed(ops, obj, w, CFG)
    assert widest == width
    assert bool(nan.any()) == (cls == "nan")
    assert sorted(cs.halvings(v, 1e-6) for v in (4.0, 0.5, 1.0, 2.0, 7.5)) \
        == [19, 20, 21, 22, 23]


def test_solve_stages_route_on_an_empty_block_launches_nothing(dev):
    """Operands of 0 days on one card (no mesh): the fused route returns
    empty roots and NaN days and launches nothing."""
    ops = _ops(dev, "msm", T=4, days=slice(4, 4))
    obj = torch.tensor([0.01, 0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([0.5, 0.5], dtype=torch.float64, device=dev)
    before = _launches_now()
    roots, nan = cs.full_solve(ops, obj, w, CFG)
    out = cs.solve_stages(ops, obj, w.expand(2, 2).contiguous(), CFG)
    assert roots.shape == nan.shape == (2, 0)
    assert [t.shape for t in out[:6]] == [(2, 0)] * 6
    assert torch.equal(out[6], torch.zeros(1, dtype=torch.float64,
                                           device=dev))
    assert _launches_now() == before


def test_solve_stages_refuses_what_it_does_not_take(dev):
    """The wrapper refuses a grid K1 does not hold, operands without P,
    f32 operands and a device count with a day mesh; the launchers refuse
    rows past the short form and K1 without its widest word."""
    obj = torch.tensor([0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([[0.5, 0.5]], dtype=torch.float64, device=dev)
    big = _ops(dev, "garch", T=2, n=cq.bisect_max_grid_points() + 1)
    with pytest.raises(ValueError, match="shared"):
        cs.solve_stages(big, obj, w, CFG)
    ops = _ops(dev, "garch", T=2)
    with pytest.raises(ValueError, match="prefix table"):
        cs.solve_stages(ops._replace(P=None), obj, w, CFG)
    with pytest.raises(ValueError, match="f64 engine"):
        cs.solve_stages(_ops(dev, "garch", T=2, dtype=F32), obj, w, CFG)
    state = cs.solve_stages(ops, obj, w, CFG)
    with pytest.raises(ValueError, match="global MAX"):
        cs.bisect_levels(ops, *state[:5], obj, w, 1e-6,
                         reducer=DayMesh(None, 0, 1, dev), widest=state[6])
    lib = _build.load()
    invalid = 1  # cudaErrorInvalidValue

    def stages(n):
        return lib.cvt_solve_stages(*[None] * 5, -3.0, -3.5, -2.0, -7.5,
                                    0.0, 0, -5.0, *[None] * 7, 0, n, 1,
                                    cq.row_pitch(n), None)

    assert (stages(192), stages(193)) == (0, invalid)
    assert lib.cvt_bisect_levels_widest(*[None] * 11, -5.0, None, 1e-6,
                                        None, 0, 48, 5, 1, None) == invalid
    assert not hasattr(lib, "cvt_solve_stages_f32")


# -- the dim-2 sweep (K2/K3): prefix table and interval rule -------------------

RTOL_TABLE = 1e-12  # sequential prefix sums vs torch.cumsum's parallel scan


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_sweep_table_matches_plain(dev, family):
    """P and the flags, built once with the operands, against the plain
    twin (odd n: rows unpadded; even n: one zero pad cell per row); a
    rebuild gives the same bits."""
    for n in (37, 48):
        before = cq.launch_count(cq.sweep_table)
        ops = _ops(dev, family, T=9, n=n)
        assert cq.launch_count(cq.sweep_table) == before + 1
        assert ops.P.shape == (9, n, cq.row_pitch(n))
        want, flags = cq.sweep_table_reference(ops)
        assert torch.equal(ops.flags, flags) and not bool(flags.any())
        assert bool(torch.isclose(ops.P, want, rtol=RTOL_TABLE,
                                  atol=1e-300).all())
        assert bool((ops.P[..., n:] == 0).all())
        assert torch.equal(ops.P, cq.sweep_table(ops)[0])


def _sweep_close(got, want):
    """Same NaN and inf cells, the finite ones within RTOL_SWEEP x scale."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert bool(torch.isfinite(got[fin]).all())
    assert float((got[fin] - want[fin]).abs().max()) <= \
        RTOL_SWEEP * float(want[fin].abs().max())


@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("L", [1, 3, 33])
def test_masked_sweep_rows_and_widths(dev, q, L):
    """Odd n, the GARCH (q = 1) and MSM (q = 5) widths, more rows than a
    block's warps; a second launch gives the same bits."""
    ops = _ops(dev, "garch" if q == 1 else "msm", T=9, n=37, q=q)
    bounds, weights = _rows(dev, 9, L)
    got = cq.masked_sweep(ops, bounds, weights)
    _sweep_close(got, cq.masked_sweep_reference(ops, bounds, weights))
    assert torch.equal(got, cq.masked_sweep(ops, bounds, weights))


def test_masked_sweep_at_its_largest_grid(dev):
    """K2 takes the interval rule's rows (1024), past K1's day (169)."""
    n_max = cq.SWEEP_MAX_GRID_POINTS
    assert n_max > cq.bisect_max_grid_points()
    ops = _ops(dev, "msm", T=3, n=n_max)
    bounds, weights = _rows(dev, 3, 4)
    _sweep_close(cq.masked_sweep(ops, bounds, weights),
                 cq.masked_sweep_reference(ops, bounds, weights))
    with pytest.raises(ValueError, match="interval rule"):
        _ops(dev, "msm", T=3, n=n_max + 1)


def test_masked_sweep_nan_inf_and_saturated_cells(dev):
    """Rows holding NaN, +inf or -inf cells are flagged and summed cell by
    cell: each poisons exactly the slabs that hold it, as in the plain
    twin."""
    def edit(V):
        V[:3, 4, 9] = np.nan
        V[3:6, 11, 20] = np.inf
        V[6:, 2, 30] = -np.inf

    ops = _ops(dev, "msm", T=9, n=37, edit=edit)
    assert int(ops.flags.sum()) == 9
    assert torch.equal(ops.P[:3, 4, :37].isnan(), ops.V[:3, 4].isnan())
    bounds, weights = _rows(dev, 9, 12)
    got = cq.masked_sweep(ops, bounds, weights)
    want = cq.masked_sweep_reference(ops, bounds, weights)
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())
    assert bool(torch.isfinite(want).any())
    _sweep_close(got, want)


def test_masked_sweep_saturated_cell_does_not_absorb_its_row(dev):
    """GARCH: one cell per row saturated to DBL_MAX (as nan_to_num leaves
    an overflowed density) at j = 3. Every row is flagged, so bounds whose
    intervals all start after that cell give the true moderate sums (a
    prefix difference would give S - S of the huge cell)."""
    def edit(V):
        V[:, :, 3] = np.finfo(np.float64).max

    ops = _ops(dev, "garch", T=5, n=41, edit=edit)
    assert bool(ops.flags.all())
    L, T = 3, 5
    lo = np.random.default_rng(4).uniform(1.5, 2.5, (L, T))
    bounds = torch.tensor(np.stack([lo, lo + np.random.default_rng(5).uniform(
        0.5, 3.0, (L, T))], -1), device=dev)
    weights = torch.tensor([[0.5, 0.5], [0.6, 0.4], [0.7, 0.3]],
                           dtype=torch.float64, device=dev)
    got = cq.masked_sweep(ops, bounds, weights)
    want = cq.masked_sweep_reference(ops, bounds, weights)
    assert bool((want > 0).all()) and bool((want < 1e10).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL_SWEEP, atol=0)


def test_masked_sweep_rows_are_batch_invariant(dev):
    """A bound row gets the same bits alone as inside a 33-row batch: each
    (row, day) is one warp's fixed-order sum."""
    ops = _ops(dev, "msm", T=9, n=37)
    bounds, weights = _rows(dev, 9, 33)
    batch = cq.masked_sweep(ops, bounds, weights)
    for l in (0, 15, 32):
        alone = cq.masked_sweep(ops, bounds[l:l + 1].contiguous(),
                                weights[l:l + 1].contiguous())
        assert torch.equal(alone[0], batch[l])


def test_compute_integral_through_the_kernel(dev):
    """K3: `VaRBacktest.compute_integral`, one sweep of the flagship MSM
    backtest at L = 1, launches the kernel and matches the plain twin."""
    data = from_csv(os.path.join(DATA, "flagship.csv"), n_insample=1135)
    bt = load_artifacts(os.path.join(DATA, "flagship_artifacts_msm.npz"),
                        data, device="cuda")
    ops = bt.sweep_operands()
    lo = np.random.default_rng(6).uniform(-8.0, -1.0, ops.days)
    b = np.stack([lo, lo + 2.0], -1)
    before = cq.launch_count(cq.masked_sweep)
    got = bt.compute_integral(b)
    assert cq.launch_count(cq.masked_sweep) == before + 1
    want = cq.masked_sweep_reference(
        ops, torch.tensor(b, device=dev)[None], bt.weights[None])[0]
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=0,
                               atol=RTOL_SWEEP * float(want.abs().max()))


# -- the dim-3 kernel (K4) ----------------------------------------------------

CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35], [0.25, 0.35, 1.0]])


def _ops3(dev, family, kind, T=6, n=40, q=3, seed=0, edit=None, rows=None,
          dtype=torch.float64, days=None):
    """Random dim-3 operands on the card; `edit(cols, p)` may poke cells
    of the transform or pdf columns before the operands are built; with
    `rows` (i0, i1) those of outer slabs [i0, i1); `dtype` float32: the
    f32 engine's operands; with `days` (a slice) those of a block of the
    T days."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), device=dev)

    corr = t(CORR3)
    spec = (CopulaSpec("student", (6.5, corr)) if kind == "student"
            else CopulaSpec("gaussian", (corr,)))
    cols = list(transform_u_columns(t(rng.uniform(0.002, 0.998, (T, 3, n))),
                                    spec))
    x = t(np.linspace(-5.0, 5.0, n))
    dx = t(np.full(n, 10.0 / n))
    p = t(rng.uniform(0.0, 0.5, (T, 3, n))) if family == "garch" else None
    if edit is not None:
        edit(cols, p)
    if family == "garch":
        return cq3.contract3_operands(tuple(cols), x, dx, spec, p_cols=p,
                                      rows=rows, dtype=dtype, days=days)
    dens = t(rng.uniform(0.0, 0.5, (3, q, n)))
    fc = t(rng.dirichlet(np.ones(q**3), size=T))
    return cq3.contract3_operands(tuple(cols), x, dx, spec, densities=dens,
                                  forecast_combos=fc, rows=rows, dtype=dtype,
                                  days=days)


def _rows3(dev, T, L, seed=1):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-6.0, -0.5, (L, T))
    b = np.stack([lo, lo + rng.uniform(0.0, 4.0, (L, T))], -1)
    w = rng.dirichlet([2.0, 2.0, 2.0], size=L)  # unequal weights per row
    return (torch.tensor(b, device=dev), torch.tensor(w, device=dev))


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_masked_contract3_matches_plain(dev, family, kind):
    ops = _ops3(dev, family, kind)
    bounds, weights = _rows3(dev, ops.days, 5)
    before = cq.launch_count(cq3.masked_contract3)
    got = cq3.masked_contract3(ops, bounds, weights)
    assert cq.launch_count(cq3.masked_contract3) == before + 1
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL_SWEEP * scale


def test_masked_contract3_nan_cell_poisons_only_its_slabs(dev):
    def edit(cols, p):
        cols[1][:, 1, 7] = False  # a non-finite column: NaN cells

    ops = _ops3(dev, "msm", "student", edit=edit)
    bounds, weights = _rows3(dev, ops.days, 8)
    got = cq3.masked_contract3(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    assert bool(torch.isnan(want).any()) and not bool(torch.isnan(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        RTOL_SWEEP * float(want[fin].abs().max())


def test_masked_contract3_garch_nan_to_num(dev):
    """GARCH cells: NaN -> 0, +inf -> DBL_MAX, -inf -> -DBL_MAX, as
    torch.nan_to_num, before the mask."""
    def edit(cols, p):
        cols[1][:, 2, 3] = False  # NaN density cells
        # one cell per day whose pdf product overflows: +inf on day 0,
        # -inf on day 1 (every other cell of the slab stays finite)
        p[:2, :, :] = p[:2, :, :].clamp(min=0.01)
        p[:2, 1, 20] = p[:2, 2, 10] = 1e110
        p[0, 0, 30], p[1, 0, 30] = 1e110, -1e110

    ops = _ops3(dev, "garch", "student", edit=edit)
    L = 6
    b = torch.tensor([[-100.0, 100.0]], dtype=torch.float64,
                     device=dev).expand(L, ops.days, 2).contiguous()
    _, weights = _rows3(dev, ops.days, L)
    got = cq3.masked_contract3(ops, b, weights)
    want = cq3.masked_contract3_reference(ops, b, weights)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, 0] > 1e300).all()) and bool((got[:, 1] < -1e300).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL_SWEEP)


def test_masked_contract3_is_deterministic(dev):
    ops = _ops3(dev, "msm", "student", T=12)
    bounds, weights = _rows3(dev, ops.days, 4)
    first = cq3.masked_contract3(ops, bounds, weights)
    assert torch.equal(first, cq3.masked_contract3(ops, bounds, weights))


def test_masked_contract3_rejects_what_it_does_not_take(dev):
    wide = _ops3(dev, "garch", "gaussian", T=2, n=200)
    assert wide.U is None  # the operands take the rebuild route
    with pytest.raises(ValueError, match="shared"):  # slab over 227 KB
        cq3.contract3_weights(wide)
    bounds, weights = _rows3(dev, 2, 1)
    ops = _ops3(dev, "garch", "gaussian", T=2)
    with pytest.raises(ValueError, match="float64"):
        cq3.masked_contract3(ops, bounds.float(), weights)
    plackett = ops._replace(spec=CopulaSpec("plackett", (4.0,)))
    with pytest.raises(ValueError, match="Gaussian or Student"):
        cq3.contract3_weights(plackett)
    with pytest.raises(ValueError, match="table U"):
        cq3.masked_contract3(ops._replace(U=None), bounds, weights)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_contract3_weights_matches_plain(dev, family, kind):
    """The table U in its stored form (prefix rows), built once with the
    operands, against its plain twin, with its row flags; its pads zero
    (odd n: one pad cell per slab; even n: one per row); a second build
    the same bits."""
    before = cq.launch_count(cq3.contract3_weights)
    for n in (41, 40):
        ops = _ops3(dev, family, kind, n=n)
        assert cq.launch_count(cq3.contract3_weights) == before + 1
        before += 1
        assert ops.U.shape == (ops.days, n, cq3.slab_stride(n))
        assert ops.flags.shape == (ops.days, n, n)
        got = cq3.table_cells(ops.U, n)
        want, flags = cq3.contract3_table_reference(ops)
        assert torch.equal(ops.flags, flags)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isclose(got, want, rtol=RTOL_SWEEP, atol=1e-300,
                                  equal_nan=True).all())
        assert bool((cq3.table_pads(ops.U, n) == 0).all())
        U, flags = cq3.contract3_weights(ops)
        assert torch.equal(ops.U, U) and torch.equal(ops.flags, flags)
        before += 1


@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("L", [1, 3, 33])
def test_masked_contract3_rows_and_widths(dev, q, L):
    """Odd n, q = 1 and 5, more rows than warps; repeats are
    bit-equal."""
    ops = _ops3(dev, "garch" if q == 1 else "msm", "student", T=5, n=41,
                q=q)
    bounds, weights = _rows3(dev, ops.days, L)
    got = cq3.masked_contract3(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL_SWEEP * scale
    assert torch.equal(got, cq3.masked_contract3(ops, bounds, weights))


def test_masked_contract3_inf_cells_are_flagged(dev):
    """A column whose log pdf is -1000 overflows the Student density to
    inf: its rows are flagged and summed cell by cell, so the slabs that
    hold those cells are inf and the others finite, as in the plain
    twin."""
    def edit(cols, p):
        cols[2][:, 1, 7] = -1000.0

    ops = _ops3(dev, "msm", "student", edit=edit)
    bounds, weights = _rows3(dev, ops.days, 8)
    got = cq3.masked_contract3(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    assert bool(torch.isinf(want).any()) and bool(torch.isfinite(want).any())
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        RTOL_SWEEP * float(want[fin].abs().max())


def test_masked_contract3_saturated_cell_does_not_absorb_its_row(dev):
    """GARCH: a density that overflows at i2 = 3 on every row saturates
    one cell per row to DBL_MAX * dx^3 (finite). Rows holding it are
    flagged, so the bounds below, whose intervals all start after that
    cell, give the true moderate sums, row by row (a prefix difference
    would give S - S of the huge cell)."""
    def edit(cols, p):
        cols[2][:, 2, 3] = -1000.0

    ops = _ops3(dev, "garch", "student", edit=edit)
    assert bool((cq3.table_cells(ops.U, 40)[..., 3] > 1e300).all())
    L, T = 3, ops.days
    lo = np.random.default_rng(4).uniform(1.5, 2.5, (L, T))
    bounds = torch.tensor(np.stack([lo, lo + np.random.default_rng(5).uniform(
        0.5, 3.0, (L, T))], -1), device=dev)
    weights = torch.tensor([[0.5, 0.3, 0.2], [0.4, 0.4, 0.2],
                            [0.6, 0.1, 0.3]], dtype=torch.float64,
                           device=dev)
    got = cq3.masked_contract3(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    assert bool((want > 0).all()) and bool((want < 1e10).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL_SWEEP, atol=0)


def test_masked_contract3_rows_are_batch_invariant(dev):
    """A bound row gets the same bits alone as inside a 33-row batch: the
    kernel's partials depend on the row, day and grid index, not on L."""
    ops = _ops3(dev, "msm", "student", T=5, n=41, q=5)
    bounds, weights = _rows3(dev, ops.days, 33)
    batch = cq3.masked_contract3(ops, bounds, weights)
    for l in (0, 15, 32):
        alone = cq3.masked_contract3(ops, bounds[l:l + 1].contiguous(),
                                     weights[l:l + 1].contiguous())
        assert torch.equal(alone[0], batch[l])


def test_masked_contract3_at_its_largest_grid(dev):
    n_max = cq3.table_max_grid_points(5)
    assert n_max >= 166  # every n the former fused kernel took at q = 5
    ops = _ops3(dev, "msm", "gaussian", T=2, n=n_max, q=5)
    bounds, weights = _rows3(dev, 2, 3)
    got = cq3.masked_contract3(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL_SWEEP * scale
    wide = _ops3(dev, "msm", "gaussian", T=2, n=n_max + 1, q=5)
    assert wide.U is None  # the operands take the rebuild route
    with pytest.raises(ValueError, match="shared"):
        cq3.contract3_weights(wide)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_dim3_through_kernels(dev, est):
    rec = np.load(os.path.join(DATA, "dim3_var.npz"))
    data = from_csv(os.path.join(DATA, "dim3.csv"), n_insample=1135,
                    weights=rec["weights"])
    bt = load_artifacts(os.path.join(DATA, f"dim3_artifacts_{est}.npz"),
                        data, device="cuda")
    wrappers = (cq.masked_sweep, cs.bisect_levels, cq3.contract3_weights,
                cq3.masked_contract3, cs.solve_stages3, cs.bisect3)
    before = tuple(cq.launch_count(w) for w in wrappers)
    var = bt.calc_var(float(rec["obj_var"]))
    after = tuple(cq.launch_count(w) for w in wrappers)
    # one card, float64, the table U: the fused dim-3 route (solve_stages3,
    # then the bisection counting on the device), no K4 sweep of its own
    assert after[:2] == before[:2]
    assert after[2] == before[2] + 1 and after[3] == before[3]
    assert after[4:] == (before[4] + 1, before[5] + 1)
    np.testing.assert_allclose(var, rec[f"{est}_var"], rtol=0,
                               atol=ATOL_ROOT)


# -- the fused dim-3 solve (solve_stages3, bisect3) -----------------------------

@pytest.fixture(scope="module")
def ops_book3(dev):
    """The three-asset MSM book's operands on the card (T = 500, n = 100,
    the table U): the benchmark's d3 book."""
    rec = np.load(os.path.join(DATA, "dim3_var.npz"))
    data = from_csv(os.path.join(DATA, "dim3.csv"), n_insample=1135,
                    weights=rec["weights"])
    bt = load_artifacts(os.path.join(DATA, "dim3_artifacts_msm.npz"), data,
                        device="cuda")
    ops = bt.sweep_operands()
    assert ops.U is not None
    return ops


def _launches3():
    return {w.__name__: cq.launch_count(w) for w in (
        cq3.masked_contract3, cs.solve_stages3, cs.bisect3)}


def _rows_d3(dev, L, shared, seed):
    """L levels of the query ladder and Dirichlet(2, 2, 2) weights: one
    portfolio (3,) shared by every row, or one per row (L, 3)."""
    rng = np.random.default_rng(seed)
    obj = torch.tensor(rng.choice([0.01, 0.025, 0.05, 0.1], L), device=dev)
    w = rng.dirichlet([2.0, 2.0, 2.0], size=L)
    return obj, torch.tensor(w[0] if shared else w, device=dev)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("L", [1, 4, 16, 32])
def test_fused_dim3_route_equals_the_composed_route(dev, ops_book3, L,
                                                     shared):
    """The d3 book, one level and portfolio per row or one portfolio for
    all: the fused route (one solve_stages3 launch and one bisect3
    launcher call, no masked_contract3) against the composed route of the
    same operands (forced by a day mesh of one: the K4 stage sweeps,
    bracket_state_batched and the host-counted gated halvings of K4), bit
    for bit in roots and NaN days; its stages against the composed
    bracket state and widest bracket."""
    ops = ops_book3
    obj, weights = _rows_d3(dev, L, shared, seed=100 + L)
    before = _launches3()
    roots, nan = cs.full_solve(ops, obj, weights, CFG)
    after = _launches3()
    assert {k: after[k] - before[k] for k in after} == {
        "masked_contract3": 0, "solve_stages3": 1, "bisect3": 1}
    one = DayMesh(None, 0, 1, dev)
    assert cs._route(ops, reducer=one).stages is None
    want, want_nan = cs.full_solve(ops, obj, weights, CFG, reducer=one)
    assert _same(roots, want)
    assert torch.equal(nan, want_nan)
    rows = (weights.expand(L, 3) if shared else weights).contiguous()
    state, _ = cs._stages(ops, obj, rows, CFG, False, -5.0,
                          cq3.masked_contract3, torch.float64)
    got = cs.solve_stages3(ops, obj, rows, CFG)
    for name, g, w in zip(("lower", "upper", "prev_res", "prev_up",
                           "ustack", "nan_days"), got, state):
        assert _same(g, w), name
    assert torch.equal(got[6], (state[1] - state[0]).max().reshape(1))


def _planted(state, row):
    """Row `row` bracketed wholly below the grid, (-9, -7), with a zero
    running result: its first slab is empty, its results all exactly 0."""
    lower, upper, prev_res, prev_up, ustack = (s.clone() for s in state)
    lower[row], upper[row] = -9.0, -7.0
    prev_res[row], prev_up[row], ustack[row] = 0.0, -7.0, True
    return [lower, upper, prev_res, prev_up, ustack]


def test_fused_dim3_freezes_an_all_zero_row(dev, ops_book3):
    """A planted all-zero row freezes at its first halving on the device
    as on the host-counted gated halvings: its roots -8, the midpoint of
    its bracket, every other root the gated halvings' bits, and a second
    call with a larger cap the same bits."""
    ops = ops_book3
    L = 3
    obj = torch.tensor([0.05, 0.05, 0.05], dtype=torch.float64, device=dev)
    rows = torch.tensor([[0.4, 0.35, 0.25]] * L, dtype=torch.float64,
                        device=dev)
    *state, nan, _ = cs.solve_stages3(ops, obj, rows, CFG)
    planted = _planted([s.contiguous() for s in state], 1)
    widest = cs._widest(planted[0], planted[1])
    k = cs.halvings(float(widest), 1e-6)
    got = cs.bisect3(ops, *planted, obj, rows, 1e-6, widest=widest,
                     n_iters=cs.max_halvings(CFG, 1e-6))
    want = cs.bisect_fixed_count(ops, *planted, obj, rows, 1e-6, k,
                                 cq3.masked_contract3)
    assert _same(got, want)
    assert bool((got[1] == -8.0).all())
    assert torch.equal(got, cs.bisect3(ops, *planted, obj, rows, 1e-6,
                                       widest=widest, n_iters=23))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_fused_dim3_route_with_nan_days(dev, family):
    """A non-finite column on two days, on a grid not a multiple of 32:
    the MSM family's stage results there are NaN and the fused route
    flags those days; the GARCH family's nan_to_num turns the NaN cells
    into 0, so no day is flagged. Either way the fused route gives the
    composed route's bits."""
    def edit(cols, p):
        cols[1][:2, 1, 7] = False

    ops = _ops3(dev, family, "student", T=9, n=41, q=3, edit=edit)
    obj, weights = _rows_d3(dev, 5, False, seed=7)
    roots, nan = cs.full_solve(ops, obj, weights, CFG)
    want, want_nan = cs.full_solve(ops, obj, weights, CFG,
                                   reducer=DayMesh(None, 0, 1, dev))
    if family == "msm":
        assert bool(nan[:, :2].all()) and not bool(nan[:, 2:].any())
    else:
        assert not bool(nan.any())
    assert torch.equal(nan, want_nan) and _same(roots, want)


def test_fused_dim3_refuses_what_it_does_not_take(dev, ops_book3):
    """The wrappers refuse operands without U, a range of outer slabs and
    f32 operands; the launchers
    refuse a grid past the f64 table's (169) and more halvings than the
    count's cap; neither has an f32 form."""
    ops = ops_book3
    obj = torch.tensor([0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([[0.4, 0.35, 0.25]], dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="table U"):
        cs.solve_stages3(ops._replace(U=None), obj, w, CFG)
    with pytest.raises(ValueError, match="whole days"):
        cs.solve_stages3(ops._replace(rows=(0, 50)), obj, w, CFG)
    small = _ops3(dev, "msm", "student", T=2, dtype=F32)
    with pytest.raises(ValueError, match="f64 engine"):
        cs.solve_stages3(small, obj, w, CFG)
    widest = cs.solve_stages3(ops, obj, w, CFG)[6]
    lib = _build.load()
    invalid = 1  # cudaErrorInvalidValue

    def stages(n):
        return lib.cvt_solve_stages3(
            *[None] * 5, -3.0, -3.5, -2.0, -7.5, 0.0, 0, -5.0, *[None] * 7,
            0, n, 1, cq.row_pitch(n), cq3.slab_stride(n), None)

    def bisect(k_max):
        return lib.cvt_bisect3(*[None] * 10, -5.0, widest.data_ptr(), 1e-6,
                               k_max, *[None] * 4, 0, 48, 1, 49,
                               cq3.slab_stride(48), None)

    assert (stages(169), stages(170)) == (0, invalid)
    assert (bisect(2200), bisect(2201)) == (0, invalid)
    assert not hasattr(lib, "cvt_solve_stages3_f32")
    assert not hasattr(lib, "cvt_bisect3_f32")


def test_day_sharded_ranks_equal_one_card(dev, tmp_path):
    """Three gloo ranks sharing the card (NCCL refuses two ranks on one
    GPU) serve the CPU sharding tests' fixtures through the kernels on
    their day blocks (the 4-day case leaves the last rank none): every
    rank's series bit-equal to one card's."""
    import _torch_parallel_worker as wk
    from copula_var_tpu_torch.parallel import distributed

    want = wk.serve(None, "cuda")
    path = str(tmp_path / "rank%d.npz")
    distributed.run_world(wk.rank_main, 3, (path, str(tmp_path), False,
                                            "cuda"),
                          backend="gloo", device="cuda", timeout_s=120)
    for r in range(3):
        got = np.load(path % r)
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w,
                                          err_msg=f"rank {r} {key}")


# -- ranges of outer grid rows (grid sharding) ----------------------------------

SPLITS = [(0, 13), (13, 30), (30, 48)]  # uneven ranges of n = 48
RTOL_PARTS = 1e-13  # the ranges' partials summed vs the whole launch


def _summed(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_masked_sweep_on_row_ranges(dev, family):
    """K2 on ranges of outer rows: P the whole table's rows, bit for bit;
    each range's sweep against its plain twin; the partials summed
    against the whole launch; the range of all rows the whole launch's
    bits; a repeated launch the same bits."""
    whole = _ops(dev, family)
    bounds, weights = _rows(dev, whole.days, 33)
    full = cq.masked_sweep(whole, bounds, weights)
    parts = []
    for i0, i1 in SPLITS:
        ops = _ops(dev, family, rows=(i0, i1))
        assert torch.equal(ops.P, whole.P[:, i0:i1])
        assert torch.equal(ops.flags, whole.flags[:, i0:i1])
        got = cq.masked_sweep(ops, bounds, weights)
        _sweep_close(got, cq.masked_sweep_reference(ops, bounds, weights))
        assert torch.equal(got, cq.masked_sweep(ops, bounds, weights))
        parts.append(got)
    torch.testing.assert_close(_summed(parts), full, rtol=0,
                               atol=RTOL_PARTS * float(full.abs().max()))
    assert torch.equal(cq.masked_sweep(_ops(dev, family, rows=(0, 48)),
                                       bounds, weights), full)


def test_bisect_levels_refuses_a_row_range(dev):
    ops = _ops(dev, "garch", T=3, rows=(0, 24))
    obj, weights, state = _bracketed(_ops(dev, "garch", T=3), dev, 3)
    with pytest.raises(ValueError, match="whole days"):
        cs.bisect_levels(ops, *state, obj, weights, 1e-6)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_masked_contract3_on_row_ranges(dev, family):
    """K4 on ranges of outer slabs: U the whole table's slabs, bit for
    bit; each range against its plain twins; the partials summed against
    the whole launch; the range of all slabs the whole launch's bits."""
    n = 40
    whole = _ops3(dev, family, "student", n=n)
    bounds, weights = _rows3(dev, whole.days, 5)
    full = cq3.masked_contract3(whole, bounds, weights)
    parts = []
    for i0, i1 in ((0, 7), (7, 20), (20, n)):
        ops = _ops3(dev, family, "student", n=n, rows=(i0, i1))
        assert torch.equal(ops.U, whole.U[:, i0:i1])
        assert torch.equal(ops.flags, whole.flags[:, i0:i1])
        torch.testing.assert_close(
            cq3.table_cells(ops.U, n),
            cq3.contract3_table_reference(ops)[0],
            rtol=1e-12, atol=1e-300, equal_nan=True)
        got = cq3.masked_contract3(ops, bounds, weights)
        want = cq3.masked_contract3_reference(ops, bounds, weights)
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), rtol=0,
            atol=RTOL_SWEEP * float(want.abs().max()))
        assert torch.equal(got, cq3.masked_contract3(ops, bounds, weights))
        parts.append(got)
    torch.testing.assert_close(_summed(parts), full, rtol=0,
                               atol=RTOL_PARTS * float(full.abs().max()))
    assert torch.equal(cq3.masked_contract3(
        _ops3(dev, family, "student", n=n, rows=(0, n)), bounds, weights),
        full)


def test_grid_sharded_ranks_on_the_card(dev, tmp_path):
    """Four gloo ranks sharing the card (NCCL refuses two ranks on one
    GPU) serve the CPU grid tests' fixtures through K2 and K4 on their
    outer rows, on (1, 4) and (2, 2) meshes: every rank's series
    bit-equal to rank 0's and within 1e-12 of one card's."""
    import _torch_grid_worker as gw
    from copula_var_tpu_torch.parallel import distributed

    want = gw.serve(None, "cuda")
    path = str(tmp_path / "rank%d.npz")
    distributed.run_world(gw.rank_main, 4, (path, str(tmp_path), 4, "cuda"),
                          backend="gloo", device="cuda", timeout_s=300)
    ranks = [np.load(path % r) for r in range(4)]
    for shape in gw.MESHES[4]:
        for key, w in want.items():
            k = f"{gw.tag(shape)}/{key}"
            np.testing.assert_allclose(ranks[0][k], w, rtol=0, atol=1e-12,
                                       err_msg=k)
            for r in range(1, 4):
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                              err_msg=f"rank {r} {k}")


# -- wide grids: K2 past 192 rows, the rebuild kernel (K4 without U) ----------

def test_limits_mirror_the_launchers(dev):
    """The launchers take each limit the Python routes compute and refuse
    one past it (no day, so nothing runs): K1 at bisect_max_grid_points(),
    K2 at SWEEP_MAX_GRID_POINTS, the table sweep at table_max_grid_points,
    the rebuild wherever rebuild_tile_rows(n, q) takes (n, q) and not
    where it refuses the fold or n."""
    lib = _build.load()
    invalid = 1  # cudaErrorInvalidValue

    def k1(n):
        return lib.cvt_bisect_levels(*[None] * 11, -5.0, 1, None, 0, n, 5,
                                     1, None)

    def k2(n):
        return lib.cvt_masked_sweep(*[None] * 5, -5.0, None, 0, n, 0, n, 1,
                                    cq.row_pitch(n), None)

    def table(n):
        return lib.cvt_masked_contract3(*[None] * 5, -5.0, None, 0, n, 0, n,
                                        1, cq.row_pitch(n),
                                        cq3.slab_stride(n), None)

    def rebuild(n, q):
        return lib.cvt_masked_contract3_rebuild(
            *[None] * 8, 1, 5.0, 0.0, 0.0, None, None, None, None, -5.0,
            None, None, 0, n, 0, n, q, 1, None)

    n1 = cq.bisect_max_grid_points()
    assert n1 == 169 and (k1(n1), k1(n1 + 1)) == (0, invalid)
    n2 = cq.SWEEP_MAX_GRID_POINTS
    assert n2 == 1024 and (k2(n2), k2(n2 + 1)) == (0, invalid)
    for q in (1, 5, 16):
        n3 = cq3.table_max_grid_points(q)
        assert (table(n3), table(n3 + 1)) == (0, invalid)
        for n in (2, 40, 170, 300, 406, 420, 1024):
            assert cq3.rebuild_tile_rows(n, q) == 64
            assert rebuild(n, q) == 0, (n, q)
        assert cq3.rebuild_tile_rows(1025, q) == 0
        assert rebuild(1025, q) == invalid
    assert cq3.rebuild_tile_rows(1024, 22) == 64 and rebuild(1024, 22) == 0
    assert cq3.rebuild_tile_rows(1024, 23) == 0
    assert rebuild(1024, 23) == invalid


@pytest.mark.parametrize("n", [193, 1024])
def test_masked_sweep_on_wide_rows(dev, n):
    """K2 past the former 192-cell rows: P against its plain twin, the
    sweep against its plain twin, a repeat bit-equal."""
    ops = _ops(dev, "msm", T=3, n=n)
    want_p, flags = cq.sweep_table_reference(ops)
    assert torch.equal(ops.flags, flags)
    assert bool(torch.isclose(ops.P, want_p, rtol=RTOL_TABLE,
                              atol=1e-300).all())
    bounds, weights = _rows(dev, 3, 5)
    got = cq.masked_sweep(ops, bounds, weights)
    _sweep_close(got, cq.masked_sweep_reference(ops, bounds, weights))
    assert torch.equal(got, cq.masked_sweep(ops, bounds, weights))


def test_wide_dim2_bisects_by_k2_sweeps(dev):
    """n = 193: the solve bisects by K2 sweeps (no K1 launch), at the
    plain solve's roots."""
    ops = _ops(dev, "garch", T=4, n=193)
    obj = torch.tensor([0.05, 0.01], dtype=torch.float64, device=dev)
    w = torch.tensor([0.5, 0.5], dtype=torch.float64, device=dev)
    before = (cq.launch_count(cs.bisect_levels),
              cq.launch_count(cq.masked_sweep))
    got, _ = cs.full_solve(ops, obj, w, CFG)
    assert cq.launch_count(cs.bisect_levels) == before[0]
    assert cq.launch_count(cq.masked_sweep) > before[1] + 10
    want, _ = cs.full_solve_reference(ops, obj, w, CFG)
    assert float((got - want).abs().max()) <= ATOL_ROOT


def _rebuilt(ops):
    """The operands without their table or flags: the rebuild walking
    full rows (the "rebuild_full" route)."""
    return ops._replace(U=None, flags=None)


def _walk(ops, walk):
    """The operands on one of the rebuild's walks: "full" rows without
    flags, or "truncated" with the flag table (the table route's, built
    with U; built here for operands that carry none)."""
    if walk == "full":
        return _rebuilt(ops)
    flags = ops.flags if ops.flags is not None else \
        cq3.contract3_row_flags(ops)
    return ops._replace(U=None, flags=flags)


def _same(a, b):
    """Equal bits, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("walk", ["truncated", "full"])
@pytest.mark.parametrize("n, rows", [(2, None), (170, None), (170, (37, 101)),
                                     (180, None), (300, None),
                                     (300, (0, 150))])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_rebuild_matches_plain(dev, n, rows, family, walk):
    """The rebuild kernel against its plain twin, on all outer slabs and
    on a range of them, on either walk; a repeat gives the same bits, and
    the two walks give the same bits."""
    ops = _ops3(dev, family, "student", T=2, n=n, q=3, rows=rows)
    if n > cq3.table_max_grid_points(3):
        assert ops.U is None and ops.flags is not None
    ops = _walk(ops, walk)
    bounds, weights = _rows3(dev, ops.days, 3)
    before = cq.launch_count(cq3.masked_contract3_rebuild)
    got = cq3.masked_contract3_rebuild(ops, bounds, weights)
    assert cq.launch_count(cq3.masked_contract3_rebuild) == before + 1
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        1e-13 * float(want[fin].abs().max())
    assert torch.equal(got, cq3.masked_contract3_rebuild(ops, bounds,
                                                        weights))
    other = _walk(ops, "full" if walk == "truncated" else "truncated")
    assert torch.equal(got, cq3.masked_contract3_rebuild(other, bounds,
                                                        weights))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("L", [1, 32])
def test_table_sweep_equals_the_rebuild_on_the_same_operands(dev, L, dtype):
    """The table sweep (two stored prefixes per row lookup) and the rebuild
    (each row's prefix formed from the columns) on the same table-route
    operands, at the book's n = 100, q = 5: the same bits, with the build's
    flags (the truncated walk) and without them (full rows)."""
    ops = _ops3(dev, "msm", "student", T=5, n=100, q=5, dtype=dtype)
    assert ops.U is not None and ops.flags is not None
    bounds, weights = _rows3(dev, ops.days, L, seed=L)
    bounds, weights = bounds.to(dtype), weights.to(dtype)
    table = cq3.masked_contract3(ops, bounds, weights)
    assert table.dtype == dtype and bool((table != 0).any())
    for flags in (ops.flags, None):
        assert torch.equal(table, cq3.masked_contract3_rebuild(
            ops._replace(flags=flags), bounds, weights))


@pytest.mark.parametrize("walk", ["truncated", "full"])
@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_rebuild_equals_the_table_sweep(dev, family, kind, walk):
    """Where both routes serve (64-row tiles), the rebuild gives the table
    sweep's bits: the same cells, prefix sums, lanes and partials."""
    ops = _ops3(dev, family, kind, n=41)
    bounds, weights = _rows3(dev, ops.days, 33)
    assert torch.equal(
        cq3.masked_contract3_rebuild(_walk(ops, walk), bounds, weights),
        cq3.masked_contract3(ops, bounds, weights))


def _band_rows(dev, T, kind, L, dtype=torch.float64, seed=2):
    """L bound rows of one kind: "sparse" bands far narrower than a grid
    step in the lower tail, as late halvings have them (most 32-row warps
    of a tile that hold a row with an interval hold one), or "spread"
    stage bounds with most of the weight on x1, so each row's reach moves
    by several columns from the row before (reaches spread past 32 within
    a warp)."""
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        lo = rng.uniform(-2.5, -1.0, (L, T))
        b = np.stack([lo, lo + rng.uniform(5e-5, 3e-4, (L, T))], -1)
        w = rng.dirichlet([2.0, 2.0, 2.0], size=L)
    else:
        b = np.stack([np.full((L, T), -100.0),
                      rng.uniform(-3.0, -1.0, (L, T))], -1)
        w = np.tile([0.15, 0.15, 0.7], (L, 1))
    return (torch.tensor(b, device=dev, dtype=dtype),
            torch.tensor(w, device=dev, dtype=dtype))


def _warp_reaches(ops, bounds, weights, box_min=-5.0):
    """(T, r, warps, 32) reach of each (t, i0, i1) row (the longest hi of
    its intervals that hold a grid point, 0 where none does), its i1 rows
    in warps of 32 (the last padded with 0), on the host."""
    x = ops.x.double().cpu()
    lo_, hi_ = ops.rows if ops.rows is not None else (0, x.shape[0])
    n = x.shape[0]
    reach = torch.zeros((bounds.shape[1], hi_ - lo_, n), dtype=torch.long)
    for b, w in zip(bounds.double().cpu(), weights.double().cpu()):
        prev = x[lo_:hi_, None] * w[1] + x[None, :] * w[2]
        dup = (b[:, 1, None, None] - prev) / w[0]
        dlo = torch.maximum((b[:, 0, None, None] - prev) / w[0],
                            torch.tensor(box_min, dtype=torch.float64))
        hi = torch.searchsorted(x, dup.contiguous(), right=True)
        lo = torch.searchsorted(x, dlo.contiguous(), right=True)
        used = (hi > lo) & ~torch.isnan(dup) & ~torch.isnan(dlo)
        reach = torch.maximum(reach, torch.where(used, hi, 0))
    return torch.nn.functional.pad(reach, (0, -n % 32)).unflatten(-1, (-1, 32))


@pytest.mark.parametrize("walk", ["truncated", "full"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind, L", [("sparse", 1), ("sparse", 3),
                                     ("spread", 1), ("spread", 4)])
def test_rebuild_on_sparse_and_spread_bands(dev, kind, L, dtype, walk):
    """At n = 169 (the table route's widest in f64) the rebuild gives the
    table sweep's bits on bands where most warps hold one walking row and
    on reaches spread past 32 within a warp, on either walk and in either
    type; a repeat and the other walk give the same bits."""
    ops = _ops3(dev, "msm", "student", T=4, n=169, dtype=dtype)
    assert ops.U is not None
    bounds, weights = _band_rows(dev, ops.days, kind, L, dtype)
    reach = _warp_reaches(ops, bounds, weights)
    walking = (reach > 0).sum(dim=-1)
    if kind == "sparse":
        assert int((walking > 0).sum()) > 100
        assert float((walking == 1).sum() / (walking > 0).sum()) > 0.5
    else:
        spread = reach.amax(dim=-1) - reach.amin(dim=-1)
        assert int((spread > 32).sum()) > 100
    table = cq3.masked_contract3(ops, bounds, weights)
    assert table.dtype == dtype and bool((table != 0).any())
    got = cq3.masked_contract3_rebuild(_walk(ops, walk), bounds, weights)
    assert _same(got, table)
    assert _same(got, cq3.masked_contract3_rebuild(_walk(ops, walk), bounds,
                                                   weights))
    other = "full" if walk == "truncated" else "truncated"
    assert _same(got, cq3.masked_contract3_rebuild(_walk(ops, other), bounds,
                                                   weights))


@pytest.mark.parametrize("kind", ["sparse", "spread"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_rebuild_bands_at_n300(dev, family, kind):
    """At n = 300 (no table: the rebuild route) on sparse and spread bands,
    L = 3: the truncated walk against its plain twin, bit-equal to its
    full-row walk and to a repeat."""
    ops = _ops3(dev, family, "student", T=2, n=300, q=3)
    assert ops.U is None and ops.flags is not None
    bounds, weights = _band_rows(dev, ops.days, kind, 3)
    got = cq3.masked_contract3_rebuild(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and bool((want != 0).any())
    assert float((got[fin] - want[fin]).abs().max()) <= \
        1e-13 * float(want[fin].abs().max())
    assert torch.equal(got, cq3.masked_contract3_rebuild(ops, bounds,
                                                        weights))
    assert torch.equal(got, cq3.masked_contract3_rebuild(_rebuilt(ops),
                                                        bounds, weights))


def test_rebuild_limits_with_the_walk_schedule(dev):
    """The walk's schedule in shared memory leaves the widest (n, q) the
    rebuild takes where it was: (1024, 22) in float64 and (1024, 45) in
    float32 taken, (1024, 23) and (1024, 46) refused, by the launchers
    and by rebuild_tile_rows alike (no day, so nothing runs)."""
    invalid = 1  # cudaErrorInvalidValue

    def rebuild(n, q, dtype):
        fn = _build.function("cvt_masked_contract3_rebuild", dtype)
        return fn(*[None] * 8, 1, 5.0, 0.0, 0.0, None, None, None, None,
                  -5.0, None, None, 0, n, 0, n, q, 1, None)

    for dtype, q in ((torch.float64, 22), (torch.float32, 45)):
        assert cq3.rebuild_tile_rows(1024, q, dtype) == 64
        assert rebuild(1024, q, dtype) == 0
        assert cq3.rebuild_tile_rows(1024, q + 1, dtype) == 0
        assert rebuild(1024, q + 1, dtype) == invalid


def _poke(cols, p):
    """A non-finite column (NaN cells) and an overflowing one (inf cells;
    GARCH: DBL_MAX) of asset 2 near the top of the grid, past the bounds'
    hi, and a non-finite asset-1 point (a whole row of NaN cells)."""
    cols[1][0, 2, -2] = False
    cols[2][1, 2, -3] = -1000.0
    cols[1][2, 1, 5] = False


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("n, rows", [(48, None), (180, None),
                                     (180, (37, 101))])
def test_row_flags_match_plain(dev, family, n, rows):
    """The flag kernel against its plain twin (torch.equal), on all outer
    slabs and on a range; one launch per operands built on the rebuild
    route; on the table route the build's flags, counted by the build,
    and the flag kernel's equal to them; a repeat the same bytes."""
    before = cq.launch_count(cq3.contract3_row_flags)
    rows_before = profiling.counters().get("prep.flagged_rows", 0)
    ops = _ops3(dev, family, "student", T=4, n=n, rows=rows, edit=_poke)
    if ops.U is not None:  # the table route: flags built with U
        assert cq.launch_count(cq3.contract3_row_flags) == before
        assert (profiling.counters()["prep.flagged_rows"] - rows_before
                == int(ops.flags.sum()) > 0)
        flags = cq3.contract3_row_flags(ops)
        assert torch.equal(flags, ops.flags)
    else:
        flags = ops.flags
    assert cq.launch_count(cq3.contract3_row_flags) == before + 1
    assert flags.shape == (4, ops.n_rows, n) and flags.dtype == torch.bool
    want = cq3.contract3_row_flags_reference(ops)
    assert torch.equal(flags, want) and bool(want.any())
    assert torch.equal(cq3.contract3_row_flags(ops), flags)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_rebuild_on_a_day_block(dev, family):
    """Operands built on a block of days (a day-sharded rank's) hold the
    whole operands' flags of those days, and their sweep, on both walks,
    is the whole sweep's days bit for bit."""
    whole = _ops3(dev, family, "student", T=6, n=180, edit=_poke)
    days = slice(2, 5)
    kw = (dict(densities=whole.densities,
               forecast_combos=whole.forecast_combos[days].contiguous())
          if family == "msm" else
          dict(p_cols=whole.p_cols[days].contiguous()))
    block = cq3.contract3_operands(
        tuple(c[days].contiguous() for c in whole.cols), whole.x, whole.dx,
        whole.spec, **kw)
    assert torch.equal(block.flags, whole.flags[days])
    bounds, weights = _rows3(dev, 6, 4)
    full = cq3.masked_contract3_rebuild(whole, bounds, weights)
    b = bounds[:, days].contiguous()
    for walk in ("truncated", "full"):
        got = cq3.masked_contract3_rebuild(_walk(block, walk), b, weights)
        assert _same(got, full[:, days])


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_rebuild_routes_on_the_dim3_artifacts(dev, est):
    """The dim-3 artifacts at n = 100 (the table route, its flags built
    with U and equal to the flag kernel's): the table sweep, the truncated
    walk with the flag table and the full-row walk give the same bits, at
    the stage bounds and at bands near the record's VaR, L = 1 and 4;
    repeats too."""
    rec = np.load(os.path.join(DATA, "dim3_var.npz"))
    data = from_csv(os.path.join(DATA, "dim3.csv"), n_insample=1135,
                    weights=rec["weights"])
    bt = load_artifacts(os.path.join(DATA, f"dim3_artifacts_{est}.npz"),
                        data, device="cuda")
    ops = bt.sweep_operands()
    assert ops.U is not None and ops.flags is not None
    assert torch.equal(ops.flags, cq3.contract3_row_flags(ops))
    T = ops.days
    rng = np.random.default_rng(12)
    lo = rng.uniform(-1.9, -1.1, (3, T))
    band = np.stack([lo, lo + rng.uniform(0.01, 0.3, (3, T))], -1)
    stage = np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1)
    bounds = torch.tensor(np.concatenate([stage[None], band]), device=dev)
    w = np.concatenate([np.asarray(rec["weights"])[None],
                        rng.dirichlet([2.0, 2.0, 2.0], size=3)])
    weights = torch.tensor(w, device=dev)
    for rows in (slice(0, 1), slice(0, 4)):
        b, wt = bounds[rows].contiguous(), weights[rows].contiguous()
        table = cq3.masked_contract3(ops, b, wt)
        for walk in ("truncated", "full"):
            got = cq3.masked_contract3_rebuild(_walk(ops, walk), b, wt)
            assert torch.equal(got, table), (walk, rows)
            assert torch.equal(got, cq3.masked_contract3_rebuild(
                _walk(ops, walk), b, wt))


@pytest.mark.parametrize("walk", ["truncated", "full"])
def test_rebuild_nan_and_inf_cells(dev, walk):
    """A non-finite column (NaN cells) and an overflowing one (inf cells):
    each poisons exactly the slabs that hold it, as in the plain twin."""
    def edit(cols, p):
        cols[1][:, 1, 7] = False
        cols[2][:, 2, 30] = -1000.0

    ops = _walk(_ops3(dev, "msm", "student", n=180, edit=edit), walk)
    bounds, weights = _rows3(dev, ops.days, 8)
    got = cq3.masked_contract3_rebuild(ops, bounds, weights)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    assert bool(torch.isfinite(want).any())
    assert not bool(torch.isfinite(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        1e-13 * float(want[fin].abs().max())


def test_wide_dim3_solve_through_the_rebuild(dev):
    """n = 180: no table is built, the flags once, every sweep and halving
    launches the rebuild kernel, and the roots are the plain solve's."""
    before_flags = cq.launch_count(cq3.contract3_row_flags)
    ops = _ops3(dev, "garch", "student", T=3, n=180)
    assert ops.U is None and ops.flags is not None
    assert cq.launch_count(cq3.contract3_row_flags) == before_flags + 1
    obj = torch.tensor([0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([0.5, 0.3, 0.2], dtype=torch.float64, device=dev)
    before = (cq.launch_count(cq3.masked_contract3),
              cq.launch_count(cq3.masked_contract3_rebuild))
    got, _ = cs.full_solve(ops, obj, w, CFG)
    assert cq.launch_count(cq3.masked_contract3) == before[0]
    assert cq.launch_count(cq3.masked_contract3_rebuild) > before[1] + 10
    want, _ = cs.full_solve_reference(ops, obj, w, CFG)
    assert float((got - want).abs().max()) <= ATOL_ROOT


def test_rebuild_rejects_past_the_interval_rule(dev):
    with pytest.raises(ValueError, match="1024"):
        _ops3(dev, "garch", "gaussian", T=1, n=1025)


# -- the f32 engine's kernels (float32 instantiations) ------------------------

F32 = torch.float32
# the f32 kernels form the same float32 cells as their twins (up to
# CUDA's expf / log1pf against torch's) and sum them in float64, rounded
# once; the twins sum them in float32 (torch's products, n or n^2 terms):
# they agree to a few float32 ulps of the scale
RTOL_F32 = 1e-5


@pytest.fixture(autouse=True)
def _full_f32_products():
    """The f32 engine's float32 products run in full float32, never TF32
    (the f32 operands refuse to be built with TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32


def _f32_counts():
    return {w.__name__: (cq.launch_count(w),
                         cq.launch_count(w, torch.float32)) for w in (
        cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
        cq3.contract3_weights, cq3.masked_contract3,
        cq3.masked_contract3_rebuild, cq3.contract3_row_flags)}


def _launched(before, after):
    """{wrapper: (f64 launches, f32 launches)} between two counts."""
    return {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
            for k in after if after[k] != before[k]}


def _close32(got, want):
    assert got.dtype == want.dtype == F32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    scale = float(want[fin].abs().max())
    assert float((got[fin] - want[fin]).abs().max()) <= RTOL_F32 * scale


def _f32_rows(dev, T, L, dim, seed=1):
    b, w = (_rows if dim == 2 else _rows3)(dev, T, L, seed)
    return b.to(F32), w.to(F32)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_f32_table_and_sweep_match_plain(dev, family):
    before = _f32_counts()
    ops = _ops(dev, family, dtype=F32)
    assert ops.P.dtype == F32 and ops.wfc.dtype == F32
    want_p, flags = cq.sweep_table_reference(ops)
    assert torch.equal(ops.flags, flags)
    _close32(ops.P, want_p)
    bounds, weights = _f32_rows(dev, ops.days, 6, 2)
    got = cq.masked_sweep(ops, bounds, weights)
    _close32(got, cq.masked_sweep_reference(ops, bounds, weights))
    assert torch.equal(got, cq.masked_sweep(ops, bounds, weights))
    assert _launched(before, _f32_counts()) == {
        "sweep_table": (0, 1), "masked_sweep": (0, 2)}


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_f32_k1_fixed_count_matches_k2_halvings_and_plain(dev, family):
    """K1 in float32 runs the given count: bit-equal to the same count of
    f32 K2 sweeps (the same prefix rows and lane sums), within the plateau
    bound of the plain twin (a slab's rounding may flip a tie)."""
    ops = _ops(dev, family, dtype=F32)
    T, L = ops.days, 4
    _, weights = _f32_rows(dev, T, L, 2)
    obj = torch.tensor([0.01, 0.05, 0.1, 0.2], dtype=F32, device=dev)
    stage1 = torch.tensor([-100.0, CFG[0]], dtype=F32,
                          device=dev).expand(L, T, 2).contiguous()
    F1 = cq.masked_sweep(ops, stage1, weights)
    state = [t.contiguous() for t in bracket_state_batched(
        F1, obj, lambda b: cq.masked_sweep(ops, b.contiguous(), weights),
        CFG, False)[:5]]
    before = _f32_counts()
    _, bisect = cs._routes(ops, False)
    got = bisect(ops, *state, obj, weights, 1e-6, n_iters=23)
    assert _launched(before, _f32_counts()) == {"bisect_levels": (0, 1)}
    by_k2 = cs.fixed_halvings(ops, *state, obj, weights, 23, cq.masked_sweep)
    assert torch.equal(got, by_k2)
    plain = cs.fixed_halvings(ops, *state, obj, weights, 23,
                              cq.masked_sweep_reference)
    bound = float(ops.dx.max()) * float(weights[:, 0].abs().max())
    assert float((got - plain).abs().max()) <= bound


@pytest.mark.parametrize("n", [48, 192, 193])
def test_f32_fused_solve_on_the_card(dev, n):
    """`full_solve` of f32 operands at dim 2: two f32 stage sweeps, then
    one K1 f32 launch up to n = 192, or 23 f32 K2 sweeps past it; no f64
    launch; within the plateau bound of its plain twin."""
    ops = _ops(dev, "msm", T=9, n=n, dtype=F32)
    obj = torch.tensor([0.01, 0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([0.6, 0.4], dtype=torch.float64, device=dev)
    before = _f32_counts()
    got, nan = cs.full_solve(ops, obj, w, CFG)
    launched = _launched(before, _f32_counts())
    if n <= 192:
        assert launched == {"masked_sweep": (0, 2), "bisect_levels": (0, 1)}
    else:
        assert launched == {"masked_sweep": (0, 2 + 23)}
    want, want_nan = cs.full_solve_reference(ops, obj, w, CFG)
    assert torch.equal(nan, want_nan) and got.dtype == F32
    assert float((got - want).abs().max()) <= float(ops.dx.max()) * 0.6


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_f32_contract3_table_and_sweep_match_plain(dev, family, kind):
    before = _f32_counts()
    ops = _ops3(dev, family, kind, dtype=F32)
    assert ops.U.dtype == F32 and ops.sigma_inv.dtype == torch.float64
    n = ops.x.shape[0]
    assert ops.U.shape[-1] == cq3.slab_stride(n, F32)
    assert ops.U.shape[-1] % 4 == 0  # 16-byte slabs
    want, flags = cq3.contract3_table_reference(ops)
    _close32(cq3.table_cells(ops.U, n), want)
    assert torch.equal(ops.flags, flags)
    assert not bool(cq3.table_pads(ops.U, n).any())
    bounds, weights = _f32_rows(dev, ops.days, 5, 3)
    got = cq3.masked_contract3(ops, bounds, weights)
    _close32(got, cq3.masked_contract3_reference(ops, bounds, weights))
    assert torch.equal(got, cq3.masked_contract3(ops, bounds, weights))
    assert _launched(before, _f32_counts()) == {
        "contract3_weights": (0, 1), "masked_contract3": (0, 2)}


@pytest.mark.parametrize("walk", ["truncated", "full"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_f32_rebuild_equals_the_f32_table_sweep(dev, family, walk):
    """The f32 rebuild rounds each captured prefix to float32 as the table
    stores it, so both routes give the same bits in float32 too; the f32
    flags equal their plain twin."""
    ops = _ops3(dev, family, "student", n=48, dtype=F32)
    bounds, weights = _f32_rows(dev, ops.days, 5, 3)
    table = cq3.masked_contract3(ops, bounds, weights)
    flags = cq3.contract3_row_flags(ops)
    assert flags.dtype == torch.bool
    assert torch.equal(flags, cq3.contract3_row_flags_reference(ops))
    rebuilt = cq3.masked_contract3_rebuild(_walk(ops, walk), bounds, weights)
    assert _same(rebuilt, table)


def test_f32_dim3_solve_on_the_card(dev):
    """`full_solve` of f32 operands at dim 3 (f32 K4 sweeps, float64
    state) on the table and on the rebuild: the same roots, no f64
    launch, within the plateau bound of the plain twin."""
    ops = _ops3(dev, "msm", "student", dtype=F32)
    obj = torch.tensor([0.01, 0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([0.5, 0.3, 0.2], dtype=torch.float64, device=dev)
    before = _f32_counts()
    got, nan = cs.full_solve(ops, obj, w, CFG)
    launched = _launched(before, _f32_counts())
    assert set(launched) == {"masked_contract3"}
    assert launched["masked_contract3"][0] == 0
    assert got.dtype == torch.float64
    rebuilt, _ = cs.full_solve(_walk(ops, "truncated"), obj, w, CFG)
    assert _same(rebuilt, got)
    want, want_nan = cs.full_solve_reference(ops, obj, w, CFG)
    assert torch.equal(nan, want_nan)
    assert float((got - want).abs().max()) <= float(ops.dx.max()) * 0.5


def test_f32_limits_mirror_the_launchers(dev):
    """The f32 launchers take the f32 limits and refuse one past them:
    K1 at bisect_max_grid_points(float32) (192), the f32 table sweep at
    table_max_grid_points(q, float32), and a slab stride that is not
    16-byte rounded for float32."""
    lib = _build.load()
    invalid = 1  # cudaErrorInvalidValue

    def k1(n):
        return lib.cvt_bisect_levels_f32(*[None] * 11, -5.0, 1, None, 0, n,
                                         5, 1, None)

    def table(n, stride=None):
        return lib.cvt_masked_contract3_f32(
            *[None] * 5, -5.0, None, 0, n, 0, n, 1, cq.row_pitch(n),
            cq3.slab_stride(n, F32) if stride is None else stride, None)

    n1 = cq.bisect_max_grid_points(F32)
    assert n1 == 192 and (k1(n1), k1(n1 + 1)) == (0, invalid)
    for q in (1, 5):
        n3 = cq3.table_max_grid_points(q, F32)
        assert n3 == 192 and (table(n3), table(n3 + 1)) == (0, invalid)
    # n = 45: n * pitch = 2025 cells, 2026 for float64, 2028 for float32
    assert (cq3.slab_stride(45), cq3.slab_stride(45, F32)) == (2026, 2028)
    assert table(45) == 0 and table(45, 2026) == invalid


def test_wrappers_refuse_the_other_engine_s_operands(dev):
    """The f64 engine's own wrappers (K1 with its host or device count,
    the fused stages) refuse f32 operands, which `full_solve` serves on
    the f32 engine's route; a sweep of f32 operands refuses float64
    bounds."""
    ops32 = _ops(dev, "garch", T=5, dtype=F32)
    obj = torch.tensor([0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([[0.5, 0.5]], dtype=torch.float64, device=dev)
    b = torch.zeros((1, 5), dtype=F32, device=dev)
    with pytest.raises(ValueError, match="f64 engine"):
        cs.bisect_levels(ops32, b, b, b, b, b > 0, obj, w, 1e-6)
    with pytest.raises(ValueError, match="f64 engine"):
        cs.solve_stages(ops32, obj, w, CFG)
    bounds, weights = _rows(dev, 5, 1)
    with pytest.raises(ValueError, match="bounds"):
        cq.masked_sweep(ops32, bounds, weights)


# -- day blocks (the f32 engine day-sharded) ---------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_day_block_operands_hold_the_whole_tables_days(dev, family, dtype):
    """Operands built on a block of days (`days=`, a day-sharded rank's)
    hold the whole operands' wfc and P at dim 2, G and U at dim 3, of
    those days bit for bit (every product formed over all days, then
    cut), and their sweeps give the whole sweeps' days."""
    days = slice(3, 7)
    whole, block = (_ops(dev, family, T=9, dtype=dtype, days=d)
                    for d in (None, days))
    for name in ("V", "wfc", "P", "flags"):
        assert torch.equal(getattr(block, name), getattr(whole, name)[days])
    bounds, weights = _rows(dev, 9, 3)
    bounds, weights = bounds.to(dtype), weights.to(dtype)
    got = cq.masked_sweep(block, bounds[:, days].contiguous(), weights)
    assert _same(got, cq.masked_sweep(whole, bounds, weights)[:, days])
    days3 = slice(2, 5)
    whole3, block3 = (_ops3(dev, family, "student", dtype=dtype, days=d)
                      for d in (None, days3))
    for name in ("z", "fin", "lu", "G", "U", "flags"):
        assert torch.equal(getattr(block3, name),
                           getattr(whole3, name)[days3])
    bounds, weights = _rows3(dev, 6, 3)
    bounds, weights = bounds.to(dtype), weights.to(dtype)
    got = cq3.masked_contract3(block3, bounds[:, days3].contiguous(),
                               weights)
    assert _same(got, cq3.masked_contract3(whole3, bounds, weights)[:, days3])


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["f64", "f32"])
def test_an_empty_day_block_launches_nothing(dev, dtype):
    """A rank whose block holds no day (T = 4 over 3 ranks: days [4, 4)):
    the operands of 0 days (P and U of 0 days, the flags), every sweep,
    the stage sweeps, the bracket, K1 and the dim-3 bisection return
    empty results and launch no kernel (no grid of size 0)."""
    empty = slice(4, 4)
    reducer = DayMesh(None, 0, 1, dev)  # a world of one: no collective
    before = _f32_counts()
    ops = _ops(dev, "msm", T=4, dtype=dtype, days=empty)
    ops3 = _ops3(dev, "garch", "student", T=4, dtype=dtype, days=empty)
    assert ops.P.shape[0] == ops.days == 0 and ops3.U.shape[0] == 0
    assert cq3.contract3_row_flags(ops3).shape == (0, 40, 40)
    b2, w2 = _rows(dev, 0, 3)
    b3, w3 = _rows3(dev, 0, 3)
    assert cq.masked_sweep(ops, b2.to(dtype), w2.to(dtype)).shape == (3, 0)
    for sweep in (cq3.masked_contract3, cq3.masked_contract3_rebuild):
        assert sweep(ops3, b3.to(dtype), w3.to(dtype)).shape == (3, 0)
    obj = torch.tensor([0.01, 0.05], dtype=torch.float64, device=dev)
    for o, w in ((ops, w2[0]), (ops3, w3[0])):
        roots, nan = cs.full_solve(o, obj, w, CFG, reducer=reducer)
        assert roots.shape == nan.shape == (2, 0)
    assert _f32_counts() == before
