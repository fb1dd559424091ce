"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one. The
redesigned kernels (K1 `bisect_levels`, K2 `sweep_table` +
`masked_sweep`, K4 `contract3_weights` + `masked_contract3`, and the
rebuild sweep `masked_contract3_rebuild`) are held at odd n, at their
largest n and one past it, q = 1 and 5, L = 1, 3 and 33 (more rows than
warps), with NaN, inf and saturated cells, and launched twice for
bit-identical results; K2 on rows of 193 and 1024 cells, the rebuild at
n = 2, 170 and 300 and equal to the table sweep where both serve, and
the wide dim-2 and dim-3 solves through K2 sweeps and the rebuild. K2 and K4 are also held on ranges of
outer grid rows (grid sharding): each range against its plain twin, the
ranges' partials summed against the whole launch, and the range of all
rows bit-equal to the whole launch. This file
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
         rows=None):
    """Random day operands on the card; n not a multiple of 32; `edit(V)`
    may poke cells of the day tensors first. With `table` False they are
    built on the CPU and moved, so they carry no prefix table; with
    `rows` (i0, i1) they hold those outer grid rows."""
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
        return cq.sweep_operands(t(V), t(x), t(dx), rows=rows)
    dens = rng.uniform(0.0, 0.5, (2, q, n))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    return cq.sweep_operands(t(V), t(x), t(dx), t(dens), t(fc), rows=rows)


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
    before = cq.masked_sweep.launches
    got = cq.masked_sweep(ops, bounds, weights)
    assert cq.masked_sweep.launches == before + 1
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
    before = cs.bisect_levels.launches
    got = cs.bisect_levels(ops, *state, obj, weights, 1e-6)
    assert cs.bisect_levels.launches == before + 1
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
    before = (cq.masked_sweep.launches, cs.bisect_levels.launches)
    var = bt.calc_var(float(rec["obj_var"]))
    assert cq.masked_sweep.launches > before[0]
    assert cs.bisect_levels.launches > before[1]
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


# -- the dim-2 sweep (K2/K3): prefix table and interval rule -------------------

RTOL_TABLE = 1e-12  # sequential prefix sums vs torch.cumsum's parallel scan


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_sweep_table_matches_plain(dev, family):
    """P and the flags, built once with the operands, against the plain
    twin (odd n: rows unpadded; even n: one zero pad cell per row); a
    rebuild gives the same bits."""
    for n in (37, 48):
        before = cq.sweep_table.launches
        ops = _ops(dev, family, T=9, n=n)
        assert cq.sweep_table.launches == before + 1
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
    before = cq.masked_sweep.launches
    got = bt.compute_integral(b)
    assert cq.masked_sweep.launches == before + 1
    want = cq.masked_sweep_reference(
        ops, torch.tensor(b, device=dev)[None], bt.weights[None])[0]
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=0,
                               atol=RTOL_SWEEP * float(want.abs().max()))


# -- the dim-3 kernel (K4) ----------------------------------------------------

CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35], [0.25, 0.35, 1.0]])


def _ops3(dev, family, kind, T=6, n=40, q=3, seed=0, edit=None, rows=None):
    """Random dim-3 operands on the card; `edit(cols, p)` may poke cells
    of the transform or pdf columns before the operands are built; with
    `rows` (i0, i1) those of outer slabs [i0, i1)."""
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
                                      rows=rows)
    dens = t(rng.uniform(0.0, 0.5, (3, q, n)))
    fc = t(rng.dirichlet(np.ones(q**3), size=T))
    return cq3.contract3_operands(tuple(cols), x, dx, spec, densities=dens,
                                  forecast_combos=fc, rows=rows)


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
    before = cq3.masked_contract3.launches
    got = cq3.masked_contract3(ops, bounds, weights)
    assert cq3.masked_contract3.launches == before + 1
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
    """The table U, built once with the operands, against its plain
    twin, its pads zero (odd n: one pad cell per slab; even n: one per
    row)."""
    before = cq3.contract3_weights.launches
    for n in (41, 40):
        ops = _ops3(dev, family, kind, n=n)
        assert cq3.contract3_weights.launches == before + 1
        before += 1
        assert ops.U.shape == (ops.days, n, cq3.slab_stride(n))
        got = cq3.table_cells(ops.U, n)
        want = cq3.contract3_weights_reference(ops)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isclose(got, want, rtol=RTOL_SWEEP, atol=1e-300,
                                  equal_nan=True).all())
        assert bool((cq3.table_pads(ops.U, n) == 0).all())
        assert torch.equal(ops.U, cq3.contract3_weights(ops))
        before += 1


@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("L", [1, 3, 33])
def test_masked_contract3_rows_and_widths(dev, q, L):
    """Odd n (one sweep buffer past n = 120 is exercised at the limit
    below), q = 1 and 5, more rows than warps; repeats are bit-equal."""
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
    before = (cq.masked_sweep.launches, cs.bisect_levels.launches,
              cq3.contract3_weights.launches, cq3.masked_contract3.launches)
    var = bt.calc_var(float(rec["obj_var"]))
    after = (cq.masked_sweep.launches, cs.bisect_levels.launches,
             cq3.contract3_weights.launches, cq3.masked_contract3.launches)
    assert after[:2] == before[:2]
    assert after[2] == before[2] + 1 and after[3] > before[3]
    np.testing.assert_allclose(var, rec[f"{est}_var"], rtol=0,
                               atol=ATOL_ROOT)


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
        torch.testing.assert_close(
            cq3.table_cells(ops.U, n), cq3.contract3_weights_reference(ops),
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
    the rebuild at rebuild_tile_rows(n, q) but not at twice its rows."""
    lib = _build.load()
    invalid = 1  # cudaErrorInvalidValue

    def k1(n):
        return lib.cvt_bisect_levels(*[None] * 11, -5.0, 1, None, 0, n, 5,
                                     1, None)

    def k2(n):
        return lib.cvt_masked_sweep(*[None] * 5, -5.0, None, 0, n, 0, n, 1,
                                    cq.row_pitch(n), None)

    def table(n):
        return lib.cvt_masked_contract3(*[None] * 4, -5.0, None, None, 0, n,
                                        0, n, 1, cq.row_pitch(n),
                                        cq3.slab_stride(n), None)

    def rebuild(n, q, tile):
        return lib.cvt_masked_contract3_rebuild(
            *[None] * 8, 1, 5.0, 0.0, 0.0, None, None, None, -5.0, None,
            None, 0, n, 0, n, q, 1, tile, None)

    n1 = cq.bisect_max_grid_points()
    assert n1 == 169 and (k1(n1), k1(n1 + 1)) == (0, invalid)
    n2 = cq.SWEEP_MAX_GRID_POINTS
    assert n2 == 1024 and (k2(n2), k2(n2 + 1)) == (0, invalid)
    for q in (1, 5, 16):
        n3 = cq3.table_max_grid_points(q)
        assert (table(n3), table(n3 + 1)) == (0, invalid)
        for n in (2, 40, 170, 300, 406, 420, 1024):
            tile = cq3.rebuild_tile_rows(n, q)
            assert tile > 0 and rebuild(n, q, tile) == 0, (n, q)
            assert rebuild(n, q, 2 * tile) == invalid, (n, q)
        assert cq3.rebuild_tile_rows(1025, q) == 0
        assert rebuild(1025, q, 16) == invalid


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
    before = (cs.bisect_levels.launches, cq.masked_sweep.launches)
    got, _ = cs.full_solve_levels(ops, obj, w, CFG)
    assert cs.bisect_levels.launches == before[0]
    assert cq.masked_sweep.launches > before[1] + 10
    want, _ = cs.full_solve_levels_reference(ops, obj, w, CFG)
    assert float((got - want).abs().max()) <= ATOL_ROOT


def _rebuilt(ops):
    """The operands without their table (the rebuild route)."""
    return ops._replace(U=None)


@pytest.mark.parametrize("n, rows", [(2, None), (170, None), (170, (37, 101)),
                                     (300, None), (300, (0, 150))])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_rebuild_matches_plain(dev, n, rows, family):
    """The rebuild kernel against its plain twin, on all outer slabs and
    on a range of them; a repeat gives the same bits."""
    ops = _ops3(dev, family, "student", T=2, n=n, q=3, rows=rows)
    if n > cq3.table_max_grid_points(3):
        assert ops.U is None
    ops = _rebuilt(ops)
    bounds, weights = _rows3(dev, ops.days, 3)
    before = cq3.masked_contract3_rebuild.launches
    got = cq3.masked_contract3_rebuild(ops, bounds, weights)
    assert cq3.masked_contract3_rebuild.launches == before + 1
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        1e-13 * float(want[fin].abs().max())
    assert torch.equal(got, cq3.masked_contract3_rebuild(ops, bounds,
                                                        weights))


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_rebuild_equals_the_table_sweep(dev, family, kind):
    """Where both routes serve (64-row tiles), the rebuild gives the table
    sweep's bits: the same cells, prefix sums, lanes and partials."""
    ops = _ops3(dev, family, kind, n=41)
    bounds, weights = _rows3(dev, ops.days, 33)
    assert torch.equal(
        cq3.masked_contract3_rebuild(_rebuilt(ops), bounds, weights),
        cq3.masked_contract3(ops, bounds, weights))


def test_rebuild_nan_and_inf_cells(dev):
    """A non-finite column (NaN cells) and an overflowing one (inf cells):
    each poisons exactly the slabs that hold it, as in the plain twin."""
    def edit(cols, p):
        cols[1][:, 1, 7] = False
        cols[2][:, 2, 30] = -1000.0

    ops = _rebuilt(_ops3(dev, "msm", "student", n=180, edit=edit))
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
    """n = 180: no table is built, every sweep and halving launches the
    rebuild kernel, and the roots are the plain solve's."""
    ops = _ops3(dev, "garch", "student", T=3, n=180)
    assert ops.U is None
    obj = torch.tensor([0.05], dtype=torch.float64, device=dev)
    w = torch.tensor([0.5, 0.3, 0.2], dtype=torch.float64, device=dev)
    before = (cq3.masked_contract3.launches,
              cq3.masked_contract3_rebuild.launches)
    got, _ = cs.full_solve_levels(ops, obj, w, CFG)
    assert cq3.masked_contract3.launches == before[0]
    assert cq3.masked_contract3_rebuild.launches > before[1] + 10
    want, _ = cs.full_solve_levels_reference(ops, obj, w, CFG)
    assert float((got - want).abs().max()) <= ATOL_ROOT


def test_rebuild_rejects_past_the_interval_rule(dev):
    with pytest.raises(ValueError, match="1024"):
        _ops3(dev, "garch", "gaussian", T=1, n=1025)
