"""The port's f32 engine (`engine="pallas"`) on the CPU, through its f32
plain twins, against the JAX package's f32 engine run as its own tests
run it on the CPU (Pallas in interpret mode): the sweeps (K3 / K4), the
fused dim-2 solve (`pallas_solver.py::full_solve_pallas_levels`) and
every query of `VaRBacktest` at dim 2 (MSM, GARCH) and dim 3 (MSM, GARCH,
Student-t copula), on small synthetic backtests (n <= 32, T <= 24) whose
returns are drawn by numpy from a seed.

Tolerances, each with its reason:
  * integrals, |diff| <= 1e-6: both sides sum the same float32 cells (the
    f64 prep cast to float32) in a different order, and a CDF value lies
    in [0, 1]; at n <= 32 the float32 sums differ by a few 1e-8;
  * roots within `root_plateau_bound(dx, weights)` on every day, and the
    0.9 quantile within the median-dx bound (`tests/test_pallas.py:93-98`,
    JAX's contract for its f32 engine): the CDF is a step function of the
    bound, and a one-ulp difference of a dynamic bound at a grid point
    (JAX's XLA may contract `b - x w` into an FMA) moves a root to another
    edge of its plateau;
  * refined roots within 5e-4 of JAX's xla refined roots
    (`tests/test_support_matrix.py:169-185`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu import backtest as jbt
from copula_var_tpu.copulas.fit import StudentFit
from copula_var_tpu.data import returns as jret
from copula_var_tpu.models.fit import GarchFit, MsmFit
from copula_var_tpu.ops import pallas_quadrature as jpq
from copula_var_tpu.ops import pallas_quadrature3 as jpq3
from copula_var_tpu.ops import pallas_solver as jps
from copula_var_tpu_torch import backtest as tbt
from copula_var_tpu_torch.data import returns as tret
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops import solvers as tsolvers

torch.set_num_threads(2)
# the f32 engine's products in full float32 (TF32 is a CUDA setting; the
# f32 operands refuse to be built with it on)
torch.backends.cuda.matmul.allow_tf32 = False

ATOL_INTEGRAL = 1e-6
ATOL_REFINED = 5e-4
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
SIZES = {2: (32, 24), 3: (16, 12)}  # dim -> (num_points, T)
N_IN = 150
WEIGHTS = {2: np.array([0.6, 0.4]), 3: np.array([0.5, 0.3, 0.2])}
W_BATCH = {2: np.array([[0.3, 0.7], [0.8, 0.2], [0.5, 0.5]]),
           3: np.array([[1 / 3, 1 / 3, 1 / 3], [0.2, 0.3, 0.5]])}
LEVELS = (0.01, 0.05)
CASES = [(2, "msm"), (2, "garch"), (3, "msm"), (3, "garch")]


def _fits(est, dim):
    if est == "msm":
        return [MsmFit(m_0=0.5 + 0.05 * i, b=3.0 + i, gamma=0.5 - 0.05 * i,
                       sigma=1.0 + 0.1 * i, log_likelihood=0.0)
                for i in range(dim)]
    return [GarchFit(1, 1, 0.2 + 0.05 * i, np.array([0.1]),
                     np.array([0.7 + 0.05 * i]), 0.0, 0.0,
                     np.array([0.2 + 0.05 * i, 0.1, 0.7 + 0.05 * i]))
            for i in range(dim)]


def _copula(dim):
    corr = np.full((dim, dim), 0.4) + 0.6 * np.eye(dim)
    corr[0, -1] = corr[-1, 0] = 0.25
    return StudentFit(6.0, corr, 0.0, np.zeros(1))


def _returns(dim, T, seed=7):
    rng = np.random.default_rng(seed)
    scale = 1.0 + 0.5 * np.abs(np.sin(np.arange(N_IN + T) / 17.0))
    return rng.standard_normal((N_IN + T, dim)) * scale[:, None]


def _pair(dim, est, engine="pallas", refine=False, quirks=False,
          weights=None):
    """(JAX backtest, port backtest) of the same fits, copula and
    returns; the JAX one on `engine`, the port's on "pallas"."""
    n, T = SIZES[dim]
    rets = _returns(dim, T)
    w = WEIGHTS[dim] if weights is None else weights
    adapter_kw = {"k": 2} if est == "msm" else {"p_max": 1, "q_max": 1}
    common = dict(num_points=n, model_fits_override=_fits(est, dim),
                  copula_fit_override=_copula(dim), refine_root=refine)
    jb = jbt.create_var_backtest(
        jret.from_returns(rets, n_insample=N_IN, weights=w), est, "student",
        engine=engine, **common, **adapter_kw)
    jb.reference_quirks = quirks
    tb = tbt.create_var_backtest(
        tret.from_returns(rets, n_insample=N_IN, weights=w), est, "student",
        device="cpu", engine="pallas", **common, **adapter_kw)
    tb.reference_quirks = quirks
    return jb, tb


def _hold_to_plateau(got, want, dx, weights):
    """Every day within the plateau bound of its row's weights, the 0.9
    quantile within the median-dx bound, NaN days equal."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    weights = np.atleast_2d(weights)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for row in range(got.shape[0]):
        w = weights[row % weights.shape[0]]
        ok = ~np.isnan(want[row])
        diff = np.abs(got[row][ok] - want[row][ok])
        assert diff.max(initial=0.0) <= jps.root_plateau_bound(dx, w)
        med = jps.root_plateau_bound(np.median(dx, keepdims=True), w)
        assert np.quantile(diff, 0.9) <= med


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"dim{c[0]}-{c[1]}")
def pair(request):
    dim, est = request.param
    jb, tb = _pair(dim, est)
    return dim, jb, tb


def test_full_iters_and_plateau_bound_are_jax_s():
    for tol, lo, hi in ((1e-6, -7.5, 0.0), (1e-4, -3.0, -1.0),
                        (1.0, -0.5, 0.0)):
        assert (tsolvers.full_iters(tol, lo, hi),) == \
            jps._full_iters(1, tol, lo, hi)
    dx = np.linspace(0.05, 0.4, 17)
    for w in (np.array([0.6, 0.4]), np.array([-0.2, 0.5, 0.7])):
        assert tsolvers.root_plateau_bound(dx, w) == \
            jps.root_plateau_bound(dx, w)
        assert tsolvers.root_plateau_bound(torch.tensor(dx), w, 2) == \
            jps.root_plateau_bound(dx, w, 2)


def test_compute_integral_matches_jax(pair):
    """K3 (dim 2) / K4 (dim 3) in float32: the stage-1 slab and a band."""
    dim, jb, tb = pair
    T = SIZES[dim][1]
    for lo, up in ((-100.0, -3.0), (-3.5, -2.0)):
        bounds = np.stack([np.full(T, lo), np.full(T, up)], -1)
        got = tb.compute_integral(bounds)
        assert got.dtype == np.float32
        np.testing.assert_allclose(
            got, np.asarray(jb.compute_integral(bounds)), rtol=0,
            atol=ATOL_INTEGRAL)


def test_calc_var_and_levels_within_plateau_bound(pair):
    dim, jb, tb = pair
    dx = np.asarray(jb.integration_inputs.dx)
    w = WEIGHTS[dim]
    _hold_to_plateau(tb.calc_var(0.05), np.asarray(jb.calc_var(0.05)), dx, w)
    _hold_to_plateau(tb.calc_var_levels(LEVELS),
                     np.asarray(jb.calc_var_levels(LEVELS)), dx, w)


def test_portfolios_and_grid_within_plateau_bound(pair):
    dim, jb, tb = pair
    dx = np.asarray(jb.integration_inputs.dx)
    wb = W_BATCH[dim]
    _hold_to_plateau(tb.calc_var_portfolios(wb, 0.05),
                     np.asarray(jb.calc_var_portfolios(wb, 0.05)), dx, wb)
    got = tb.calc_var_grid(wb, LEVELS)
    want = np.asarray(jb.calc_var_grid(wb, LEVELS))
    assert got.shape == (wb.shape[0], len(LEVELS), SIZES[dim][1])
    _hold_to_plateau(got.reshape(-1, got.shape[-1]),
                     want.reshape(-1, want.shape[-1]), dx,
                     np.repeat(wb, len(LEVELS), axis=0))


@pytest.mark.parametrize("dim, est", CASES,
                         ids=[f"dim{d}-{e}" for d, e in CASES])
def test_refine_root_matches_jax_xla_refined(dim, est):
    """The f32 roots re-solved against the float64 trapezoid sweep land on
    JAX's xla refined roots (levels and portfolio rows)."""
    jx, _ = _pair(dim, est, engine="xla", refine=True)
    _, tb = _pair(dim, est, refine=True)
    np.testing.assert_allclose(tb.calc_var_levels(LEVELS),
                               np.asarray(jx.calc_var_levels(LEVELS)),
                               rtol=0, atol=ATOL_REFINED)
    wb = W_BATCH[dim]
    np.testing.assert_allclose(tb.calc_var_portfolios(wb, 0.05),
                               np.asarray(jx.calc_var_portfolios(wb, 0.05)),
                               rtol=0, atol=ATOL_REFINED)


@pytest.mark.parametrize("dim", [2, 3])
def test_reference_quirks_thread_through(dim):
    """The reference's stage-2 anchor under `reference_quirks`, as
    `tests/test_fused_full.py` threads it through JAX's fused engine."""
    jb, tb = _pair(dim, "garch", quirks=True)
    dx = np.asarray(jb.integration_inputs.dx)
    _hold_to_plateau(tb.calc_var_levels(LEVELS),
                     np.asarray(jb.calc_var_levels(LEVELS)), dx,
                     WEIGHTS[dim])


def _dim2_ops(seed=3, n=24, T=10, nan_day=None):
    """f32 MSM operands of random day tensors (and, for JAX, the same
    inputs as numpy)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-5.0, 5.0, n) ** 3 / 25.0 + np.linspace(-1.0, 1.0, n)
    dx = np.gradient(x)
    q = 3
    V = rng.uniform(0.0, 0.05, (T, n, n))
    if nan_day is not None:
        V[nan_day, n // 2, n // 3] = np.nan
    dens = rng.uniform(0.1, 0.6, (2, q, n))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    ops = cq.sweep_operands(t(V), t(x), t(dx), t(dens), t(fc),
                            dtype=torch.float32)
    return ops, dict(V=V, x=x, dx=dx, dens=dens, fc=fc)


def _state(L, T, lo, hi):
    return (torch.full((L, T), lo, dtype=torch.float32),
            torch.full((L, T), hi, dtype=torch.float32))


def test_dim2_sweep_twin_matches_jax_k3():
    """The f32 sweep's plain twin against JAX's K3
    (`masked_sandwich_integrals`, interpret mode), unequal weights."""
    ops, raw = _dim2_ops()
    rng = np.random.default_rng(5)
    T = raw["V"].shape[0]
    lo = rng.uniform(-6.0, -2.0, T)
    bounds = np.stack([lo, lo + rng.uniform(0.1, 3.0, T)], -1)
    w = np.array([0.7, 0.3])
    w0 = raw["dens"][1] * raw["dx"][None, :]
    w1 = raw["dens"][0] * raw["dx"][None, :]
    want = np.asarray(jpq.masked_sandwich_integrals(
        bounds, raw["V"], w0, w1, raw["fc"], raw["x"], w, interpret=True))
    got = cq.masked_sweep(ops, torch.tensor(bounds[None], dtype=torch.float32),
                          torch.tensor(w[None], dtype=torch.float32))[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_INTEGRAL)


def test_dim2_fused_solve_twin_matches_jax_full_solve():
    """`full_solve` of float32 operands (plain twins) against JAX's
    `full_solve_pallas_levels` (interpret mode) on the same operands, a
    level ladder with one portfolio, and one portfolio per row."""
    ops, raw = _dim2_ops()
    w0 = raw["dens"][1] * raw["dx"][None, :]
    w1 = raw["dens"][0] * raw["dx"][None, :]
    levels = np.array([0.01, 0.05, 0.2])
    w = np.array([0.6, 0.4])
    want, want_nan = jps.full_solve_pallas_levels(
        raw["V"], w0, w1, raw["fc"], raw["x"], w, levels, interpret=True,
        day_block=8)
    got, nan = cs.full_solve(
        ops, torch.tensor(levels), torch.tensor(w), CFG)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(nan.numpy(),
                                  np.broadcast_to(want_nan, got.shape))
    _hold_to_plateau(got.numpy(), want, raw["dx"], w)
    wb = np.array([[0.3, 0.7], [0.8, 0.2], [0.5, 0.5]])
    want_p, _ = jps.full_solve_pallas_levels(
        raw["V"], w0, w1, raw["fc"], raw["x"], wb, np.full(3, 0.05),
        interpret=True, day_block=8)
    got_p, _ = cs.full_solve(ops, torch.full((3,), 0.05,
                                             dtype=torch.float64),
                             torch.tensor(wb), CFG)
    _hold_to_plateau(got_p.numpy(), want_p, raw["dx"], wb)


def test_dim2_solve_runs_full_iters_halvings(monkeypatch):
    """Exactly `_full_iters` halvings (23 at the defaults; 10 at a coarse
    tolerance) after the two stage sweeps, whatever the brackets: no
    all-zeros break and no bracket read on the host."""
    ops, _ = _dim2_ops()
    calls = []
    plain = cq.masked_sweep_reference

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return plain(*args, **kw)

    # the stage sweeps reach the twin through `masked_sweep`, the
    # halvings directly
    monkeypatch.setattr(cq, "masked_sweep_reference", counted)
    monkeypatch.setattr(cs, "masked_sweep_reference", counted)
    for tol, iters in ((1e-6, 23), (7.5 / 1000.0, 10)):
        calls.clear()
        cs.full_solve(ops, torch.tensor([0.05, 0.01]),
                      torch.tensor([0.5, 0.5]), CFG, tolerance=tol)
        assert iters == jps._full_iters(1, tol, CFG[3], CFG[4])[0]
        assert len(calls) == 2 + iters
    # brackets wholly below the grid: every slab is 0, and the while-loop
    # engine would break at once; the fixed count does not
    calls.clear()
    lo, hi = _state(1, ops.days, -100.0, -99.0)
    us = torch.ones((1, ops.days), dtype=torch.bool)
    _, bisect = cs._routes(ops, False)
    bisect(ops, lo, hi, torch.zeros_like(lo), hi.clone(), us,
           torch.tensor([0.05], dtype=torch.float32),
           torch.tensor([[0.5, 0.5]], dtype=torch.float32), 1e-6, n_iters=7)
    assert len(calls) == 7


def test_dim2_nan_day_is_nan_and_leaves_the_other_days():
    ops, _ = _dim2_ops()
    bad, _ = _dim2_ops(nan_day=4)
    obj, w = torch.tensor([0.05, 0.01]), torch.tensor([0.6, 0.4])
    want, want_nan = cs.full_solve(ops, obj, w, CFG)
    got, nan = cs.full_solve(bad, obj, w, CFG)
    assert not want_nan.any()
    assert nan[:, 4].all() and not nan[:, np.r_[0:4, 5:10]].any()
    keep = np.r_[0:4, 5:10]
    np.testing.assert_array_equal(got[:, keep].numpy(),
                                  want[:, keep].numpy())


def test_dim3_sweep_twin_matches_jax_k4():
    """The f32 dim-3 sweep's plain twin against JAX's K4
    (`dim3_integrals_pallas`, interpret mode) on the same GARCH cache
    inputs, Student-t copula, unequal weights."""
    jb, tb = _pair(3, "garch")
    inputs = jb.integration_inputs
    cache = jpq3.build_garch_dim3_cache(
        inputs.forecast_vols, inputs.x, inputs.dx, jnp.asarray(WEIGHTS[3]),
        jb.copula_spec)
    T = SIZES[3][1]
    rng = np.random.default_rng(9)
    lo = rng.uniform(-6.0, -2.0, T)
    bounds = np.stack([lo, lo + rng.uniform(0.1, 3.0, T)], -1)
    want = np.asarray(jpq3.dim3_integrals_pallas(
        jnp.asarray(bounds), cache, family="garch", kind="student",
        interpret=True))
    ops = tb.sweep_operands()
    assert ops.dtype == torch.float32 and ops.sigma_inv.dtype == torch.float64
    sweep, _ = cs._routes(ops, False)
    got = sweep(
        ops, torch.tensor(bounds[None], dtype=torch.float32),
        torch.tensor(WEIGHTS[3][None], dtype=torch.float32))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_INTEGRAL)


def test_f32_operands_refuse_tf32_on_the_card(monkeypatch):
    """With TF32 on, the f32 operands of a CUDA tensor are refused before
    any product runs (the check needs no card: it reads the device type
    and the flag)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        cq.require_full_f32_matmul(torch.device("cuda", 0))
    cq.require_full_f32_matmul(torch.device("cpu"))


def test_engine_assignment_drops_the_operands():
    """JAX's README recipe, `bt.engine = "pallas"` after the backtest is
    built: the f64 operands give way to float32 ones, and back."""
    _, tb = _pair(2, "garch")
    tb.engine = "xla"
    assert tb.sweep_operands().dtype == torch.float64
    tb.engine = "pallas"
    assert tb._ops is None
    assert tb.sweep_operands().dtype == torch.float32
    with pytest.raises(ValueError, match="engine="):
        tb.engine = "sharded_pallas"


def _dim4_backtest():
    rets = _returns(4, 4)
    return tbt.create_var_backtest(
        tret.from_returns(rets, n_insample=N_IN), "garch", "gaussian",
        num_points=8, model_fits_override=_fits("garch", 4),
        copula_fit_override=_copula(4), device="cpu", engine="pallas",
        p_max=1, q_max=1)


class _MinimalGarch:
    """JAX's minimal plugin contract: no day_tensors / day_columns."""

    def __init__(self):
        self._inner = tbt.GarchAdapter(p_max=1, q_max=1)

    def fit(self, in_sample, device="cuda", timings=None):
        return self._inner.fit(in_sample, device=device)

    def marginals_densities(self, in_sample, fits, device="cuda"):
        return self._inner.marginals_densities(in_sample, fits, device)

    def integration_inputs(self, windows, fits, num_points, box=(-5.0, 5.0),
                           device="cuda"):
        return self._inner.integration_inputs(windows, fits, num_points, box,
                                              device)

    def integrals(self, bounds, inputs, spec, weights, box_min=-5.0):
        return self._inner.integrals(bounds, inputs, spec, weights, box_min)


def _plugin_backtest():
    rets = _returns(2, 4)
    data = tret.from_returns(rets, n_insample=N_IN)
    adapter = _MinimalGarch()
    fits = _fits("garch", 2)
    inputs = adapter.integration_inputs(data.rolling_windows(), fits, 8,
                                        device="cpu")
    return tbt.VaRBacktest(data, adapter, "student", _copula(2), fits,
                           inputs, num_points=8, device="cpu",
                           engine="pallas")


def _grid_mesh_of_one():
    """A (1, 1) grid mesh of one process: the f32 engine serves one
    device or a day mesh, and JAX has no f32 grid-sharded engine."""
    from copula_var_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device="cpu", axis_names=("days", "grid"),
                     shape=(1, 1))


@pytest.mark.parametrize("case", ["dim4", "plugin", "mesh"])
def test_pallas_refuses_what_jax_does_not_serve(case):
    if case == "dim4":
        bt = _dim4_backtest()
        match = r"requires dim in \{2, 3\}"
    elif case == "plugin":
        bt = _plugin_backtest()
        match = r"requires dim in \{2, 3\}"
    else:
        _, bt = _pair(2, "garch")
        bt.mesh = _grid_mesh_of_one()
        match = "no f32 grid-sharded engine"
    with pytest.raises(ValueError, match=match):
        bt.calc_var(0.05)
    T = bt.data.out_sample_n
    with pytest.raises(ValueError, match=match):
        bt.compute_integral(np.stack([np.full(T, -100.0),
                                      np.full(T, -3.0)], -1))
    with pytest.raises(ValueError, match=match):
        bt.calc_var_portfolios(np.full((1, bt.data.dim), 1.0 / bt.data.dim))


def test_readme_recipe_load_artifacts_then_pallas(tmp_path):
    """JAX's "Production serving" recipe (README): `load_artifacts` of
    the flagship MSM artifact, then `bt.engine = "pallas"`, then
    `calc_var_grid`, on the artifact cut to 6 days, held to JAX's f32
    engine on the same cut."""
    import os

    from copula_var_tpu.data import from_csv as jax_from_csv
    from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    data_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data")
    days, n_in = 6, 1135
    z = np.load(os.path.join(data_dir, "flagship_artifacts_msm.npz"))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos"):
        arrays[k] = arrays[k][:days]
    path = str(tmp_path / "msm_cut.npz")
    np.savez(path, **arrays)
    full = jax_from_csv(os.path.join(data_dir, "flagship.csv"), n_in)
    rets = full.returns[: n_in + days]
    jb = jax_load(path, jret.from_returns(rets, full.tickers, n_in))
    tb = load_artifacts(path, tret.from_returns(rets, full.tickers, n_in),
                        device="cpu")
    assert tb.sweep_operands().dtype == torch.float64
    jb.engine = tb.engine = "pallas"
    wb = np.array([[0.3, 0.7], [0.5, 0.5]])
    got = tb.calc_var_grid(wb, LEVELS)
    want = np.asarray(jb.calc_var_grid(wb, LEVELS))
    assert got.shape == (2, len(LEVELS), days)
    _hold_to_plateau(got.reshape(-1, days), want.reshape(-1, days),
                     np.asarray(jb.integration_inputs.dx),
                     np.repeat(wb, len(LEVELS), axis=0))


@pytest.mark.parametrize("T, n, q, free_gib, f32_route, f64_route", [
    (500, 100, 5, 3.0, "table", "rebuild"),  # U: 2.02 GB f32, 4.04 GB f64
    (500, 169, 5, 80.0, "table", "table"),
    (500, 192, 1, 80.0, "table", "rebuild"),  # the f32 slab fits to 192
    (500, 193, 5, 80.0, "rebuild", "rebuild"),
    (500, 300, 5, 0.01, "rebuild_full", "rebuild_full"),
])
def test_f32_routes_are_sized_by_float32_bytes(T, n, q, free_gib, f32_route,
                                               f64_route):
    """The routes stay pure functions of the shapes, the free bytes and
    the type: memory and width pick the route, never the answer."""
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3

    free = int(free_gib * 2**30)
    assert cq3.contract3_route(T, n, q, None, free, torch.float32) == \
        f32_route
    assert cq3.contract3_route(T, n, q, None, free) == f64_route


def test_f32_limits():
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3

    f32 = torch.float32
    assert (cq.bisect_max_grid_points(), cq.bisect_max_grid_points(f32)) \
        == (169, 192)
    assert (cs.route("cuda", f32, 2, 192).bisect,
            cs.route("cuda", f32, 2, 193).bisect) == ("k1", "fixed_halvings")
    assert cq.prefix_table_bytes(500, 100, dtype=f32) * 2 - 500 * 100 == \
        cq.prefix_table_bytes(500, 100)
    assert cq3.table_bytes(500, 100, dtype=f32) == 2_020_000_000
    for n in (2, 45, 100, 169, 192):
        stride = cq3.slab_stride(n, f32)
        assert stride % 4 == 0 and 0 <= stride - n * cq.row_pitch(n) < 4
    assert cq3.rebuild_tile_rows(1024, 22, f32) == 64
    with pytest.raises(ValueError, match="float64 or float32"):
        cq.itemsize(torch.float16)
