"""Port parity for the four-asset (dim >= 4) path on the CPU: the
transform-cached sweeps of `ops/tcached.py` (`ColumnOperands`,
`tcached_sweep`), the sweep-driven bisection and full solve
(`ops/cuda_solver.py`), the budget, the MSM state padding,
`load_artifacts` -> `calc_var*` on the committed dim-4 record
(`data/dim4_var.npz`, written by `examples/make_dim4_artifacts.py`), all
against the JAX package on the same numpy inputs. Small sizes (dim 4 at
n = 12, dim 5 at n = 6) except one day at n = 90 and the record's n = 32
on 16 days. The fits, the files and `run_backtest` at dim 4 are
`tests/test_torch_dim4_fit.py`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu import backtest as jbt
from copula_var_tpu.copulas import fit as jcfit
from copula_var_tpu.data import from_csv as jax_from_csv
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import garch_grid, msm_grid
from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
from copula_var_tpu_torch.backtest import MsmAdapter, VaRBacktest
from copula_var_tpu_torch.copulas import fit as tcfit
from copula_var_tpu_torch.data import from_returns
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.ops import solvers as tsolvers
from copula_var_tpu_torch.ops import tcached as tc
from copula_var_tpu_torch.utils.artifacts import load_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
CSV = os.path.join(DATA, "dim4.csv")
N_IN = 1135
RTOL = 1e-10
ATOL_ROOT = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
TOL = 1e-6
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
T = 5
# dim -> (grid points, MSM states q, weights: unequal, to expose the pairing)
SIZES = {4: (12, 3, np.array([0.4, 0.3, 0.2, 0.1])),
         5: (6, 2, np.array([0.3, 0.25, 0.2, 0.15, 0.1]))}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _corr(dim):
    i = np.arange(dim)
    return 0.75 ** np.abs(i[:, None] - i[None, :]) * 0.9 + 0.1 * np.eye(dim)


def _specs(kind, corr):
    if kind == "gaussian":
        return (jq.CopulaSpec("gaussian", (jnp.asarray(corr),)),
                tq.CopulaSpec("gaussian", (_t(corr),)))
    return (jq.CopulaSpec("student", (6.5, jnp.asarray(corr))),
            tq.CopulaSpec("student", (6.5, _t(corr))))


def _bounds(rng, T_, L=None):
    shape = (T_,) if L is None else (L, T_)
    lo = rng.uniform(-8.0, -1.0, shape)
    return np.stack([lo, lo + rng.uniform(0.05, 4.0, shape)], axis=-1)


def _case(dim, seed=11):
    """Raw inputs of both families at `dim`, n points, q states."""
    n, q, w = SIZES[dim]
    rng = np.random.default_rng(seed)
    x, dx = msm_grid(n)
    vols = np.sort(rng.uniform(0.5, 2.0, (dim, q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(q), size=(T, dim))
    fc = rng.dirichlet(np.ones(q**dim), size=T)
    fv = rng.uniform(0.6, 1.8, (T, dim))
    return dict(dim=dim, n=n, q=q, w=w, x=x, dx=dx, vols=vols, dens=dens,
                fbs=fbs, fc=fc, fv=fv, corr=_corr(dim))


def _family(case, family, kind):
    """(port ColumnOperands, JAX kernel_id, JAX aux without weights, JAX
    spec)."""
    jspec, tspec = _specs(kind, case["corr"])
    x, dx, dim, n = case["x"], case["dx"], case["dim"], case["n"]
    if family == "msm":
        tcols = tq.msm_day_columns(_t(case["fbs"]), _t(x), _t(case["vols"]),
                                   tspec)
        ops = tc.column_operands(tcols, _t(x), _t(dx), tspec,
                                 densities=_t(case["dens"]),
                                 forecast_combos=_t(case["fc"]))
        jcols = jq.msm_day_columns(case["fbs"], x, case["vols"], jspec)
        kid = ("msm_tcached", kind, jq._day_batch(n, dim, T))
        aux = (jcols, jnp.asarray(case["fc"]), x, dx,
               jnp.asarray(case["dens"]))
        return ops, kid, aux, jspec
    tcols, p_cols = tq.garch_day_columns(_t(case["fv"]), _t(x), tspec)
    ops = tc.column_operands(tcols, _t(x), _t(dx), tspec, p_cols=p_cols)
    jcols, jp = jq.garch_day_columns(case["fv"], x, jspec)
    kid = ("garch_tcached", kind, jq._day_batch(n, dim, T))
    return ops, kid, (jcols, jp, x, dx), jspec


def _aux(aux, spec, weights):
    """The JAX `_call_integral_kernel` aux tuple at these weights."""
    return aux + (jnp.asarray(weights), spec.params, -5.0)


def _jax_sweep(case, family, jspec, b, w):
    x, dx = case["x"], case["dx"]
    if family == "msm":
        cols = jq.msm_day_columns(case["fbs"], x, case["vols"], jspec)
        return np.asarray(jq.msm_integrals_tcached(
            b, cols, case["fc"], x, dx, case["dens"], w, jspec))
    cols, p = jq.garch_day_columns(case["fv"], x, jspec)
    return np.asarray(jq.garch_integrals_tcached(b, cols, p, x, dx, w,
                                                 jspec))


@pytest.mark.parametrize("dim", [4, 5])
@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["gaussian", "student"])
def test_tcached_sweep_matches_jax(dim, family, kind):
    """Two rows of random bounds through `tcached_sweep` against the JAX
    `xla` engine's transform-cached sweep; the trapezoid twin too."""
    case = _case(dim)
    ops, _, _, jspec = _family(case, family, kind)
    assert ops.days == T and ops.cols[0].shape == (T, dim, case["n"])
    rng = np.random.default_rng(5)
    b = _bounds(rng, T, L=2)
    w = np.stack([case["w"], case["w"][::-1]])
    got = tc.tcached_sweep(ops, _t(b), _t(w)).numpy()
    want = np.stack([_jax_sweep(case, family, jspec, b[i], w[i])
                     for i in range(2)])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)
    trap = tc.tcached_trap_sweep(ops, _t(b), _t(w)).numpy()
    x = case["x"]
    if family == "msm":
        cols = jq.msm_day_columns(case["fbs"], x, case["vols"], jspec)
        want_trap = [jq._msm_tcached_trap(
            jnp.asarray(b[i]), cols, jnp.asarray(case["fc"]),
            jnp.asarray(x), jnp.asarray(case["dens"]), jnp.asarray(w[i]),
            -5.0, kind, jspec.params, T) for i in range(2)]
    else:
        cols, p = jq.garch_day_columns(case["fv"], x, jspec)
        want_trap = [jq._garch_tcached_trap(
            jnp.asarray(b[i]), cols, p, jnp.asarray(x), jnp.asarray(w[i]),
            -5.0, kind, jspec.params, T) for i in range(2)]
    np.testing.assert_allclose(trap, np.stack(want_trap), rtol=RTOL,
                               atol=1e-300)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_tie_cells_round_as_the_solve_programs(family):
    """The stage-1 slab [-100, -3] with weights (0.4, 0.3, 0.2, 0.1) puts
    the inner cut exactly on grid points of cells (i0, i1, i2) whose
    offset prev = x0 w1 + x1 w2 + x2 w3 is a round number, so the
    rounding of prev decides whether a cell is in. The port rounds each
    product and sum as the program states them, as JAX does op by op; a
    JAX program jitted on a CPU with fused multiply-adds may contract
    prev into them and flip such cells (the dim-4 record is written with
    XLA's CPU ISA capped at AVX for that reason). Held here against JAX
    op by op."""
    case = _case(4)
    ops, _, _, jspec = _family(case, family, "gaussian")
    b = np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1)
    w = case["w"]
    got = tc.tcached_sweep(ops, _t(b)[None], _t(w)[None])[0].numpy()
    with jax.disable_jit():
        want = _jax_sweep(case, family, jspec, b, w)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)


def test_one_day_sweep_at_the_widest_grid():
    """n = 90, the widest grid the budget serves at dim 4 (65.6 M cells):
    one day of the GARCH family with a Student-t copula, over a slab whose
    upper edge is no round number (no tie cells)."""
    n = 90
    x, dx = garch_grid(n)
    jspec, tspec = _specs("student", _corr(4))
    fv = np.array([[0.9, 1.2, 1.3, 1.1]])
    b = np.array([[-100.0, -2.7318]])
    w = SIZES[4][2]
    tcols, p = tq.garch_day_columns(_t(fv), _t(x), tspec)
    ops = tc.column_operands(tcols, _t(x), _t(dx), tspec, p_cols=p)
    got = tc.tcached_sweep(ops, _t(b)[None], _t(w)[None])[0].numpy()
    jcols, jp = jq.garch_day_columns(fv, x, jspec)
    want = np.asarray(jq.garch_integrals_tcached(b, jcols, jp, x, dx, w,
                                                 jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_day_batch_refuses_past_the_budget_as_jax():
    for n, dim in ((90, 4), (36, 5), (32, 4), (12, 4)):
        for T_ in (1, 16, 500):
            assert tq._day_batch(n, dim, T_) == jq._day_batch(n, dim, T_)
    assert tq._device_day_batch(90, 4, 500, "cuda") == 1
    assert tq._device_day_batch(32, 4, 500, "cuda") == 64
    for n, dim in ((91, 4), (37, 5)):
        with pytest.raises(ValueError) as want:
            jq._day_batch(n, dim, 16)
        with pytest.raises(ValueError, match="transient budget") as got:
            tq._day_batch(n, dim, 16)
        assert str(got.value) == str(want.value)
    x, _ = garch_grid(91)
    cols = (_t(np.zeros((2, 4, 91))),)
    with pytest.raises(ValueError, match="transient budget"):
        tc.column_operands(cols, _t(x), _t(x), tq.CopulaSpec(
            "gaussian", (_t(np.eye(4)),)), p_cols=cols[0])
    with pytest.raises(ValueError, match="bivariate"):
        tc.column_operands(cols, _t(x), _t(x), tq.CopulaSpec(
            "plackett", (4.0,)), p_cols=cols[0])


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("quirks", [False, True])
def test_full_solve_dim4_matches_jax(family, quirks):
    """Levels of one portfolio and per-row portfolios through the port's
    full solve against the JAX `xla` engine's device programs."""
    case = _case(4)
    ops, kid, aux, jspec = _family(case, family, "student")
    w = case["w"]
    obj = np.array([0.01, 0.05])
    want, want_nan = jbt._device_full_solve_levels_jit(
        kid, _aux(aux, jspec, w), jnp.asarray(obj), jnp.asarray(CFG), TOL,
        T, quirks)
    got, got_nan = cs.full_solve(ops, _t(obj), _t(w), CFG, TOL, quirks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ROOT)
    np.testing.assert_array_equal(got_nan.numpy(), np.asarray(want_nan))
    wb = np.array([w, [0.1, 0.2, 0.3, 0.4]])
    obj = np.array([0.05, 0.01])
    want, want_nan = jbt._device_full_solve_portfolios_jit(
        kid, _aux(aux, jspec, w), jnp.asarray(obj), jnp.asarray(wb),
        jnp.asarray(CFG), TOL, T, quirks)
    got, got_nan = cs.full_solve(ops, _t(obj), _t(wb), CFG, TOL, quirks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ROOT)
    np.testing.assert_array_equal(got_nan.numpy(), np.asarray(want_nan))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_fixed_count_bisection_equals_while_loop_dim4(family):
    """The CUDA route's bisection (host-counted halvings, device-side
    freeze and exit gates, `tcached_sweep` per halving) gives the
    while-loop's roots, extra halvings change nothing, and a row whose
    CDF is exactly zero freezes in both."""
    case = _case(4)
    ops, _, _, _ = _family(case, family, "student")
    wrows = _t([case["w"], [0.1, 0.2, 0.3, 0.4], [0.25] * 4])
    obj = _t([0.01, 0.05, 0.1])
    stage1 = torch.stack([torch.full((T,), -100.0, dtype=torch.float64),
                          torch.full((T,), CFG[0], dtype=torch.float64)], -1)
    F1 = tc.tcached_sweep(ops, stage1.expand(3, T, 2), wrows)
    state = [s.clone() for s in tsolvers.bracket_state_batched(
        F1, obj, lambda b: tc.tcached_sweep(ops, b, wrows), CFG, False)[:5]]
    state[0][2], state[1][2] = -60.0, -50.0
    state[2][2], state[3][2] = 0.0, -60.0
    _, bisect = cs._routes(ops, False)
    plain = bisect(ops, *state, obj, wrows, TOL)
    n_iters = cs.halvings(float((state[1] - state[0]).max()), TOL)
    for extra in (0, 3):
        fixed = cs.bisect_fixed_count(ops, *state, obj, wrows, TOL,
                                      n_iters + extra, tc.tcached_sweep)
        np.testing.assert_array_equal(fixed.numpy(), plain.numpy())
    assert float(plain[2, 0]) == -55.0  # frozen on its first halving
    meta = tc.ColumnOperands(*[
        t.to("meta") if torch.is_tensor(t) else t for t in ops
    ])._replace(cols=tuple(c.to("meta") for c in ops.cols))
    with pytest.raises(ValueError, match="unsupported device"):
        cs.full_solve(meta, obj.to("meta"), wrows.to("meta"), CFG, TOL)


def test_msm_unequal_states_pad_as_jax():
    """An asset whose vol states collapse to one level (m_0 = 1) is padded
    to the others' q = 3 (k = 2) with zero-probability states; the
    integration inputs and a VaR solve equal JAX's at dim 4."""
    from copula_var_tpu.backtest import MsmAdapter as JMsm
    from copula_var_tpu.models.fit import MsmFit as JFit
    from copula_var_tpu_torch.models.fit import MsmFit

    rng = np.random.default_rng(3)
    rets = rng.standard_normal((160, 4)) * np.array([1.0, 1.2, 0.8, 1.1])
    params = [(1.4, 2.0, 0.6, 1.1), (1.0, 3.0, 0.5, 1.2),
              (1.3, 2.5, 0.4, 0.8), (1.6, 1.5, 0.7, 1.0)]
    fits = [MsmFit(*p, -100.0) for p in params]
    jfits = [JFit(*p, -100.0) for p in params]
    tdata = from_returns(rets, n_insample=150, weights=SIZES[4][2])
    jdata = jax_from_returns(rets, n_insample=150, weights=SIZES[4][2])
    got = MsmAdapter(k=2).integration_inputs(tdata.rolling_windows(), fits,
                                             10, device="cpu")
    want = JMsm(k=2).integration_inputs(jdata.rolling_windows(), jfits, 10)
    assert got.densities.shape == (4, 3, 10)
    assert got.forecast_combos.shape == (10, 81)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-300)
    cfit = tcfit.GaussianFit(_corr(4), 0.0, np.zeros(6))
    jc = jcfit.GaussianFit(_corr(4), 0.0, np.zeros(6))
    bt = VaRBacktest(tdata, MsmAdapter(k=2), "gaussian", cfit, fits, got,
                     num_points=10, device="cpu")
    jb = jbt.VaRBacktest(jdata, JMsm(k=2), "gaussian", num_points=10,
                         model_fits_override=jfits, copula_fit_override=jc)
    np.testing.assert_allclose(bt.calc_var(0.05), np.asarray(jb.calc_var(
        0.05)), rtol=0, atol=ATOL_ROOT)


def _record():
    return np.load(os.path.join(DATA, "dim4_var.npz"))


def _truncated(tmp_path, est, days):
    """The dim-4 artifact cut to its first `days` out-of-sample days, and
    matching returns for both packages."""
    z = np.load(os.path.join(DATA, f"dim4_artifacts_{est}.npz"))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos",
              "ii_forecast_vols"):
        if k in arrays:
            arrays[k] = arrays[k][:days]
    path = str(tmp_path / f"{est}_{days}.npz")
    np.savez(path, **arrays)
    w = _record()["weights"]
    full = jax_from_csv(CSV, n_insample=N_IN, weights=w)
    rets = full.returns[: N_IN + days]
    return (path, jax_from_returns(rets, full.tickers, N_IN, weights=w),
            from_returns(rets, full.tickers, N_IN, weights=w))


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_dim4_record_serves_on_its_first_days(tmp_path, est):
    """`load_artifacts` reads the JAX-written dim-4 file; on the first 16
    days at n = 32, calc_var equals the record's full-T series there and
    the two portfolio rows equal `*_ptf`; with refine_root on the first 8
    days, `*_refined`; one sweep equals JAX's."""
    rec = _record()
    days = int(rec["days_wide"])
    path, jdata, tdata = _truncated(tmp_path, est, days)
    tb = load_artifacts(path, tdata, device="cpu")
    assert tb.data.dim == 4 and tb.integration_inputs.x.shape == (32,)
    assert isinstance(tb.sweep_operands(), tc.ColumnOperands)
    np.testing.assert_allclose(tb.calc_var(float(rec["obj_var"])),
                               rec[f"{est}_var"][:days], rtol=0,
                               atol=ATOL_ROOT)
    ptf = tb.calc_var_portfolios(rec["ptf_rows"], rec["ptf_levels"])
    np.testing.assert_allclose(ptf, rec[f"{est}_ptf"], rtol=0,
                               atol=ATOL_ROOT)
    bounds = _bounds(np.random.default_rng(7), days)
    np.testing.assert_allclose(tb.compute_integral(bounds),
                               jax_load(path, jdata).compute_integral(bounds),
                               rtol=RTOL)
    n_ref = int(rec["days_refined"])
    path, _, tdata = _truncated(tmp_path, est, n_ref)
    refined = load_artifacts(path, tdata, device="cpu", refine_root=True)
    np.testing.assert_allclose(refined.calc_var(float(rec["obj_var"])),
                               rec[f"{est}_refined"], rtol=0, atol=ATOL_ROOT)
