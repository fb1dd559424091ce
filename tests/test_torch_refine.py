"""Port parity for `refine_root` on the CPU: the trapezoid twins of
`copula_var_tpu_torch.ops.quadrature`, `ops/solvers.py::trap_bisect`, the
refine pass `ops/refine.py` and `VaRBacktest(refine_root=True)`, against
the JAX package. Small sizes (n = 24, T = 10, q = 3) for the twins, the
closed-form check of `tests/test_refine_root.py`, the flagship refined
record at full size and the dim-3 refined record on its first 8 days."""

import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu.backtest import GarchAdapter as JaxGarchAdapter
from copula_var_tpu.backtest import VaRBacktest as JaxVaRBacktest
from copula_var_tpu.copulas.fit import GaussianFit as JaxGaussianFit
from copula_var_tpu.data import from_csv as jax_from_csv
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.models.fit import GarchFit as JaxGarchFit
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops import solvers as jsolvers
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu.ops.special import norm_ppf as jax_norm_ppf
from copula_var_tpu_torch import backtest as bt_mod
from copula_var_tpu_torch.backtest import create_var_backtest
from copula_var_tpu_torch.copulas.fit import GaussianFit
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.models.fit import GarchFit
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.ops import refine as trefine
from copula_var_tpu_torch.ops import solvers as tsolvers
from copula_var_tpu_torch.utils.artifacts import load_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
N_IN = 1135
RTOL = 1e-12
ATOL_VAR = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
T, N, Q = 10, 24, 3
CORR = {2: np.array([[1.0, 0.6], [0.6, 1.0]]),
        3: np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35],
                     [0.25, 0.35, 1.0]])}
WEIGHTS = {2: np.array([0.3, 0.7]), 3: np.array([0.5, 0.3, 0.2])}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _specs(kind, dim):
    c = CORR[dim]
    if kind == "gaussian":
        return (jq.CopulaSpec("gaussian", (jnp.asarray(c),)),
                tq.CopulaSpec("gaussian", (_t(c),)))
    return (jq.CopulaSpec("student", (6.5, jnp.asarray(c))),
            tq.CopulaSpec("student", (6.5, _t(c))))


def _bounds(rng, T, lead=()):
    lo = rng.uniform(-8.0, -1.0, lead + (T,))
    return np.stack([lo, lo + rng.uniform(0.05, 4.0, lo.shape)], axis=-1)


def _case(dim, seed=11):
    """Raw inputs of both families at `dim`: n = 24 points, q = 3."""
    rng = np.random.default_rng(seed + dim)
    x, dx = msm_grid(N)
    vols = np.sort(rng.uniform(0.5, 2.0, (dim, Q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(Q), size=(T, dim))
    fc = rng.dirichlet(np.ones(Q**dim), size=T)
    fv = rng.uniform(0.6, 1.8, (T, dim))
    return dict(x=x, dx=dx, vols=vols, dens=dens, fbs=fbs, fc=fc, fv=fv)


def _day_tensors(c, family, jspec):
    """dim-2 day tensors, built once by the JAX package: both twins get
    the same numpy input."""
    if family == "msm":
        return np.asarray(jq.msm_day_tensors(c["fbs"], c["x"], c["vols"],
                                             jspec))
    return np.asarray(jq.garch_day_tensors(c["fv"], c["x"], jspec))


def _trap2(family, b, V, c, w, lib):
    """One dim-2 trap sweep through `lib` (jq or tq)."""
    cv = jnp.asarray if lib is jq else _t
    if family == "msm":
        return lib.msm_integrals_trap(cv(b), cv(V), cv(c["fc"]), cv(c["x"]),
                                      cv(c["dens"]), cv(w))
    return lib.garch_integrals_trap(cv(b), cv(V), cv(c["x"]), cv(w))


def test_trap_weights_and_fractions_match_jax(rng):
    x, _ = msm_grid(N)
    tw = tq.trap_weights(_t(x))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jq.trap_weights(x)))
    for dim in (2, 3):
        b = _bounds(rng, 6)
        b[:2] = np.stack([x[3:5], x[13:15]], axis=-1)  # bounds on the grid
        b[2, 0] = -100.0  # the CDF slab's lower edge, clamped to the box
        got = tq.halfspace_frac(_t(x), tw, _t(b[:, 0]), _t(b[:, 1]),
                                _t(WEIGHTS[dim]))
        want = np.stack([np.asarray(jq.halfspace_frac(
            x, jq.trap_weights(x), lo, up, WEIGHTS[dim])) for lo, up in b])
        assert got.shape == (6,) + (N,) * dim
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("kind", ["gaussian", "student"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_trap_sweep_dim2_matches_jax(rng, family, kind):
    c = _case(2)
    jspec, _ = _specs(kind, 2)
    V = _day_tensors(c, family, jspec)
    b = _bounds(rng, T)
    b[:3, 0] = -100.0
    want = np.asarray(_trap2(family, b, V, c, WEIGHTS[2], jq))
    got = _trap2(family, b, V, c, WEIGHTS[2], tq).numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # days in chunks of 3 give the same bits as one chunk
    if family == "garch":
        chunked = tq.garch_integrals_trap(_t(b), _t(V), _t(c["x"]),
                                          _t(WEIGHTS[2]), day_batch=3)
        np.testing.assert_array_equal(chunked.numpy(), got)


@pytest.mark.parametrize("kind", ["gaussian", "student"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_trap_sweep_dim3_matches_jax(rng, family, kind):
    """The transform-cached trap twins, each package from its own
    transform columns (as the dim-3 sweeps are held)."""
    c = _case(3)
    jspec, tspec = _specs(kind, 3)
    x, w = c["x"], WEIGHTS[3]
    b = _bounds(rng, T, (2,))
    b[0, :, 0] = -100.0
    if family == "msm":
        jcols = jq.msm_day_columns(c["fbs"], x, c["vols"], jspec)
        tcols = tq.msm_day_columns(_t(c["fbs"]), _t(x), _t(c["vols"]), tspec)
        ops = cq3.contract3_operands(tcols, _t(x), _t(c["dx"]), tspec,
                                     densities=_t(c["dens"]),
                                     forecast_combos=_t(c["fc"]))
        want = [np.asarray(jq._msm_tcached_trap(
            jnp.asarray(bb), jcols, jnp.asarray(c["fc"]), x,
            jnp.asarray(c["dens"]), jnp.asarray(w), -5.0, kind,
            jspec.params, 4)) for bb in b]
    else:
        jcols, jp = jq.garch_day_columns(c["fv"], x, jspec)
        tcols, tp = tq.garch_day_columns(_t(c["fv"]), _t(x), tspec)
        ops = cq3.contract3_operands(tcols, _t(x), _t(c["dx"]), tspec,
                                     p_cols=tp)
        want = [np.asarray(jq._garch_tcached_trap(
            jnp.asarray(bb), jcols, jp, x, jnp.asarray(w), -5.0, kind,
            jspec.params, 4)) for bb in b]
    got = trefine.trap_sweep(ops, _t(b), _t(np.stack([w, w])))
    assert got.shape == (2, T) and np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=RTOL)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_trap_sweep_nan_rules_match_jax(family):
    """A NaN cell outside the slab contributes 0 (the where-mask before
    the scaling); one inside the slab surfaces as NaN, in both packages
    (`tests/test_refine_root.py:127-152`)."""
    c = _case(2)
    x = c["x"]
    V = np.exp(-0.5 * (x[:, None] ** 2 + x[None, :] ** 2)) / (2 * np.pi)
    V = np.tile(V[None], (T, 1, 1))
    V[:, :, -2:] = np.nan  # inner-axis top nodes: above every cut below
    V[1, :, 8] = np.nan  # inside the slab on day 1 only
    w = np.array([0.5, 0.5])
    b = np.tile([-100.0, -1.2], (T, 1))
    want = np.asarray(_trap2(family, b, V, c, w, jq))
    got = _trap2(family, b, V, c, w, tq).numpy()
    assert np.isnan(want[1]) and np.isnan(got[1])
    keep = np.arange(T) != 1
    assert np.all(np.isfinite(want[keep]))
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL)


def test_tcached_garch_trap_nan_to_num_first():
    """The transform-cached GARCH twin zeroes non-finite C * pdf cells
    before scaling by the fractions (no where-mask), as JAX does: a
    non-finite Student column gives a finite sweep in both."""
    c = _case(3)
    jspec, tspec = _specs("student", 3)
    x, w = c["x"], WEIGHTS[3]
    jcols, jp = jq.garch_day_columns(c["fv"], x, jspec)
    jcols = (jcols[0], jcols[1].at[2, 1, 5].set(False), jcols[2])
    tcols = tuple(torch.from_numpy(np.array(a)) for a in jcols)
    b = np.tile([-100.0, -0.5], (T, 1))
    want = np.asarray(jq._garch_tcached_trap(
        jnp.asarray(b), jcols, jp, x, jnp.asarray(w), -5.0, "student",
        jspec.params, 4))
    got = tq.garch_tcached_trap(_t(b), tcols, _t(np.asarray(jp)), _t(x),
                                _t(w), tspec).numpy()
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_trap_bisect_matches_jax(rng, family):
    """12 halvings in +-h windows, h per row, against JAX's trap_bisect
    on the same trap sweep; roots (L, T) from the staircase solve."""
    c = _case(2)
    jspec, _ = _specs("student", 2)
    V = _day_tensors(c, family, jspec)
    wr = np.array([[0.3, 0.7], [0.6, 0.4]])
    roots = rng.uniform(-3.0, -1.0, (2, T))
    obj = np.array([0.05, 0.1])
    h = np.array([0.2, 0.35])

    def jsweep(b):
        return jnp.stack([_trap2(family, b[l], V, c, wr[l], jq)
                          for l in range(2)])

    want = np.asarray(jsolvers.trap_bisect(
        jsweep, jnp.asarray(roots), jnp.asarray(obj[:, None]),
        jnp.asarray(h[:, None])))
    if family == "msm":
        ops = cq.sweep_operands(_t(V), _t(c["x"]), _t(c["dx"]),
                                _t(c["dens"]), _t(c["fc"]))
    else:
        ops = cq.sweep_operands(_t(V), _t(c["x"]), _t(c["dx"]))
    got = trefine.refine_roots(ops, _t(roots), _t(obj), _t(wr), _t(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert np.any(np.abs(want - roots) > 1e-3)  # the windows moved roots


def test_trap_bisect_nan_keeps_staircase_root():
    """A cell whose trap sweep turns non-finite in the window keeps its
    staircase root; a finite one is refined (`tests/test_refine_root.py:
    155-175`)."""
    roots = torch.tensor([[-1.0, -2.0]], dtype=torch.float64)

    def sweep(b):
        F0 = 0.5 * (b[..., 0, 1] + 2.0)
        return torch.stack([F0, torch.full_like(F0, np.nan)], dim=-1)

    got = tsolvers.trap_bisect(sweep, roots, torch.tensor([[0.4]]), 0.5)

    def jsweep(b):
        F0 = 0.5 * (b[..., 0, 1] + 2.0)
        return jnp.stack([F0, jnp.full_like(F0, jnp.nan)], axis=-1)

    want = np.asarray(jsolvers.trap_bisect(jsweep, jnp.asarray(roots.numpy()),
                                           jnp.asarray([[0.4]]), 0.5))
    assert got[0, 1] == -2.0
    assert abs(float(got[0, 0]) - (-1.2)) < 1e-3
    np.testing.assert_array_equal(got.numpy(), want)


def _closed_form_pair(refine):
    """The 2-asset GARCH(1,1) backtest of `tests/test_refine_root.py::
    _setup` with a pinned identity-correlation Gaussian copula, in both
    packages (the port on the CPU)."""
    n_in, days = 260, 120
    rets = np.random.default_rng(7).standard_normal((n_in + days, 2))
    kw = dict(p=1, q=1, omega=0.2, alpha=np.array([0.1]),
              beta=np.array([0.7]), nll=0.0, bic=0.0,
              params=np.array([0.2, 0.1, 0.7]))
    tb = create_var_backtest(
        from_returns(rets, n_insample=n_in), "garch", "gaussian",
        num_points=100, model_fits_override=[GarchFit(**kw)] * 2,
        copula_fit_override=GaussianFit(np.eye(2), 0.0, np.zeros(1)),
        refine_root=refine, device="cpu", p_max=1, q_max=1)
    jb = JaxVaRBacktest(
        jax_from_returns(rets, n_insample=n_in), JaxGarchAdapter(1, 1),
        "gaussian", num_points=100, engine="xla",
        model_fits_override=[JaxGarchFit(**kw)] * 2,
        copula_fit_override=JaxGaussianFit(np.eye(2), 0.0, np.zeros(1)),
        refine_root=refine)
    return tb, jb


def _analytic(bt, alpha, w=None):
    """The continuous quantile under the weights pairing (weights[0]
    multiplies the last asset's forecast vol)."""
    z = float(np.asarray(jax_norm_ppf(jnp.asarray(alpha))))
    fv = bt.integration_inputs.forecast_vols.numpy()
    w = np.asarray(bt.data.weights) if w is None else w
    mean = float(np.sum(bt.data.in_sample_mean * w))
    return z * np.sqrt((fv[:, ::-1] ** 2 * w[None, :] ** 2).sum(1)) + mean


def test_refined_beats_unrefined_10x():
    """The closed-form check of `tests/test_refine_root.py` through the
    port: the refined root is 10x closer to the continuous quantile in
    the median, and equals JAX's refined root."""
    raw_bt, _ = _closed_form_pair(False)
    bt, jb = _closed_form_pair(True)
    truth = _analytic(bt, 0.05)
    raw, ref = raw_bt.calc_var(0.05), bt.calc_var(0.05)
    err_raw, err_ref = np.abs(raw - truth), np.abs(ref - truth)
    assert np.median(err_ref) < np.median(err_raw) / 10.0
    assert err_ref.max() < err_raw.max()
    np.testing.assert_allclose(ref, np.asarray(jb.calc_var(0.05)), rtol=0,
                               atol=ATOL_VAR)


def test_refined_levels_portfolios_grid_consistent():
    """calc_var_levels / calc_var_portfolios / calc_var_grid rows equal
    the refined calc_var of the same level and weights; a portfolio row
    refines with its own weights and h, as in JAX."""
    bt, jb = _closed_form_pair(True)
    levels = bt.calc_var_levels((0.01, 0.05))
    np.testing.assert_array_equal(levels[0], bt.calc_var(0.01))
    wb = np.array([[0.5, 0.5], [0.3, 0.7]])
    ports = bt.calc_var_portfolios(wb, obj_var=0.05)
    np.testing.assert_array_equal(ports[0], bt.calc_var(0.05))
    assert np.median(np.abs(ports[1] - _analytic(bt, 0.05, wb[1]))) < 3e-3
    np.testing.assert_allclose(
        ports, np.asarray(jb.calc_var_portfolios(wb, obj_var=0.05)), rtol=0,
        atol=ATOL_VAR)
    grid = bt.calc_var_grid(wb, [0.01, 0.05])
    assert grid.shape == (2, 2, 120)
    np.testing.assert_array_equal(grid[1, 1], ports[1])
    np.testing.assert_array_equal(grid[0, 0], levels[0])
    np.testing.assert_allclose(bt._plateau_h(wb), np.asarray(
        jb._plateau_h(wb)), rtol=0, atol=0)


def test_refine_needs_a_trap_twin(monkeypatch):
    """A plugin adapter (`register_adapter`) whose integration inputs are
    neither family's has no trap twin: its refined query raises, naming
    refine_root, while its unrefined one serves."""
    OtherInputs = collections.namedtuple(
        "OtherInputs", bt_mod.GarchIntegrationInputs._fields)

    class Plugin(bt_mod.GarchAdapter):
        def integration_inputs(self, *args, **kw):
            return OtherInputs(*super().integration_inputs(*args, **kw))

    monkeypatch.setattr(bt_mod, "_ADAPTERS", dict(bt_mod._ADAPTERS))
    bt_mod.register_adapter("plugin", Plugin)
    rets = np.random.default_rng(7).standard_normal((265, 2))
    fit = GarchFit(1, 1, 0.2, np.array([0.1]), np.array([0.7]), 0.0, 0.0,
                   np.array([0.2, 0.1, 0.7]))
    kw = dict(model_fits_override=[fit] * 2, device="cpu",
              copula_fit_override=GaussianFit(np.eye(2), 0.0, np.zeros(1)))
    data = from_returns(rets, n_insample=260)
    plain = create_var_backtest(data, "plugin", "gaussian", **kw)
    assert np.all(np.isfinite(plain.calc_var(0.05)))
    refined = create_var_backtest(data, "plugin", "gaussian",
                                  refine_root=True, **kw)
    with pytest.raises(ValueError, match="refine_root"):
        refined.calc_var(0.05)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_flagship_refined_record(est):
    """`data/flagship_refined_var.npz` at full size (T = 500, n = 100):
    levels, portfolios and a grid row from `load_artifacts(...,
    refine_root=True)`."""
    rec = np.load(os.path.join(DATA, "flagship_refined_var.npz"))
    data = from_csv(os.path.join(DATA, "flagship.csv"), n_insample=N_IN)
    bt = load_artifacts(os.path.join(DATA, f"flagship_artifacts_{est}.npz"),
                        data, device="cpu", refine_root=True)
    lv = bt.calc_var_levels(tuple(rec["levels"]))
    np.testing.assert_allclose(lv, rec[f"{est}_levels"], rtol=0,
                               atol=ATOL_VAR)
    pf = bt.calc_var_portfolios(rec["portfolio_weights"], rec["obj_var"])
    np.testing.assert_allclose(pf, rec[f"{est}_portfolios"], rtol=0,
                               atol=ATOL_VAR)
    row = bt.calc_var_grid(rec["portfolio_weights"][1:], [rec["obj_var"]])
    np.testing.assert_array_equal(row[0, 0], pf[1])


def test_dim3_refined_record_on_8_days(tmp_path):
    """`data/dim3_refined_var.npz` on its first 8 days at the full n = 100
    grid, MSM: levels and portfolios, cut as
    `test_torch_dim3.py::test_dim3_artifact_serves_like_jax` cuts."""
    rec = np.load(os.path.join(DATA, "dim3_refined_var.npz"))
    days, est = 8, "msm"
    z = np.load(os.path.join(DATA, f"dim3_artifacts_{est}.npz"))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos"):
        arrays[k] = arrays[k][:days]
    path = str(tmp_path / f"{est}_{days}.npz")
    np.savez(path, **arrays)
    w = np.load(os.path.join(DATA, "dim3_var.npz"))["weights"]
    full = jax_from_csv(os.path.join(DATA, "dim3.csv"), n_insample=N_IN,
                        weights=w)
    data = from_returns(full.returns[:N_IN + days], full.tickers, N_IN,
                        weights=w)
    bt = load_artifacts(path, data, device="cpu", refine_root=True)
    lv = bt.calc_var_levels(tuple(rec["levels"]))
    np.testing.assert_allclose(lv, rec[f"{est}_levels"][:, :days], rtol=0,
                               atol=ATOL_VAR)
    pf = bt.calc_var_portfolios(rec["portfolio_weights"], rec["obj_var"])
    np.testing.assert_allclose(pf, rec[f"{est}_portfolios"][:, :days],
                               rtol=0, atol=ATOL_VAR)
