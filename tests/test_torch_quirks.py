"""Port parity for the `reference_quirks` fit trajectories on the CPU:
the GARCH finite-difference Newton of the reference optimizer
(`models/fit.py::_garch_reference_trajectories`, every asset and pair in
lockstep) and the MSM minimum-LL selection without polish, against the
JAX package's quirk paths; then `config.run_backtest` with the quirk
flags, and the flagship quirk record `data/flagship_quirk_fits.npz`."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu import config as jcfg
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.models import fit as jfit
from copula_var_tpu_torch import config as tcfg
from copula_var_tpu_torch.backtest import (
    GarchAdapter,
    MsmAdapter,
    create_var_backtest,
)
from copula_var_tpu_torch.copulas.fit import StudentFit
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.models import fit as tfit

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
N_IN = 1135
ATOL_VAR = 1e-9
CUT_N, CUT_T = 300, 20  # as tests/test_torch_fit_path.py


def _garch_series(rng, n=300):
    """GARCH(1,1)-like data (`tests/test_quirk_fits.py:132-139`)."""
    vol, r, v = np.empty(n), np.empty(n), 1.0
    for t in range(n):
        v = 0.05 + 0.1 * (r[t - 1] ** 2 if t else 1.0) + 0.85 * v
        vol[t] = np.sqrt(v)
        r[t] = vol[t] * rng.standard_normal()
    return r


def _jax_stencil(returns_2d):
    """The injected stencil evaluator: JAX's own batched `_garch_nll`
    program on each pair's rows, as the JAX trajectory calls it."""
    def nll_rows(x, asset, p, q):
        out, i = np.empty(len(x)), 0
        p_max = (x.shape[1] - 1) // 2  # the tests use p_max == q_max
        while i < len(x):
            j = i
            while j < len(x) and (asset[j], p[j], q[j]) == (asset[i], p[i],
                                                           q[i]):
                j += 1
            pp, qq = int(p[i]), int(q[i])
            pts = np.concatenate([x[i:j, :1 + pp],
                                  x[i:j, 1 + p_max:1 + p_max + qq]], 1)
            out[i:j] = np.asarray(jfit._garch_nll_batch_program(pp)(
                jnp.asarray(pts), jnp.asarray(returns_2d[:, asset[i]])))
            i = j
        return out

    return nll_rows


def _check_garch(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.p, g.q) == (w.p, w.q)
        np.testing.assert_allclose(g.params, w.params, rtol=rtol)
        np.testing.assert_allclose([g.nll, g.bic], [w.nll, w.bic], rtol=rtol)


@pytest.fixture(scope="module")
def garch_case():
    """Two series (the test series and its reversal) and JAX's quirk
    fit of each, p, q <= 2, max_iter 60."""
    r = _garch_series(np.random.default_rng(0))
    panel = np.stack([r, r[::-1]], axis=1)
    want = [jfit.fit_garch(panel[:, i].copy(), p_max=2, q_max=2, tol=1e-10,
                           max_iter=60, reference_quirks=True)
            for i in range(2)]
    return panel, want


def test_garch_trajectory_with_jax_nll_injected(garch_case):
    """The lockstep trajectory, fed JAX's NLL values, walks JAX's
    trajectory: every asset's pair, params, nll and bic at rtol 1e-12."""
    panel, want = garch_case
    got = tfit.fit_garch_batch(panel, p_max=2, q_max=2, tol=1e-10,
                               max_iter=60, reference_quirks=True,
                               device="cpu", nll_rows=_jax_stencil(panel))
    _check_garch(got, want, 1e-12)


def test_garch_trajectory_free_running(garch_case):
    """The same trajectory on the port's own NLL: the FD Hessian divides
    ~1e-7 NLL differences by eps^2, and still the fit holds at 1e-9."""
    panel, want = garch_case
    got = tfit.fit_garch_batch(panel, p_max=2, q_max=2, tol=1e-10,
                               max_iter=60, reference_quirks=True,
                               device="cpu")
    _check_garch(got, want, 1e-9)
    one = tfit.fit_garch(panel[:, 1], p_max=2, q_max=2, tol=1e-10,
                         max_iter=60, reference_quirks=True, device="cpu")
    _check_garch([one], want[1:], 1e-9)


def test_garch_trajectory_skips_a_failed_pair():
    """A pair whose pinv fails (NaN stencil values) is skipped, as
    `opti.py:110-112` skips it; the other pairs still select."""
    def nll_rows(x, asset, p, q):
        vals = np.sum(x * x, axis=1)
        return np.where(p == 2, np.nan, vals)

    fits = tfit._garch_reference_trajectories(100, 1, 2, 1, 1e-10, 5, 1e-5,
                                              nll_rows)
    assert fits[0] is not None and fits[0].p == 1
    none = tfit._garch_reference_trajectories(
        100, 1, 1, 1, 1e-10, 5, 1e-5, lambda x, *a: np.full(len(x), np.nan))
    assert none == [None]


def test_msm_quirk_at_basin_iter_0():
    """No polish and the minimum final LL of the starts: params and LL at
    rtol 1e-10 against JAX; the defect shows against the default."""
    rng = np.random.default_rng(5)
    n = 400
    vol = 1.0 + 0.5 * np.abs(np.sin(np.arange(n) / 23.0))
    panel = rng.standard_normal((n, 2)) * vol[:, None]
    want = jfit.fit_msm_batch(panel, 2, basin_iter=0, reference_quirks=True)
    got = tfit.fit_msm_batch(panel, 2, basin_iter=0, reference_quirks=True,
                             device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.m_0, g.b, g.gamma, g.sigma],
                                   [w.m_0, w.b, w.gamma, w.sigma], rtol=1e-10)
        np.testing.assert_allclose(g.log_likelihood, w.log_likelihood,
                                   rtol=1e-10)
    fixed = tfit.fit_msm_batch(panel, 2, basin_iter=0, polish_max_iter=0,
                               device="cpu")
    assert all(f.log_likelihood > g.log_likelihood
               for f, g in zip(fixed, got))


def test_adapters_take_the_quirk_flags():
    rng = np.random.default_rng(2)
    panel = np.stack([_garch_series(rng, 200) for _ in range(2)], axis=1)
    got = GarchAdapter(p_max=1, q_max=1, reference_quirks=True).fit(
        panel, device="cpu")
    want = jfit.fit_garch_batch(panel, p_max=1, q_max=1, max_iter=200,
                                reference_quirks=True)
    _check_garch(got, want, 1e-9)
    got = MsmAdapter(k=2, basin_iter=0, reference_quirks=True).fit(
        panel, device="cpu")
    want = jfit.fit_msm_batch(panel, 2, basin_iter=0, reference_quirks=True)
    np.testing.assert_allclose([g.log_likelihood for g in got],
                               [w.log_likelihood for w in want], rtol=1e-10)


def _cut():
    data = from_csv(os.path.join(DATA, "flagship.csv"), n_insample=N_IN)
    return data.returns[:CUT_N + CUT_T], data.tickers


@pytest.mark.parametrize("est", ["garch", "msm"])
def test_run_backtest_with_quirk_flags_equals_jax(est):
    """`run_backtest` with the config's quirk flag on a 300-day cut
    (GARCH p, q <= 2; MSM k = 2 at basin_iter = 0; a Gaussian copula):
    the fits and the VaR equal JAX's."""
    returns, tickers = _cut()
    cfgs = [mod.BacktestConfig(estimation_type=est, copula_type="gaussian",
                               n_insample=CUT_N) for mod in (tcfg, jcfg)]
    for c in cfgs:
        if est == "garch":
            c.garch.p_max = c.garch.q_max = 2
            c.garch.newton_max_iter = 60
            c.garch.reference_quirks = True
        else:
            c.msm.k, c.msm.basin_iter = 2, 0
            c.msm.reference_quirks = True
    bt, var = tcfg.run_backtest(
        from_returns(returns, tickers=tickers, n_insample=CUT_N), cfgs[0],
        device="cpu")
    jbt, jvar = jcfg.run_backtest(
        jax_from_returns(returns, tickers=tickers, n_insample=CUT_N),
        cfgs[1])
    for f, w in zip(bt.model_fits, jbt.model_fits):
        if est == "garch":
            _check_garch([f], [w], 1e-9)
        else:
            np.testing.assert_allclose(f.log_likelihood, w.log_likelihood,
                                       rtol=1e-10)
    assert var.shape == (CUT_T,) and np.all(np.isfinite(var))
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=0, atol=ATOL_VAR)


def test_flagship_quirk_record():
    """`data/flagship_quirk_fits.npz` on the CPU: the GARCH quirk fits of
    both flagship assets (p, q <= 3, the adapter's defaults) at rtol
    1e-9 (nll 1e-10), the MSM quirk fits (k = 4, basin_iter = 0) at
    1e-9 (LL 1e-10), and the quirk pipeline's VaR from the recorded fits
    at 1e-9."""
    rec = np.load(os.path.join(DATA, "flagship_quirk_fits.npz"))
    data = from_csv(os.path.join(DATA, "flagship.csv"), n_insample=N_IN)
    gfits = GarchAdapter(reference_quirks=True).fit(data.in_sample,
                                                    device="cpu")
    for i, f in enumerate(gfits):
        assert (f.p, f.q) == (rec["garch_p"][i], rec["garch_q"][i])
        np.testing.assert_allclose(f.params,
                                   rec["garch_params"][i][:len(f.params)],
                                   rtol=1e-9)
        np.testing.assert_allclose(f.nll, rec["garch_nll"][i], rtol=1e-10)
    mfits = tfit.fit_msm_batch(data.in_sample, int(rec["k"]),
                               basin_iter=int(rec["basin_iter"]),
                               reference_quirks=True, device="cpu")
    np.testing.assert_allclose([[f.m_0, f.b, f.gamma, f.sigma]
                                for f in mfits], rec["msm_params"],
                               rtol=1e-9)
    np.testing.assert_allclose([f.log_likelihood for f in mfits],
                               rec["msm_ll"], rtol=1e-10)
    packed = rec["quirk_copula_packed"]
    cfit = StudentFit(float(rec["quirk_copula_nu"]),
                      np.array([[1.0, packed[1]], [packed[1], 1.0]]),
                      float("nan"), packed)
    bt = create_var_backtest(data, "garch", "student",
                             num_points=int(rec["num_points"]),
                             model_fits_override=gfits,
                             copula_fit_override=cfit, device="cpu",
                             reference_quirks=True)
    bt.reference_quirks = True
    var = bt.calc_var(float(rec["obj_var"]))
    np.testing.assert_allclose(var, rec["garch_quirk_var"], rtol=0,
                               atol=ATOL_VAR)
