"""Port parity: `copula_var_tpu_torch.models.ukf` (the filter and its
batched forms) against the JAX package on the CPU (float64), on the same
numpy-seeded inputs; the simulators of `models/{garch,msm,ukf}` and
`data.synthetic_dataset`; and the UKF EM's refusal of a point it cannot
leave.

Tolerances:
  * filter outputs rtol 1e-12 (the state mean also atol 1e-13: it is a
    log-vol that crosses zero); XLA and PyTorch round the sigma-point sums
    differently, and the filter is contractive, so the gap stays at ulps;
  * `simulate_from_draws` rtol 1e-13: the same recursion on the same
    draws;
  * the random simulators by moments over 64 series of 2000 steps, each
    bound about 5 standard deviations of its batch mean (measured over 20
    seeds: GARCH sd 0.026, MSM 0.010, OU 0.045); the streams are torch's,
    not JAX's.
"""

import numpy as np
import pytest
import torch

from copula_var_tpu.data import synthetic_dataset as jax_synthetic
from copula_var_tpu.models import garch as jgarch
from copula_var_tpu.models import ukf as jukf
from copula_var_tpu_torch.data import from_csv, synthetic_dataset
from copula_var_tpu_torch.models import fit as tfit
from copula_var_tpu_torch.models import garch as tgarch
from copula_var_tpu_torch.models import msm as tmsm
from copula_var_tpu_torch.models import ukf as tukf

torch.set_num_threads(2)

RTOL = 1e-12
ATOL_STATE = 1e-13
RTOL_DRAWS = 1e-13
BATCH, STEPS = 64, 2000

PARAMS = [  # (a, l, q): the flagship optimum, the synthetic OU, the EM init
    (0.978, 0.04, 0.055),
    (0.95, -0.2, 0.2),
    (0.99, 0.5, 0.1),
    (0.6, 0.3, 0.5),
]


def _ou_series(rng, n, a=0.97, l=0.1, q=0.15):  # noqa: E741
    x = np.empty(n)
    x[0] = l
    for t in range(1, n):
        x[t] = a * (x[t - 1] - l) + l + q * rng.standard_normal()
    return np.exp(x) * rng.standard_normal(n)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _same_filter(got, want):
    means, variances, ll, fc, valid = got
    j_means, j_vars, j_ll, j_fc, j_valid = want
    _close(means, j_means, atol=ATOL_STATE)
    _close(variances, j_vars)
    _close(ll, j_ll)
    _close(fc, j_fc)
    assert np.array_equal(np.asarray(valid), np.asarray(j_valid))


@pytest.mark.parametrize("case", range(len(PARAMS)))
def test_filter_matches_jax(rng, case):
    a, l, q = PARAMS[case]  # noqa: E741
    r = _ou_series(rng, 500)
    _same_filter(tukf.filter_series(torch.tensor(r), a, l, q),
                 jukf.filter_series(r, a, l, q))
    # explicit initial state (the defaults are init_log_vol = l and
    # init_var = q, not q^2)
    _same_filter(
        tukf.filter_series(torch.tensor(r), a, l, q, init_log_vol=-0.3,
                           init_var=q * q),
        jukf.filter_series(r, a, l, q, init_log_vol=-0.3, init_var=q * q))
    t = torch.tensor(r)
    _close(tukf.log_likelihood(t, a, l, q), jukf.log_likelihood(r, a, l, q))
    _close(tukf.vol_path(t, a, l, q), jukf.vol_path(r, a, l, q))
    _close(tukf.standardized_residuals(t, a, l, q),
           jukf.standardized_residuals(r, a, l, q))
    _close(tukf.forecast_vol(t, a, l, q), jukf.forecast_vol(r, a, l, q))


def test_forecast_is_the_last_prior_mean(rng):
    """`forecast` is the last step's predicted mean a (m - l) + l
    (weighted over the sigma points), not the posterior."""
    r = _ou_series(rng, 200)
    means, _, _, fc, _ = tukf.filter_series(torch.tensor(r), 0.95, 0.1, 0.2)
    _, _, _, j_fc, _ = jukf.filter_series(r, 0.95, 0.1, 0.2)
    _close(fc, j_fc)
    assert float(fc) != float(means[-1])


@pytest.mark.parametrize("where", [0, 37, 199])
def test_invalid_step_flags_the_series(rng, where):
    """A return no sigma point can explain (Z < 1e-10) skips its step,
    marks the series invalid and sets LL to FAIL_LL, as in JAX; a NaN
    return does the same."""
    r = _ou_series(rng, 200)
    r[where] = 1e6
    got = tukf.filter_series(torch.tensor(r), 0.95, 0.1, 0.2)
    _same_filter(got, jukf.filter_series(r, 0.95, 0.1, 0.2))
    assert float(got[2]) == tukf.FAIL_LL and not bool(got[4])
    r[where] = np.nan
    got = tukf.filter_series(torch.tensor(r), 0.95, 0.1, 0.2)
    assert float(got[2]) == tukf.FAIL_LL and not bool(got[4])
    assert np.isfinite(got[0].numpy()).all()


def test_batched_forms_match_jax(rng):
    """Candidate rows on one series, and rolling windows: of one series
    under one parameter set, and of every asset at once (parameters
    (A, 1) against windows (A, T, N)), on a cut of the flagship."""
    r = _ou_series(rng, 400)
    a = rng.uniform(0.8, 0.99, 6)
    l = rng.uniform(-0.3, 0.3, 6)  # noqa: E741
    q = rng.uniform(0.05, 0.3, 6)
    _close(tukf.log_likelihood_batch(torch.tensor(r), torch.tensor(a),
                                     torch.tensor(l), torch.tensor(q)),
           jukf.log_likelihood_batch(r, a, l, q))
    data = from_csv("data/flagship.csv", n_insample=1135)
    ret = data.returns[:320]
    idx = np.arange(300)[None, :] + np.arange(20)[:, None]
    windows = ret[idx] - ret[:300].mean(0)  # (T, N, A)
    fits = [(0.978, 0.04, 0.055), (0.985, 0.068, 0.063)]
    for i, (a_i, l_i, q_i) in enumerate(fits):
        _close(tukf.forecast_vol_windows(torch.tensor(windows[..., i]), a_i,
                                         l_i, q_i),
               jukf.forecast_vol_windows(windows[..., i], a_i, l_i, q_i))
    p = torch.tensor(fits, dtype=torch.float64)
    both = tukf.forecast_vol_windows(
        torch.tensor(np.moveaxis(windows, -1, 0).copy()), p[:, :1],
        p[:, 1:2], p[:, 2:])
    for i, (a_i, l_i, q_i) in enumerate(fits):
        _close(both[i], jukf.forecast_vol_windows(windows[..., i], a_i, l_i,
                                                  q_i))


def test_em_raises_where_jax_spins():
    """At perturb_scale=0 an invalid E-step would be perturbed by 0 for
    ever (the JAX loop never ends there); the port raises, naming the
    cause. A valid asset beside it does not save the fit."""
    r = np.random.default_rng(1).standard_normal((120, 2))
    r[60, 1] = 1e6
    with pytest.raises(RuntimeError, match="perturb_scale=0"):
        tfit.fit_ukf_em_batch(r, perturb_scale=0.0, max_iter=20,
                              device="cpu")


# -- simulators ----------------------------------------------------------------

@pytest.mark.parametrize("omega, alpha, beta", [
    (0.02, [0.08], [0.9]),
    (0.03, [0.12, 0.05], [0.7]),
    (0.02, [0.08], [0.3, 0.2, 0.35]),
])
def test_garch_simulate_from_draws_matches_jax(rng, omega, alpha, beta):
    n = 300
    draws = rng.standard_normal(n + max(len(alpha), len(beta)) - 1)
    got = tgarch.simulate_from_draws(torch.tensor(draws), omega,
                                     torch.tensor(alpha, dtype=torch.float64),
                                     torch.tensor(beta, dtype=torch.float64),
                                     n)
    want = jgarch.simulate_from_draws(draws, omega, np.array(alpha),
                                      np.array(beta), n)
    for g, w in zip(got, want):
        assert g.shape == (n,)
        _close(g, w, rtol=RTOL_DRAWS)


def test_garch_params_and_validation():
    p = tgarch.GarchParams(0.02, [0.08], [0.9])
    assert p._fields == jgarch.GarchParams._fields
    tgarch.validate_params(0.02, [0.08], [0.9])
    for bad in ((0.02, [0.0], [0.9]), (0.02, [0.1], [-0.1]),
                (0.0, [0.1], [0.8]), (0.02, [0.5], [0.5])):
        with pytest.raises(ValueError) as got:
            tgarch.validate_params(*bad)
        with pytest.raises(ValueError) as want:
            jgarch.validate_params(*bad)
        assert str(got.value) == str(want.value)


def test_garch_simulate_moments():
    y, s2, eps = tgarch.simulate(0, torch.full((BATCH,), 0.02, dtype=torch.float64),
                                 torch.full((BATCH, 1), 0.08, dtype=torch.float64),
                                 torch.full((BATCH, 1), 0.9, dtype=torch.float64), STEPS,
                                 device="cpu")
    assert y.shape == s2.shape == eps.shape == (BATCH, STEPS)
    _close(y, eps * torch.sqrt(s2), rtol=1e-15)
    # the recursion holds on the path: s2_t = omega + alpha y_{t-1}^2
    # + beta s2_{t-1}
    _close(s2[:, 1:], 0.02 + 0.08 * y[:, :-1] ** 2 + 0.9 * s2[:, :-1],
           rtol=1e-14)
    assert abs(float((y * y).mean()) - 1.0) < 0.15  # unconditional var 1
    assert abs(float(eps.var()) - 1.0) < 0.02
    again, _, _ = tgarch.simulate(0, 0.02, [0.08], [0.9], 50, device="cpu")
    assert torch.equal(again, tgarch.simulate(0, 0.02, [0.08], [0.9], 50,
                                              device="cpu")[0])


def test_msm_simulate_moments():
    k, m0, sigma, b, gamma = 4, 0.4, 1.0, 3.0, 0.5
    r, vol, eps, comps = tmsm.simulate(0, k, torch.full((BATCH,), m0, dtype=torch.float64), sigma,
                                       b, gamma, STEPS, device="cpu")
    assert r.shape == vol.shape == eps.shape == (BATCH, STEPS)
    assert comps.shape == (BATCH, STEPS + 1, k)
    assert bool(((comps == m0) | (comps == 2.0 - m0)).all())
    _close(vol, sigma * torch.sqrt(torch.prod(comps[:, 1:], -1)), rtol=1e-15)
    _close(r, vol * eps, rtol=1e-15)
    # component j switches with probability gamma_j / 2 per step
    gamma_j = 1.0 - (1.0 - gamma) ** (b ** np.arange(k))
    rate = (comps[:, 1:] != comps[:, :-1]).double().mean((0, 1)).numpy()
    np.testing.assert_allclose(rate, gamma_j / 2.0, atol=0.01)
    assert abs(float((r * r).mean()) - sigma**2) < 0.06
    assert tmsm.MsmParams._fields == ("m_0", "sigma", "b", "gamma")


def test_ukf_simulate_moments():
    a, l, q = 0.95, -0.2, 0.2  # noqa: E741
    X, vol, r = tukf.simulate(0, torch.full((BATCH,), a, dtype=torch.float64), l, q, STEPS,
                              device="cpu")
    assert X.shape == vol.shape == r.shape == (BATCH, STEPS)
    assert bool((X[:, 0] == l).all())
    _close(vol, torch.exp(X), rtol=1e-15)
    w = (X[:, 1:] - (a * (X[:, :-1] - l) + l)) / q  # the N(0, 1) draws
    assert abs(float(w.mean())) < 0.02 and abs(float(w.var()) - 1.0) < 0.02
    stationary = np.exp(2 * l + 2 * q * q / (1 - a * a))  # E[r^2] = 1.523
    assert abs(float((r * r).mean()) - stationary) < 0.25
    assert tukf.UkfParams._fields == jukf.UkfParams._fields


def test_synthetic_dataset():
    spec = ("garch", "msm", "ou")
    d = synthetic_dataset(0, 1635, 1135, spec=spec, device="cpu")
    j = jax_synthetic(__import__("jax").random.PRNGKey(0), 1635, 1135,
                      spec=spec)
    assert d.returns.shape == j.returns.shape == (1635, 3)
    assert d.tickers == j.tickers and d.n_insample == j.n_insample == 1135
    np.testing.assert_array_equal(d.weights, j.weights)
    assert np.all(np.isfinite(d.returns))
    again = synthetic_dataset(0, 1635, 1135, spec=spec, device="cpu")
    np.testing.assert_array_equal(d.returns, again.returns)
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        synthetic_dataset(gen, 1635, 1135, spec=spec, device="cpu").returns,
        d.returns)
    assert not np.array_equal(d.returns[:, 0], d.returns[:, 1])
    with pytest.raises(ValueError, match="unknown synthetic asset spec"):
        synthetic_dataset(0, 100, 50, spec=("arma",), device="cpu")
