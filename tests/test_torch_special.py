"""Port parity: `copula_var_tpu_torch.ops.special` against the JAX package
(CPU, float64), on the inputs of tests/test_special.py and wider."""

import numpy as np
import pytest
import scipy.special
import torch
from jax.scipy.special import betainc as jax_betainc

from copula_var_tpu.ops import special as jsp
from copula_var_tpu_torch.ops import special as tsp

torch.set_num_threads(2)

RTOL = 1e-12
# t_ppf stops Newton once its step is below 500 eps (|x| + 1)
# (copula_var_tpu/ops/special.py:204-207): each implementation freezes
# anywhere inside that gate around the root, so two of them may differ by
# twice it in absolute terms.
PPF_ATOL = 2 * 500 * np.finfo(np.float64).eps


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def test_betainc_matches_jax(rng):
    a = rng.uniform(0.05, 40.0, 3000)
    b = rng.uniform(0.05, 40.0, 3000)
    x = rng.uniform(0.0, 1.0, 3000)
    x[:20], x[20:40] = 0.0, 1.0
    x[40:80] = 10.0 ** rng.uniform(-30, -5, 40)
    x[80:120] = 1.0 - 10.0 ** rng.uniform(-15, -5, 40)
    b[120:160] = 0.5  # the t-distribution case
    got = tsp.betainc(_t(a), _t(b), _t(x)).numpy()
    want = np.asarray(jax_betainc(a, b, x))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_betainc_edges_match_jax():
    a = np.array([0.0, 1.0, 2.0, -1.0, 1.0, np.nan, 3.0, 0.0])
    b = np.array([1.0, 0.0, 2.0, 1.0, -1.0, 1.0, 3.0, 0.0])
    x = np.array([0.3, 0.3, 1.5, 0.5, 0.5, 0.5, 0.0, 0.2])
    got = tsp.betainc(_t(a), _t(b), _t(x)).numpy()
    want = np.asarray(jax_betainc(a, b, x))
    np.testing.assert_array_equal(got, want)


def test_norm_functions_match_jax(rng):
    x = rng.normal(size=(64, 3)) * 3
    p = rng.uniform(1e-12, 1 - 1e-12, size=500)
    np.testing.assert_allclose(tsp.norm_pdf(_t(x)).numpy(),
                               np.asarray(jsp.norm_pdf(x)), rtol=RTOL)
    np.testing.assert_allclose(tsp.norm_pdf(_t(x), std=0.37).numpy(),
                               np.asarray(jsp.norm_pdf(x, std=0.37)),
                               rtol=RTOL)
    np.testing.assert_allclose(tsp.norm_cdf(_t(x)).numpy(),
                               np.asarray(jsp.norm_cdf(x)), rtol=RTOL)
    np.testing.assert_allclose(tsp.norm_ppf(_t(p)).numpy(),
                               np.asarray(jsp.norm_ppf(p)), rtol=RTOL)
    tail = np.linspace(-37.0, 8.0, 901)  # deep lower tail down to ~1e-300
    np.testing.assert_allclose(tsp.norm_cdf(_t(tail)).numpy(),
                               np.asarray(jsp.norm_cdf(tail)), rtol=RTOL)


def test_betaln_matches_scipy():
    """betaln is lgamma(a) + lgamma(b) - lgamma(a + b). It is held
    against scipy here because JAX's betaln errs by up to ~5e-8 for
    a = nu/2 >= ~15, b = 1/2 (see the deep-tail tests below)."""
    a = np.array([1.005, 1.25, 2.0, 6.0, 15.0, 22.2, 25.0, 40.0])
    got = tsp.betaln(_t(a), _t(np.full_like(a, 0.5))).numpy()
    np.testing.assert_allclose(got, scipy.special.betaln(a, 0.5), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("nu", [2.01, 2.5, 5.0, 10.0, 30.0, 50.0])
def test_t_logpdf_sf_cdf_match_jax(rng, nu):
    x = np.concatenate([rng.normal(size=300) * 5,
                        10.0 ** rng.uniform(0, 120, 60),
                        -(10.0 ** rng.uniform(0, 120, 60)), [0.0]])
    np.testing.assert_allclose(tsp.t_logpdf(_t(x), nu).numpy(),
                               np.asarray(jsp.t_logpdf(x, nu)), rtol=RTOL)
    # lanes past z = nu / (nu + x^2) < 1e-8 take the log-series branch,
    # which subtracts betaln(nu/2, 1/2): JAX's is off by up to 5e-8 at
    # nu = 30 (test_betaln_matches_scipy), so those lanes are held at
    # 1e-7; results below 1e-300 are subnormal or flushed to 0 by either
    deep = nu / (nu + x * x) < 1e-8
    for port, jax_fn, xs in ((tsp.t_sf, jsp.t_sf, x),
                             (tsp.t_cdf, jsp.t_cdf, -x)):
        got = port(_t(xs), nu).numpy()
        want = np.asarray(jax_fn(xs, nu))
        np.testing.assert_allclose(got[~deep], want[~deep], rtol=RTOL,
                                   atol=0)
        np.testing.assert_allclose(got[deep], want[deep], rtol=1e-7,
                                   atol=1e-300)


@pytest.mark.parametrize("nu", [2.01, 3.0, 10.0, 50.0])
def test_t_ppf_body_and_tails_match_jax(rng, nu):
    p = np.concatenate([
        rng.uniform(0.001, 0.999, size=400),
        10.0 ** rng.uniform(-60, -3, size=200),
        1 - 10.0 ** rng.uniform(-15, -3, 200),
        0.5 + np.array([1e-5, -2e-4, 3.1e-4, -3.5e-4, 1e-3]),  # central cut
    ])
    got = tsp.t_ppf(_t(p), nu).numpy()
    want = np.asarray(jsp.t_ppf(p, nu))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=PPF_ATOL)


@pytest.mark.parametrize("nu", [2.01, 4.0, 12.0, 50.0])
def test_t_ppf_deep_tail(rng, nu):
    """p down to 1e-250, where t_ppf leaves betainc for the log series.
    That branch subtracts betaln(nu/2, 1/2), which JAX computes with an
    error of ~7e-9 at nu = 50 (test_betaln_matches_scipy). A log-survival
    error e moves the quantile by e / nu relative, so the JAX comparison
    is held at 2e-10. The ppf-cdf round trip is held at 1e-10, the bound
    tests/test_special.py holds the JAX package to: the Newton gate
    leaves ~500 eps relative in x, which the cdf multiplies by nu."""
    p = 10.0 ** rng.uniform(-250, -50, size=100)
    got = tsp.t_ppf(_t(p), nu)
    assert torch.all(torch.isfinite(got)) and torch.all(got < 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsp.t_ppf(p, nu)),
                               rtol=2e-10)
    np.testing.assert_allclose(tsp.t_cdf(got, nu).numpy(), p, rtol=1e-10)


def test_t_ppf_edges_match_jax():
    p = np.array([0.0, 0.5, 1.0, -0.1, 1.1])
    got = tsp.t_ppf(_t(p), 5.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsp.t_ppf(p, 5.0)))
    assert got[0] == -np.inf and got[2] == np.inf and got[1] == 0.0
    assert np.isnan(got[3:]).all()
