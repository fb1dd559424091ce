"""Port parity of the fits: `ops.solvers.golden_section_min`,
`ops.lbfgs.box_lbfgs_batch`, `models.fit.fit_{garch,msm}_batch` and
`copulas.fit.fit_{gaussian,student,plackett}` against the JAX package
(CPU, float64), on the same numpy-seeded data.

The optimizers differ in their trajectories (the port's own L-BFGS, its
own random stream), so the two are held to each other at the optimum;
the MSM case runs without the basin hop, which makes both sides
deterministic."""

import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax.numpy as jnp

from copula_var_tpu.copulas import fit as jcfit
from copula_var_tpu.models import fit as jfit
from copula_var_tpu.ops import lbfgs as jlbfgs
from copula_var_tpu.ops import solvers as jsolvers
from copula_var_tpu_torch.copulas import fit as tcfit
from copula_var_tpu_torch.models import fit as tfit
from copula_var_tpu_torch.ops import lbfgs as tlbfgs
from copula_var_tpu_torch.ops import solvers as tsolvers

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _garch_sim(rng, n, omega, a, b):
    y, s2 = np.zeros(n), omega / (1 - a - b)
    for t in range(n):
        y[t] = np.sqrt(s2) * rng.standard_normal()
        s2 = omega + a * y[t] ** 2 + b * s2
    return y


def _msm_sim(rng, n, m0, sigma, b, gamma, k=4):
    gj = 1 - (1 - gamma) ** (b ** np.arange(k))
    st, out = rng.random(k) < 0.5, np.zeros(n)
    for t in range(n):
        st = np.where(rng.random(k) < gj / 2, ~st, st)
        out[t] = sigma * np.sqrt(np.prod(np.where(st, 2 - m0, m0))) \
            * rng.standard_normal()
    return out - out.mean()


def _copula_data(rng, corr, n=200):
    u = norm.cdf(rng.multivariate_normal(np.zeros(len(corr)), corr, n))
    return u, rng.uniform(0.1, 0.5, u.shape)


# -- golden section and L-BFGS --------------------------------------------


def test_golden_section_matches_jax():
    centers = np.array([-0.3, 0.1, 0.77])

    def fj(x):
        return (x - jnp.tile(jnp.asarray(centers), x.shape[0] // 3)) ** 2

    def ft(x):
        return (x - _t(centers).repeat(x.shape[0] // 3)) ** 2

    lo, hi = np.full(3, -1.0), np.full(3, 1.0)
    xj, fxj = jsolvers.golden_section_min(fj, lo, hi, 90)
    xt, fxt = tsolvers.golden_section_min(ft, _t(lo), _t(hi), 90)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), centers, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fxt.numpy(), np.asarray(fxj), rtol=0,
                               atol=1e-12)
    # a few contractions: the same bracket midpoints
    xj, _ = jsolvers.golden_section_min(fj, lo, hi, 5)
    xt, _ = tsolvers.golden_section_min(ft, _t(lo), _t(hi), 5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-12)


def _rosen_j(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _rosen_t(x):
    return (1.0 - x[:, 0]) ** 2 + 100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2


@pytest.mark.parametrize("box, x0", [
    ((-2.0, 2.0), [[-1.2, 1.0], [0.0, 0.0], [1.5, -1.5]]),  # Rosenbrock
    ((-0.5, 0.5), [[0.0, 0.0], [0.3, -0.2]]),  # optimum outside the box
])
def test_box_lbfgs_matches_jax(box, x0):
    lo, hi = np.full(2, box[0]), np.full(2, box[1])
    xj, fj = jlbfgs.box_lbfgs_batch(_rosen_j, lo, hi, jnp.asarray(x0))
    xt, ft = tlbfgs.box_lbfgs_batch(_rosen_t, lo, hi, _t(x0))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    assert np.all(xt.numpy() > lo) and np.all(xt.numpy() < hi)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)


def test_box_lbfgs_penalty_plateau_matches_jax():
    """A loss that is NaN outside a disc: the line search backs off the
    PENALTY plateau and both land on the interior optimum."""
    def loss_j(x):
        return jnp.where(jnp.sum(x * x) < 1.0, jnp.sum((x - 0.3) ** 2),
                         jnp.nan)

    def loss_t(x):
        return torch.where((x * x).sum(-1) < 1.0, ((x - 0.3) ** 2).sum(-1),
                           torch.full_like(x[:, 0], np.nan))

    lo, hi = np.full(2, -2.0), np.full(2, 2.0)
    xj, _ = jlbfgs.box_lbfgs_batch(loss_j, lo, hi, jnp.zeros((1, 2)))
    xt, ft = tlbfgs.box_lbfgs_batch(loss_t, lo, hi, torch.zeros(
        1, 2, dtype=torch.float64))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    assert float(ft[0]) < tlbfgs.PENALTY
    # rows of one batch stay independent: a row started on the plateau's
    # edge does not move its neighbour
    xt2, _ = tlbfgs.box_lbfgs_batch(loss_t, lo, hi, _t([[0.0, 0.0],
                                                         [0.69, 0.69]]))
    np.testing.assert_allclose(xt2.numpy(), 0.3, rtol=0, atol=1e-6)


# -- model fits --------------------------------------------------------------


def test_fit_garch_batch_matches_jax(rng):
    r = np.stack([_garch_sim(rng, 400, 0.05, 0.1, 0.85),
                  _garch_sim(rng, 400, 0.1, 0.15, 0.7)], 1)
    want = jfit.fit_garch_batch(r, max_iter=200)
    got = tfit.fit_garch_batch(r, max_iter=200, device="cpu")
    for g, w in zip(got, want):
        assert (g.p, g.q) == (w.p, w.q)
        np.testing.assert_allclose(g.params, w.params, rtol=1e-7)
        np.testing.assert_allclose(g.nll, w.nll, rtol=1e-12)
        np.testing.assert_allclose(g.bic, w.bic, rtol=1e-12)


def test_fit_msm_batch_without_basin_hop_matches_jax(rng):
    r = np.stack([_msm_sim(rng, 300, 0.6, 1.0, 3.0, 0.3),
                  _msm_sim(rng, 300, 0.4, 1.2, 8.0, 0.5)], 1)
    want = jfit.fit_msm_batch(r, 4, basin_iter=0)
    got = tfit.fit_msm_batch(r, 4, basin_iter=0, device="cpu")
    lo = tfit.MSM_BOUNDS[:, 0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.log_likelihood, w.log_likelihood,
                                   rtol=1e-8)
        for name, bound in (("m_0", lo[0]), ("b", lo[1]), ("gamma", lo[2]),
                            ("sigma", None)):
            gv, wv = getattr(g, name), getattr(w, name)
            if bound is not None and abs(wv - bound) < 1e-6:
                assert abs(gv - wv) <= 1e-6  # pinned at the bound
            else:
                np.testing.assert_allclose(gv, wv, rtol=1e-5)


def test_fit_msm_same_seed_same_bits(rng):
    r = _msm_sim(rng, 120, 0.5, 1.0, 4.0, 0.4)[:, None]
    kw = dict(basin_iter=12, polish_max_iter=3, seed=5, device="cpu")
    a = tfit.fit_msm_batch(r, 2, **kw)
    b = tfit.fit_msm_batch(r, 2, **kw)
    assert a == b
    c = tfit.fit_msm_batch(r, 2, **dict(kw, seed=6))
    assert c != a


def test_reference_quirks_raise_naming_the_roadmap(rng):
    """The quirk trajectories, once refused here, equal JAX's on a short
    series: GARCH at rtol 1e-9, MSM at basin_iter = 0 at 1e-10."""
    r = rng.standard_normal((50, 1))
    got = tfit.fit_garch_batch(r, max_iter=60, reference_quirks=True,
                               device="cpu")[0]
    want = jfit.fit_garch_batch(r, max_iter=60, reference_quirks=True)[0]
    assert (got.p, got.q) == (want.p, want.q)
    np.testing.assert_allclose(got.params, want.params, rtol=1e-9)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-9)
    got = tfit.fit_msm_batch(r, 2, basin_iter=0, reference_quirks=True,
                             device="cpu")[0]
    want = jfit.fit_msm_batch(r, 2, basin_iter=0, reference_quirks=True)[0]
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_estimate_sigma_and_candidates_match_jax(rng):
    r = rng.standard_normal(100)
    for g, w in zip(tfit._garch_candidates(r, 3, 2),
                    jfit._garch_candidates(r, 3, 2)):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert tfit.estimate_sigma(1.7, 0.35, 4) == jfit.estimate_sigma(1.7, 0.35,
                                                                     4)


# -- copula fits -----------------------------------------------------------


def test_fit_gaussian_dim2_matches_jax(rng):
    u, d = _copula_data(rng, [[1.0, 0.5], [0.5, 1.0]])
    want, got = jcfit.fit_gaussian(u, d), tcfit.fit_gaussian(u, d,
                                                             device="cpu")
    np.testing.assert_allclose(got.corr_matrix, want.corr_matrix, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-8)
    np.testing.assert_allclose(got.packed_params, want.packed_params,
                               rtol=0, atol=1e-7)


def test_fit_gaussian_dim3_lbfgs_matches_jax(rng):
    u, d = _copula_data(rng, [[1, .3, .2], [.3, 1, .4], [.2, .4, 1.]])
    want, got = jcfit.fit_gaussian(u, d), tcfit.fit_gaussian(u, d,
                                                             device="cpu")
    np.testing.assert_allclose(got.packed_params, want.packed_params,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-8)


def test_fit_student_dim2_matches_jax(rng):
    u, d = _copula_data(rng, [[1.0, 0.6], [0.6, 1.0]], n=150)
    want = jcfit.fit_student(u, d)
    got = tcfit.fit_student(u, d, device="cpu")
    np.testing.assert_allclose(got.nu, want.nu, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.corr_matrix, want.corr_matrix, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-8)


def test_fit_student_dim3_matches_the_jax_artifact():
    """The dim-3 Student-t fit (L-BFGS per grid nu, then the nu scan) on
    the marginals and densities of the dim-3 MSM artifact, against the
    fit the JAX package saved with them: nu exact, the correlations
    within 1e-10 (measured 8.6e-14; 7.8e-12 on the GARCH artifact, which
    the card's fitted dim-3 path holds in chip_smoke.py: one artifact
    here keeps this file's CPU time in bounds)."""
    import json

    z = np.load("data/dim3_artifacts_msm.npz")
    want = json.loads(str(z["meta"]))["copula_fit"]
    got = tcfit.fit_student(z["marginals"], z["densities"], device="cpu")
    assert got.nu == want["nu"]
    np.testing.assert_allclose(got.packed_params[1:],
                               want["packed_params"][1:], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.corr_matrix, want["corr_matrix"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.nll, want["nll"], rtol=1e-12)


def test_fit_plackett_matches_jax(rng):
    """On theta in (0.5, 2), where the reference's denominator has no
    pole on [0, 1]^2 (outside it the NLL dives to -inf next to the poles
    and the scan's winner is rounding)."""
    u, d = _copula_data(rng, [[1.0, 0.15], [0.15, 1.0]])
    rng_theta = [0.6, 1.2, 1.9]
    want = jcfit.fit_plackett(u, d, theta_range=rng_theta)
    got = tcfit.fit_plackett(u, d, theta_range=rng_theta, device="cpu")
    np.testing.assert_allclose(got.theta, want.theta, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-8)
    assert 0.6 < got.theta < 1.9


@pytest.mark.parametrize("tol", [None, 1e-3, 1e-9])
def test_gs_iters_matches_jax(tol):
    for span, default in ((1.98, 90), (23.1, 28)):
        assert tcfit._gs_iters(span, tol, default) == jcfit._gs_iters(
            span, tol, default)
