"""Port parity: `copula_var_tpu_torch.copulas.{common,gaussian,student,
plackett}` against the JAX package (CPU, float64), on the same
numpy-seeded inputs.

Student values are held at 1e-9, not 1e-12: JAX's `betaln` errs by up to
~5e-8 at large nu (ROADMAP.md section 3), which the port's `t_ppf` does
not, and the transform carries that into the density."""

import numpy as np
import pytest
import torch

from copula_var_tpu.copulas import common as jcommon
from copula_var_tpu.copulas import gaussian as jgauss
from copula_var_tpu.copulas import plackett as jplack
from copula_var_tpu.copulas import student as jstud
from copula_var_tpu_torch.copulas import common as tcommon
from copula_var_tpu_torch.copulas import gaussian as tgauss
from copula_var_tpu_torch.copulas import plackett as tplack
from copula_var_tpu_torch.copulas import student as tstud

torch.set_num_threads(2)

RTOL = 1e-12
RTOL_STUDENT = 1e-9
CORR3 = np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.45], [-0.2, 0.45, 1.0]])


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


def _ifm_inputs(rng, n=300, d=2):
    u = rng.uniform(0.002, 0.998, (n, d))
    u[:5] = rng.uniform(1e-9, 1e-6, (5, d))  # tails
    dens = rng.uniform(0.05, 0.6, (n, d))
    return u, dens


@pytest.mark.parametrize("rho", [-0.7, 0.0, 0.6, 0.95])
def test_gaussian_density_and_nll_match_jax(rng, rho):
    u, dens = _ifm_inputs(rng)
    corr = np.array([[1.0, rho], [rho, 1.0]])
    _close(tgauss.copula_density(_t(u), _t(corr)),
           jgauss.copula_density(u, corr), RTOL)
    _close(tgauss.ifm_log_likelihood(_t(u), _t(dens), _t(corr)),
           jgauss.ifm_log_likelihood(u, dens, corr), RTOL)
    _close(tgauss.negative_log_likelihood(_t([rho]), _t(u), _t(dens), 2),
           jgauss.negative_log_likelihood(np.array([rho]), u, dens, 2), RTOL)


def test_gaussian_dim3_and_row_batch_match_jax(rng):
    u, dens = _ifm_inputs(rng, n=150, d=3)
    _close(tgauss.copula_density(_t(u), _t(CORR3)),
           jgauss.copula_density(u, CORR3), RTOL)
    rows = np.array([[0.3, -0.2, 0.45], [0.1, 0.2, 0.3], [0.5, 0.5, -0.4]])
    want = [jgauss.negative_log_likelihood(r, u, dens, 3) for r in rows]
    _close(tgauss.negative_log_likelihood(_t(rows), _t(u), _t(dens), 3),
           want, RTOL)


@pytest.mark.parametrize("theta", [0.6, 1.0, 1.7, 4.0])
def test_plackett_density_and_nll_match_jax(rng, theta):
    u, dens = _ifm_inputs(rng)
    _close(tplack.copula_density(_t(u), theta),
           jplack.copula_density(u, theta), RTOL)
    _close(tplack.negative_log_likelihood(_t([theta, 2.0]), _t(u),
                                          _t(dens))[0],
           jplack.negative_log_likelihood(theta, u, dens), RTOL)


def test_plackett_rejects_non_bivariate(rng):
    with pytest.raises(ValueError, match="2-dimensional"):
        tplack.copula_density(_t(rng.uniform(size=(4, 3))), 2.0)


@pytest.mark.parametrize("nu", [3.0, 11.2, 44.4])
def test_student_density_and_nll_match_jax(rng, nu):
    u, dens = _ifm_inputs(rng, n=200)
    corr = np.array([[1.0, 0.55], [0.55, 1.0]])
    _close(tstud.copula_density(_t(u), nu, _t(corr)),
           jstud.copula_density(u, nu, corr), RTOL_STUDENT)
    _close(tstud.ifm_log_likelihood(_t(u), _t(dens), nu, _t(corr)),
           jstud.ifm_log_likelihood(u, dens, nu, corr), RTOL_STUDENT)
    params = np.array([nu, 0.55])
    _close(tstud.negative_log_likelihood(_t(params), _t(u), _t(dens), 2),
           jstud.negative_log_likelihood(params, u, dens, 2), RTOL_STUDENT)


def test_student_transform_and_loss_from_transform_match_jax(rng):
    u, dens = _ifm_inputs(rng, n=200, d=3)
    nus = np.array([4.0, 25.0])
    z, fin, lus = tstud.precompute_transform(_t(u), _t(nus))
    lds = float(np.sum(np.log(dens)))
    rho = np.array([0.3, -0.2, 0.45])
    for i, nu in enumerate(nus):
        jz, jfin, jlus = jstud.precompute_transform(u, nu)
        _close(z[i], jz, RTOL_STUDENT)
        assert np.array_equal(fin[i].numpy(), np.asarray(jfin))
        _close(lus[i], jlus, RTOL_STUDENT)
        _close(tstud.negative_log_likelihood_from_transform(
            _t(rho), z[i], fin[i], lus[i], _t(nu), lds, 3),
            jstud.negative_log_likelihood_from_transform(
                rho, jz, jfin, jlus, nu, lds, 3), RTOL_STUDENT)
    _close(tstud.copula_density(_t(u), 6.0, _t(CORR3)),
           jstud.copula_density(u, 6.0, CORR3), RTOL_STUDENT)


def test_student_density_nan_on_saturated_marginals(rng):
    u, _ = _ifm_inputs(rng, n=20)
    u[3, 0], u[7, 1] = 1.0, 0.0
    corr = np.array([[1.0, 0.4], [0.4, 1.0]])
    got = tstud.copula_density(_t(u), 5.0, _t(corr)).numpy()
    want = np.asarray(jstud.copula_density(u, 5.0, corr))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]) and np.isnan(got[7])


def test_penalty_plateau(rng):
    """Non-PD or non-finite correlations, and non-finite Plackett NLLs,
    return PENALTY in both packages."""
    u, dens = _ifm_inputs(rng, n=100)
    for rho in (1.5, -1.2, np.nan):
        assert float(tgauss.negative_log_likelihood(
            _t([rho]), _t(u), _t(dens), 2)) == tcommon.PENALTY == float(
            jgauss.negative_log_likelihood(np.array([rho]), u, dens, 2))
        assert float(tstud.negative_log_likelihood(
            _t([5.0, rho]), _t(u), _t(dens), 2)) == tcommon.PENALTY == float(
            jstud.negative_log_likelihood(np.array([5.0, rho]), u, dens, 2))
    # rows of one batch: the penalized row does not touch its neighbour
    got = tgauss.negative_log_likelihood(_t([[0.3], [1.5]]), _t(u),
                                         _t(dens), 2).numpy()
    assert got[1] == tcommon.PENALTY
    _close(got[0], jgauss.negative_log_likelihood(np.array([0.3]), u, dens,
                                                  2), RTOL)
    u_bad = u.copy()
    # on a pole of the reference's denominator at theta 9: u + v = 9/8
    u_bad[0] = [0.5625, 0.5625]
    assert float(tplack.negative_log_likelihood(_t([9.0]), _t(u_bad),
                                                _t(dens))) == tcommon.PENALTY
    assert float(jplack.negative_log_likelihood(9.0, u_bad, dens)) == \
        tcommon.PENALTY


@pytest.mark.parametrize("dim", [2, 3, 5])
def test_corr_packing_round_trip_and_fill_order(rng, dim):
    n_par = dim * (dim - 1) // 2
    p = rng.uniform(-0.4, 0.4, (3, n_par))
    mat = tcommon.corr_matrix_from_params(_t(p), dim)
    for i in range(3):
        assert np.array_equal(mat[i].numpy(), np.asarray(
            jcommon.corr_matrix_from_params(p[i], dim)))
    assert np.array_equal(tcommon.params_from_corr_matrix(mat).numpy(), p)
    assert tcommon.dim_from_n_params(n_par) == dim
    with pytest.raises(ValueError):
        tcommon.dim_from_n_params(n_par + 1)


def test_is_positive_definite_matches_jax():
    mats = np.stack([np.eye(3), CORR3,
                     np.array([[1.0, 0.9, 0.9], [0.9, 1.0, -0.9],
                               [0.9, -0.9, 1.0]])])
    got = tcommon.is_positive_definite(_t(mats)).numpy()
    want = [bool(jcommon.is_positive_definite(m)) for m in mats]
    assert got.tolist() == want == [True, True, False]
