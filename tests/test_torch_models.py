"""Port parity: `copula_var_tpu_torch.models.{garch,msm}` and
`ops.grids` against the JAX package (CPU, float64), on the same
numpy-seeded inputs."""

import numpy as np
import pytest
import torch

from copula_var_tpu.models import garch as jgarch
from copula_var_tpu.models import msm as jmsm
from copula_var_tpu.ops import grids as jgrids
from copula_var_tpu_torch.models import garch as tgarch
from copula_var_tpu_torch.models import msm as tmsm
from copula_var_tpu_torch.ops import grids as tgrids

torch.set_num_threads(2)

RTOL_GARCH = 1e-12
RTOL_MSM = 1e-11
N_MSM = 300

GARCH_CASES = [
    (0.05, [0.1], [0.85]),
    (0.03, [0.12, 0.05], [0.7]),
    (0.02, [0.08], [0.3, 0.2, 0.35]),
    (0.04, [0.05, 0.04, 0.03], [0.4, 0.3]),
]


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("num_points", [50, 100, 173])
@pytest.mark.parametrize("kind", ["MSM", "GARCH"])
def test_grids_equal(kind, num_points):
    for box in ((-5.0, 5.0), (-6.0, 4.5)):
        want = jgrids.grid_for(jgrids.GridSpecKind[kind], num_points, *box)
        got = tgrids.grid_for(tgrids.GridSpecKind[kind], num_points, *box)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("case", range(len(GARCH_CASES)))
def test_garch_matches_jax(rng, case):
    """Variances, LL, residuals and the one-step forecast; at p, q > 1
    the forecast's pairing quirk (alpha[i] with returns[-p + i])."""
    omega, alpha, beta = GARCH_CASES[case]
    a, b = np.array(alpha), np.array(beta)
    r = rng.standard_normal(400) * 1.3
    args_j = (r, omega, a, b)
    args_t = (_t(r), omega, _t(a), _t(b))
    _close(tgarch.conditional_variances(*args_t),
           jgarch.conditional_variances(*args_j), RTOL_GARCH)
    _close(tgarch.log_likelihood(*args_t), jgarch.log_likelihood(*args_j),
           RTOL_GARCH)
    _close(tgarch.standardized_residuals(*args_t),
           jgarch.standardized_residuals(*args_j), RTOL_GARCH)
    _close(tgarch.forecast_vol(*args_t), jgarch.forecast_vol(*args_j),
           RTOL_GARCH)
    # end-zero-padded rows with the true lag counts
    ap, bp = np.zeros(3), np.zeros(3)
    ap[:len(a)], bp[:len(b)] = a, b
    _close(tgarch.forecast_vol_padded(_t(r), _t(omega), _t(ap), _t(bp),
                                      len(a), len(b)),
           jgarch.forecast_vol_padded(r, omega, ap, bp, len(a), len(b)),
           RTOL_GARCH)


def test_garch_batched_forms_match_jax(rng):
    r = rng.standard_normal(300)
    omega = np.array([0.05, 0.02, 0.1])
    alpha = np.array([[0.1, 0.0], [0.05, 0.05], [0.2, 0.1]])
    beta = np.array([[0.8], [0.85], [0.5]])
    _close(tgarch.log_likelihood_batch(_t(r), _t(omega), _t(alpha),
                                       _t(beta)),
           jgarch.log_likelihood_batch(r, omega, alpha, beta), RTOL_GARCH)
    windows = np.stack([rng.standard_normal(200) for _ in range(6)])
    _close(tgarch.forecast_vol_windows(_t(windows), 0.05, _t([0.1, 0.05]),
                                       _t([0.8])),
           jgarch.forecast_vol_windows(windows, 0.05, np.array([0.1, 0.05]),
                                       np.array([0.8])), RTOL_GARCH)
    # assets x windows with padded rows and per-asset lag counts
    ap = np.array([[0.1, 0.0], [0.05, 0.07]])
    bp = np.array([[0.8, 0.0], [0.3, 0.5]])
    pq = (np.array([1, 2]), np.array([1, 2]))
    got = tgarch.forecast_vol_padded(
        _t(np.stack([windows, windows[::-1]])), _t([[0.05], [0.03]]),
        _t(ap[:, None]), _t(bp[:, None]), torch.tensor(pq[0])[:, None],
        torch.tensor(pq[1])[:, None])
    for i, w in enumerate((windows, windows[::-1])):
        want = [jgarch.forecast_vol_padded(row, [0.05, 0.03][i], ap[i], bp[i],
                                           pq[0][i], pq[1][i]) for row in w]
        _close(got[i], want, RTOL_GARCH)


def _msm_params(k):
    return (k, 0.62, 1.15, 2.5, 0.35)


@pytest.mark.parametrize("k", [4, 8])  # dense (k <= 6) and Kronecker
def test_msm_filter_and_likelihood_match_jax(rng, k):
    r = rng.standard_normal(N_MSM) * 1.2
    args = _msm_params(k)
    js, jc, jl, jv = jmsm.filter_states(*args, r)
    ts, tc, tl, tv = tmsm.filter_states(*args, _t(r))
    _close(ts, js, RTOL_MSM)
    _close(tc, jc, RTOL_MSM)
    _close(tl, jl, RTOL_MSM)
    assert bool(tv) == bool(jv)
    _close(tmsm.log_likelihood(*args, _t(r)), jmsm.log_likelihood(*args, r),
           RTOL_MSM)
    jm, je, jvs = jmsm.marginals(*args, r)
    tm, te, tvs = tmsm.marginals(*args, _t(r))
    for g, w in ((tm, jm), (te, je), (tvs, jvs)):
        _close(g, w, RTOL_MSM)
    _close(tmsm.densities(*args, _t(r)), jmsm.densities(*args, r), RTOL_MSM)
    _close(tmsm.forecast_state_distribution(*args, _t(r)),
           jmsm.forecast_state_distribution(*args, r), RTOL_MSM)


@pytest.mark.parametrize("k", [4, 8])
def test_msm_batched_forms_match_jax(rng, k):
    r = rng.standard_normal(N_MSM)
    m0 = np.array([0.3, 0.55, 0.8])
    sigma = np.array([0.9, 1.0, 1.3])
    b = np.array([1.0, 6.0, 40.0])
    gm = np.array([0.05, 0.5, 0.95])
    _close(tmsm.log_likelihood_batch(k, _t(m0), _t(sigma), _t(b), _t(gm),
                                     _t(r)),
           jmsm.log_likelihood_batch(k, m0, sigma, b, gm, r), RTOL_MSM)
    windows = np.stack([rng.standard_normal(150) for _ in range(5)])
    args = _msm_params(k)
    want = jmsm.forecast_windows(*args, windows)
    _close(tmsm.forecast_windows(*args, _t(windows)), want, RTOL_MSM)
    # one parameter set per asset (A, 1) against windows (A, T, N): the
    # shared-transition path
    got = tmsm.forecast_windows(k, _t([[0.62], [0.4]]), _t([[1.15], [0.8]]),
                                _t([[2.5], [9.0]]), _t([[0.35], [0.2]]),
                                _t(np.stack([windows, windows[::-1]])))
    _close(got[0], want, RTOL_MSM)
    _close(got[1], jmsm.forecast_windows(k, 0.4, 0.8, 9.0, 0.2,
                                         windows[::-1]), RTOL_MSM)


@pytest.mark.parametrize("k", [3, 7])
def test_msm_state_space_matches_jax(k):
    _close(tmsm.state_components(k, _t(0.7)), jmsm.state_components(k, 0.7),
           0)
    _close(tmsm.component_stay_probs(k, _t(3.0), _t(0.4)),
           jmsm.component_stay_probs(k, 3.0, 0.4), RTOL_MSM)
    _close(tmsm.transition_matrix(k, _t(3.0), _t(0.4)),
           jmsm.transition_matrix(k, 3.0, 0.4), RTOL_MSM)
    _close(tmsm.vol_states(k, _t(0.7), _t(1.1)), jmsm.vol_states(k, 0.7, 1.1),
           RTOL_MSM)
    v = np.random.default_rng(1).uniform(size=(4, 2**k))
    p = jmsm.component_stay_probs(k, 3.0, 0.4)
    _close(tmsm.kron_transition_matvec(_t(p), _t(v)),
           jmsm.kron_transition_matvec(p, v), RTOL_MSM)


def test_msm_dense_and_kronecker_agree(rng):
    r = _t(rng.standard_normal(200))
    args = _msm_params(4)
    dense = tmsm.log_likelihood(*args, r, dense=True)
    kron = tmsm.log_likelihood(*args, r, dense=False)
    _close(kron, dense, RTOL_MSM)


def test_msm_filter_guard_holds_state_and_likelihood_is_minus_inf(rng):
    """A return no state vol can produce (every normalizer term
    underflows): the filter keeps the previous state there, the log-norm
    is -inf, the filter is invalid and the LL -inf, as in JAX."""
    r = rng.standard_normal(60)
    r[30] = 1e4
    args = _msm_params(4)
    js, _, jl, jv = jmsm.filter_states(*args, r)
    ts, _, tl, tv = tmsm.filter_states(*args, _t(r))
    assert not bool(jv) and not bool(tv)
    assert np.isneginf(np.asarray(tl)[30]) and np.isneginf(np.asarray(jl)[30])
    _close(ts, js, RTOL_MSM)
    assert np.array_equal(ts[30].numpy(), ts[29].numpy())
    assert np.isneginf(float(tmsm.log_likelihood(*args, _t(r))))
    assert np.isneginf(float(jmsm.log_likelihood(*args, r)))
