"""Port parity: the UKF EM (`models/fit.py::fit_ukf_em_batch`) on the
flagship in-sample (1135 x 2) against the JAX package on the CPU.

  * The frozen-a quirk (`reference_quirks=True`) at perturb_scale=0,
    where neither side draws: a, l, q within 1e-9 relative and the LL
    within 1e-10 relative. (The default M-step at perturb_scale=0 is held
    in tests/test_torch_mean_reverting.py, through the fitted backtest.)
  * The default EM (perturb_scale=0.05, seed 0) draws from a different
    stream on each side, so it is held by its LL: asset 1 ends at the
    same optimum (1e-10 relative); asset 2 within 0.3 of JAX's LL. The
    JAX EM's own optima for asset 2 at seeds 0 and 1 differ by 0.264
    (-2428.2124 and -2428.4763); the port's seed 0 measured -2428.2252.
"""

import numpy as np
import torch

from copula_var_tpu.models import fit as jfit
from copula_var_tpu_torch.data import from_csv
from copula_var_tpu_torch.models import fit as tfit

torch.set_num_threads(2)

RTOL_PARAMS, RTOL_LL = 1e-9, 1e-10
ATOL_LL_STREAM = 0.3
MAX_ITER = 200  # the adapter's em_max_iter


def _in_sample():
    return from_csv("data/flagship.csv", n_insample=1135).in_sample


def test_em_frozen_a_quirk_matches_jax():
    r = _in_sample()
    kw = dict(perturb_scale=0.0, max_iter=MAX_ITER, reference_quirks=True)
    got = tfit.fit_ukf_em_batch(r, device="cpu", **kw)
    want = jfit.fit_ukf_em_batch(r, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.a, g.l, g.q], [w.a, w.l, w.q],
                                   rtol=RTOL_PARAMS, atol=0)
        np.testing.assert_allclose(g.log_likelihood, w.log_likelihood,
                                   rtol=RTOL_LL, atol=0)
    # the quirk is a different optimum from the textbook M-step's
    plain = jfit.fit_ukf_em_batch(r, perturb_scale=0.0, max_iter=MAX_ITER)
    assert abs(got[0].a - plain[0].a) > 1e-4


def test_default_em_held_by_its_log_likelihood():
    r = _in_sample()
    got = tfit.fit_ukf_em_batch(r, max_iter=MAX_ITER, seed=0, device="cpu")
    want = jfit.fit_ukf_em_batch(r, max_iter=MAX_ITER, seed=0)
    np.testing.assert_allclose(got[0].log_likelihood,
                               want[0].log_likelihood, rtol=RTOL_LL, atol=0)
    assert abs(got[1].log_likelihood - want[1].log_likelihood) \
        <= ATOL_LL_STREAM
    for f in got:
        assert 0.5 <= f.a <= 0.999999 and f.q > 0 and np.isfinite(f.l)
    # one generator per asset, seeded seed + i: asset 0 alone draws what
    # it draws in the panel (its filter rounds differently in a batch of
    # one, hence a relative bound, not bits)
    alone = tfit.fit_ukf_em(r[:, 0], max_iter=MAX_ITER, seed=0, device="cpu")
    np.testing.assert_allclose(alone, got[0], rtol=RTOL_PARAMS, atol=0)
