"""The mean-reverting family fitted from the CSV, on the CPU:
`create_var_backtest(flagship, "mean_reverting", "student",
perturb_scale=0)` goes from `data/flagship.csv` to the VaR series and is
held against the record the JAX package wrote
(`examples/make_mean_reverting_artifacts.py`): the UKF fits against the
artifact's `meta` and against the JAX EM (a, l, q within 1e-9 relative,
LL within 1e-10 relative; at perturb_scale=0 neither side draws), the
copula against the artifact within the bounds the MSM and GARCH fits are
held to (rho 1e-6, nu 1e-2; measured 3.2e-9 and 5.4e-6), the in-sample and
integration arrays against the artifact's (rtol 1e-10), and the VaR
against `data/flagship_mr_var.npz` at atol 1e-9 with its coverage
statistics."""

import json

import numpy as np
import pytest
import torch

from copula_var_tpu.models import fit as jfit
from copula_var_tpu_torch import stats
from copula_var_tpu_torch.backtest import create_var_backtest
from copula_var_tpu_torch.data import from_csv

torch.set_num_threads(2)

RTOL_PARAMS, RTOL_LL = 1e-9, 1e-10
ATOL_RHO, ATOL_NU = 1e-6, 1e-2
RTOL_ARRAYS = 1e-10
ATOL_VAR = 1e-9
EST = "mean_reverting"


@pytest.fixture(scope="module")
def fitted():
    data = from_csv("data/flagship.csv", n_insample=1135)
    bt = create_var_backtest(data, EST, "student", num_points=100,
                             perturb_scale=0.0, seed=0, device="cpu")
    return data, bt, bt.calc_var(0.05)


def test_fits_match_the_artifact_and_jax(fitted):
    data, bt, _ = fitted
    art = np.load(f"data/flagship_artifacts_{EST}.npz")
    meta = json.loads(str(art["meta"]))
    assert meta["adapter"] == EST and meta["fit_type"] == "UkfFit"
    jax_fits = jfit.fit_ukf_em_batch(data.in_sample, max_iter=200,
                                     perturb_scale=0.0, seed=0)
    for f, m, j in zip(bt.model_fits, meta["model_fits"], jax_fits):
        for want in (m, j._asdict()):
            np.testing.assert_allclose([f.a, f.l, f.q],
                                       [want["a"], want["l"], want["q"]],
                                       rtol=RTOL_PARAMS, atol=0)
            np.testing.assert_allclose(f.log_likelihood,
                                       want["log_likelihood"], rtol=RTOL_LL,
                                       atol=0)
    c = bt.copula_fit
    np.testing.assert_allclose(c.packed_params[1:],
                               meta["copula_fit"]["packed_params"][1:],
                               rtol=0, atol=ATOL_RHO)
    assert abs(c.nu - meta["copula_fit"]["nu"]) <= ATOL_NU
    for k in art.files:
        if k == "meta":
            continue
        got = (bt.integration_inputs._asdict()[k[3:]].numpy()
               if k.startswith("ii_") else getattr(bt, k))
        np.testing.assert_allclose(got, art[k], rtol=RTOL_ARRAYS, atol=0,
                                   err_msg=k)


def test_var_reproduces_the_record(fitted):
    data, bt, var = fitted
    rec = np.load("data/flagship_mr_var.npz")
    want = rec[f"{EST}_var"]
    assert var.shape == want.shape == (500,) and np.all(np.isfinite(var))
    np.testing.assert_allclose(var, want, rtol=0, atol=ATOL_VAR)
    ptf = data.portfolio_out_sample()
    assert stats.exception_rate(ptf, var) == pytest.approx(
        float(rec[f"{EST}_exception_rate"]), abs=1e-12)
    assert stats.kupiec_pof(ptf, var, 0.05).p_value == pytest.approx(
        float(rec[f"{EST}_kupiec_p"]), abs=1e-9)
    assert set(bt.prep_stages) == {"model_fit", "marginals_densities",
                                   "copula_fit", "integration_inputs"}
