"""Port parity for the fitting and file side of the four-asset (dim 4)
path on the CPU, against the JAX package on the same numpy inputs: the
Gaussian and Student IFM copula fits at dim 4 on the committed record's
in-sample marginals (six correlations by `box_lbfgs_batch` from x0 = 0.5),
`save_artifacts` / `load_artifacts` of the JAX-written dim-4 files, and
`config.run_backtest` at dim 4 on a cut of `data/dim4.csv`. The serving
side is `tests/test_torch_dim4.py`."""

import json
import os

import numpy as np
import pytest
import torch

from copula_var_tpu import config as jcfg
from copula_var_tpu.copulas import fit as jcfit
from copula_var_tpu.data import from_csv as jax_from_csv
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
from copula_var_tpu_torch import config as tcfg
from copula_var_tpu_torch.copulas import fit as tcfit
from copula_var_tpu_torch.data import from_returns
from copula_var_tpu_torch.ops import tcached as tc
from copula_var_tpu_torch.utils.artifacts import load_artifacts, save_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
CSV = os.path.join(DATA, "dim4.csv")
N_IN = 1135
ATOL_ROOT = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
WEIGHTS = np.array([0.4, 0.3, 0.2, 0.1])
# the fitted state within these moves no VaR day (chip_smoke.py's bounds)
FIT_ATOL_RHO, FIT_ATOL_NU = 1e-6, 1e-2


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
    full = jax_from_csv(CSV, n_insample=N_IN, weights=WEIGHTS)
    rets = full.returns[: N_IN + days]
    return (path, jax_from_returns(rets, full.tickers, N_IN, weights=WEIGHTS),
            from_returns(rets, full.tickers, N_IN, weights=WEIGHTS))


def _meta(est):
    z = np.load(os.path.join(DATA, f"dim4_artifacts_{est}.npz"))
    return z, json.loads(str(z["meta"]))


def test_student_fit_dim4_holds_the_artifact():
    """Six correlations by `box_lbfgs_batch` from x0 = 0.5 on the GARCH
    artifact's in-sample marginals: held to the JAX-written fit."""
    z, meta = _meta("garch")
    got = tcfit.fit_student(z["marginals"], z["densities"], device="cpu")
    want = meta["copula_fit"]
    assert got.corr_matrix.shape == (4, 4)
    np.testing.assert_allclose(got.packed_params[1:],
                               want["packed_params"][1:], rtol=0,
                               atol=FIT_ATOL_RHO)
    assert abs(got.nu - want["nu"]) <= FIT_ATOL_NU
    np.testing.assert_allclose(got.nll, want["nll"], rtol=1e-9)


def test_gaussian_fit_dim4_matches_jax():
    z, _ = _meta("msm")
    got = tcfit.fit_gaussian(z["marginals"], z["densities"], device="cpu")
    want = jcfit.fit_gaussian(z["marginals"], z["densities"])
    np.testing.assert_allclose(got.packed_params,
                               np.asarray(want.packed_params), rtol=0,
                               atol=FIT_ATOL_RHO)
    np.testing.assert_allclose(got.nll, float(want.nll), rtol=1e-9)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_artifacts_round_trip_dim4(tmp_path, est):
    """A JAX-written dim-4 file loads in the port, saves again, and both
    packages read the port's file back to the same state."""
    path, jdata, tdata = _truncated(tmp_path, est, 2)
    tb = load_artifacts(path, tdata, device="cpu")
    out = str(tmp_path / f"again_{est}.npz")
    save_artifacts(out, tb)
    a, b = np.load(path), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
    for k in a.files:
        if k != "meta":
            np.testing.assert_array_equal(a[k], b[k])
    again = load_artifacts(out, tdata, device="cpu")
    np.testing.assert_array_equal(again.calc_var(0.05), tb.calc_var(0.05))
    np.testing.assert_allclose(again.calc_var(0.05),
                               np.asarray(jax_load(out, jdata).calc_var(0.05)),
                               rtol=0, atol=ATOL_ROOT)


def test_run_backtest_dim4_equals_jax():
    """`config.run_backtest` at dim 4 through both packages on a cut of
    `data/dim4.csv`: GARCH (p, q <= 1), Gaussian copula, n = 16, two
    levels."""
    cut_n, cut_t = 300, 4
    full = jax_from_csv(CSV, n_insample=N_IN)
    rets = full.returns[:cut_n + cut_t]
    cfgs = [mod.BacktestConfig(estimation_type="garch", copula_type="gaussian",
                               n_insample=cut_n, num_points=16)
            for mod in (tcfg, jcfg)]
    for c in cfgs:
        c.garch.p_max = c.garch.q_max = 1
        c.solver.obj_levels = (0.025, 0.05)
    bt, var = tcfg.run_backtest(
        from_returns(rets, full.tickers, cut_n, weights=WEIGHTS),
        cfgs[0], device="cpu")
    _, jvar = jcfg.run_backtest(
        jax_from_returns(rets, full.tickers, cut_n, weights=WEIGHTS),
        cfgs[1])
    assert var.shape == (2, cut_t) and np.all(np.isfinite(var))
    assert isinstance(bt.sweep_operands(), tc.ColumnOperands)
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=0, atol=ATOL_ROOT)
