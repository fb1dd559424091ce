"""The fitted slice as a whole, on the CPU: `create_var_backtest` from
returns to a VaR series, held against the flagship artifacts and record,
against the JAX package's `create_var_backtest`, and through saved
artifacts in both directions. The mean-reverting family is served here
from its record's artifacts (`data/flagship_artifacts_mean_reverting.npz`,
`data/flagship_mr_var.npz`); its fit from the CSV is held in
tests/test_torch_mean_reverting.py."""

import json

import numpy as np
import pytest
import torch

from copula_var_tpu.backtest import create_var_backtest as jax_create
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
from copula_var_tpu.utils.artifacts import save_artifacts as jax_save
from copula_var_tpu_torch import backtest as bt_mod
from copula_var_tpu_torch.backtest import create_var_backtest
from copula_var_tpu_torch.copulas import fit as cfit_mod
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.models import fit as mfit_mod
from copula_var_tpu_torch.ops.quadrature import CopulaSpec
from copula_var_tpu_torch.utils.artifacts import (
    _restore,
    load_artifacts,
    save_artifacts,
)

torch.set_num_threads(2)

N_IN = 1135  # the flagship's in-sample days
ATOL_VAR = 1e-9
RTOL_ARRAYS = 1e-11
# the cut: N in-sample days and T out-of-sample days of data/flagship.csv
CUT_N, CUT_T = 300, 20


def _record(est):
    """The (T,) VaR the JAX package recorded for the flagship under est."""
    path = ("data/flagship_mr_var.npz" if est == "mean_reverting"
            else "data/flagship_var.npz")
    return np.load(path)[f"{est}_var"]


def _meta_fits(est):
    z = np.load(f"data/flagship_artifacts_{est}.npz")
    meta = json.loads(str(z["meta"]))
    fits = [getattr(mfit_mod, meta["fit_type"])(
        **{k: _restore(v) for k, v in f.items()}) for f in meta["model_fits"]]
    cfit = getattr(cfit_mod, meta["copula_fit_type"])(
        **{k: _restore(v) for k, v in meta["copula_fit"].items()})
    return z, fits, cfit


@pytest.mark.parametrize("est", ["msm", "garch", "mean_reverting"])
def test_overridden_fits_reproduce_artifacts_and_record(est):
    """From the artifacts' fitted parameters, the port's marginals,
    densities and integration inputs equal the saved arrays and the VaR
    series equals the flagship record."""
    z, fits, cfit = _meta_fits(est)
    data = from_csv("data/flagship.csv", n_insample=N_IN)
    bt = create_var_backtest(data, est, "student", model_fits_override=fits,
                             copula_fit_override=cfit, device="cpu")
    for k, v in bt.integration_inputs._asdict().items():
        np.testing.assert_allclose(v.numpy(), z[f"ii_{k}"], rtol=RTOL_ARRAYS,
                                   atol=0)
    np.testing.assert_allclose(bt.marginals, z["marginals"], rtol=RTOL_ARRAYS)
    np.testing.assert_allclose(bt.densities, z["densities"], rtol=RTOL_ARRAYS)
    var = bt.calc_var(0.05)
    diff = np.abs(var - _record(est))
    assert diff.max() <= ATOL_VAR and int(np.sum(diff > 1e-9)) == 0
    assert set(bt.prep_stages) == {"model_fit", "marginals_densities",
                                   "copula_fit", "integration_inputs"}
    assert bt.prep_seconds >= sum(bt.prep_stages.values())


def _cut_returns():
    data = from_csv("data/flagship.csv", n_insample=N_IN)
    return data.returns[:CUT_N + CUT_T], data.tickers


@pytest.fixture(scope="module")
def fitted_pairs():
    """{est: (port backtest, JAX backtest)} fitted on the cut: MSM without
    the basin hop (deterministic on both sides), GARCH as it is."""
    returns, tickers = _cut_returns()
    pairs = {}
    for est, kw in (("msm", {"k": 4, "basin_iter": 0}), ("garch", {})):
        tdata = from_returns(returns, tickers=tickers, n_insample=CUT_N)
        jdata = jax_from_returns(returns, tickers=tickers, n_insample=CUT_N)
        pairs[est] = (create_var_backtest(tdata, est, "student", device="cpu",
                                          **kw),
                      jax_create(jdata, est, "student", **kw))
    return pairs


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_fitted_cut_equals_jax(fitted_pairs, est):
    bt, jbt = fitted_pairs[est]
    var, jvar = bt.calc_var(0.05), np.asarray(jbt.calc_var(0.05))
    assert var.shape == (CUT_T,) and np.all(np.isfinite(var))
    np.testing.assert_allclose(var, jvar, rtol=0, atol=ATOL_VAR)
    np.testing.assert_allclose(bt.copula_fit.nu, jbt.copula_fit.nu, rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(bt.copula_fit.corr_matrix,
                               jbt.copula_fit.corr_matrix, rtol=0, atol=1e-6)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_saved_artifacts_load_across_packages(fitted_pairs, est, tmp_path):
    """The port's save_artifacts loads in the JAX package and the JAX
    package's in the port, each serving the same VaR."""
    bt, jbt = fitted_pairs[est]
    returns, tickers = _cut_returns()
    p_port, p_jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_artifacts(str(p_port), bt)
    jax_save(str(p_jax), jbt)
    from_port = jax_load(str(p_port), jax_from_returns(
        returns, tickers=tickers, n_insample=CUT_N))
    from_jax = load_artifacts(str(p_jax), from_returns(
        returns, tickers=tickers, n_insample=CUT_N), device="cpu")
    assert from_port.model_fits[0]._fields == bt.model_fits[0]._fields
    np.testing.assert_allclose(np.asarray(from_port.calc_var(0.05)),
                               bt.calc_var(0.05), rtol=0, atol=ATOL_VAR)
    np.testing.assert_allclose(from_jax.calc_var(0.05),
                               np.asarray(jbt.calc_var(0.05)), rtol=0,
                               atol=ATOL_VAR)
    z_port, z_jax = np.load(p_port), np.load(p_jax)
    assert sorted(z_port.files) == sorted(z_jax.files)
    assert json.loads(str(z_port["meta"])).keys() == json.loads(
        str(z_jax["meta"])).keys()


def test_defaults_to_the_card_and_rejects_unported(monkeypatch):
    returns, tickers = _cut_returns()
    data = from_returns(returns, tickers=tickers, n_insample=CUT_N)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_var_backtest(data, "garch", "student")
    refined = create_var_backtest(data, "mean_reverting", "gaussian",
                                  device="cpu", refine_root=True,
                                  perturb_scale=0.0)
    want = jax_create(
        jax_from_returns(returns, tickers=tickers, n_insample=CUT_N),
        "mean_reverting", "gaussian", perturb_scale=0.0, refine_root=True)
    np.testing.assert_allclose(refined.calc_var(0.05), want.calc_var(0.05),
                               rtol=0, atol=ATOL_VAR)
    with pytest.raises(ValueError, match="estimation type"):
        create_var_backtest(data, "arma", "gaussian", device="cpu")
    with pytest.raises(ValueError, match="copula type"):
        create_var_backtest(data, "garch", "clayton", device="cpu")


def test_registered_adapter_and_copula(monkeypatch):
    """register_adapter / register_copula plug into create_var_backtest:
    a copula registered as the Gaussian fit under another name serves the
    same VaR as "gaussian"."""
    monkeypatch.setattr(bt_mod, "_ADAPTERS", dict(bt_mod._ADAPTERS))
    monkeypatch.setattr(bt_mod, "_COPULA_FITTERS",
                        dict(bt_mod._COPULA_FITTERS))
    monkeypatch.setattr(bt_mod, "_COPULA_SPEC_BUILDERS", {})
    bt_mod.register_adapter("garch2", bt_mod.GarchAdapter)
    bt_mod.register_copula(
        "gauss2", cfit_mod.fit_gaussian,
        lambda fit, device: CopulaSpec("gaussian", (torch.as_tensor(
            fit.corr_matrix, dtype=torch.float64, device=device),)))
    returns, tickers = _cut_returns()
    data = from_returns(returns[:CUT_N + 5], tickers=tickers,
                        n_insample=CUT_N)
    _, fits, _ = _meta_fits("garch")
    a = create_var_backtest(data, "garch2", "gauss2", device="cpu",
                            model_fits_override=fits)
    b = create_var_backtest(data, "garch", "gaussian", device="cpu",
                            model_fits_override=fits)
    np.testing.assert_array_equal(a.calc_var(0.05), b.calc_var(0.05))


def test_mean_reverting_artifacts_round_trip_with_jax(tmp_path):
    """The JAX-written mean-reverting file serves the record in the port
    at full T, and the port's file of the same state serves it in the JAX
    package, with the JAX file's keys."""
    data = from_csv("data/flagship.csv", n_insample=N_IN)
    want = _record("mean_reverting")
    art = "data/flagship_artifacts_mean_reverting.npz"
    bt = load_artifacts(art, data, device="cpu")
    assert isinstance(bt.adapter, bt_mod.MeanRevertingAdapter)
    assert type(bt.model_fits[0]).__name__ == "UkfFit"
    np.testing.assert_allclose(bt.calc_var(0.05), want, rtol=0,
                               atol=ATOL_VAR)
    path = tmp_path / "port_mr.npz"
    save_artifacts(str(path), bt)
    jdata = jax_from_returns(data.returns, tickers=data.tickers,
                             n_insample=N_IN)
    from_port = jax_load(str(path), jdata)
    assert type(from_port.adapter).__name__ == "MeanRevertingAdapter"
    np.testing.assert_allclose(np.asarray(from_port.calc_var(0.05)), want,
                               rtol=0, atol=ATOL_VAR)
    z_port, z_jax = np.load(path), np.load(art)
    assert sorted(z_port.files) == sorted(z_jax.files)
    assert json.loads(str(z_port["meta"])) == json.loads(str(z_jax["meta"]))
