"""The port's serving path as a whole, on the CPU: returns ingestion
without pandas, `load_artifacts` -> `calc_var*` against the JAX package
and against the committed flagship record, and the package's import and
device rules."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from copula_var_tpu import stats as jstats
from copula_var_tpu.data import from_csv as jax_from_csv
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
from copula_var_tpu_torch import stats as tstats
from copula_var_tpu_torch.backtest import GarchAdapter, MsmAdapter
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.device import resolve_device
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.utils.artifacts import load_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
CSV = os.path.join(DATA, "flagship.csv")
N_IN = 1135
ATOL_ROOT = 1e-9  # tests/test_flagship.py:63


def _artifact(est):
    return os.path.join(DATA, f"flagship_artifacts_{est}.npz")


def _truncated(tmp_path, est, days):
    """The flagship artifact cut to its first `days` out-of-sample days,
    and matching returns for both packages."""
    z = np.load(_artifact(est))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos",
              "ii_forecast_vols"):
        if k in arrays:
            arrays[k] = arrays[k][:days]
    path = str(tmp_path / f"{est}_{days}.npz")
    np.savez(path, **arrays)
    full = jax_from_csv(CSV, n_insample=N_IN)
    rets = full.returns[: N_IN + days]
    return (path, jax_from_returns(rets, full.tickers, N_IN),
            from_returns(rets, full.tickers, N_IN))


def test_from_csv_is_byte_equal_to_pandas_reader():
    got, want = from_csv(CSV, n_insample=N_IN), jax_from_csv(CSV, N_IN)
    assert got.returns.tobytes() == want.returns.tobytes()
    assert got.tickers == want.tickers and got.n_insample == N_IN
    np.testing.assert_array_equal(got.dates, want.dates)
    assert got.ptf_mean == want.ptf_mean


def test_from_csv_drops_rows_with_missing_prices(tmp_path):
    path = tmp_path / "gaps.csv"
    path.write_text("date,A,B\n2020-01-01,100.0,50.0\n2020-01-02,,51.0\n"
                    "2020-01-03,101.5,52.25\n2020-01-06,102.0,\n"
                    "2020-01-07,103.125,53.0\n")
    got, want = from_csv(str(path), 1), jax_from_csv(str(path), 1)
    assert got.returns.tobytes() == want.returns.tobytes()
    # the JAX reader keeps the dates of dropped rows (misaligned with its
    # returns); the port keeps them aligned
    np.testing.assert_array_equal(got.dates, ["2020-01-03", "2020-01-07"])


def test_stats_match_jax_package(rng):
    ptf = rng.standard_normal(500)
    var = np.full(500, -1.6) + 0.1 * rng.standard_normal(500)
    assert tstats.exception_rate(ptf, var) == jstats.exception_rate(ptf, var)
    assert tstats.kupiec_pof(ptf, var, 0.05) == jstats.kupiec_pof(ptf, var,
                                                                  0.05)
    assert tstats.christoffersen_conditional_coverage(ptf, var, 0.05) == \
        jstats.christoffersen_conditional_coverage(ptf, var, 0.05)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_truncated_artifact_levels_and_grid_match_jax(tmp_path, est):
    """JAX load_artifacts(...).calc_var_levels / .calc_var_grid (f64
    `xla` engine) against the port's, on the flagship artifact cut to 12
    days."""
    path, jdata, tdata = _truncated(tmp_path, est, 12)
    jb, tb = jax_load(path, jdata), load_artifacts(path, tdata)
    levels = [0.01, 0.025, 0.05]
    np.testing.assert_allclose(tb.calc_var_levels(levels),
                               jb.calc_var_levels(levels), rtol=0,
                               atol=ATOL_ROOT)
    wb = np.array([[0.3, 0.7], [0.8, 0.2], [0.5, 0.5]])
    got = tb.calc_var_grid(wb, [0.01, 0.05])
    assert got.shape == (3, 2, 12)
    np.testing.assert_allclose(got, jb.calc_var_grid(wb, [0.01, 0.05]),
                               rtol=0, atol=ATOL_ROOT)
    bounds = np.stack([np.full(12, -100.0), np.full(12, -3.0)], -1)
    np.testing.assert_allclose(tb.compute_integral(bounds),
                               jb.compute_integral(bounds), rtol=1e-12)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_flagship_var_series_reproduces(est):
    """The port's eager main path from the committed flagship artifacts
    reproduces the committed f64 VaR series (written by the JAX `xla`
    engine) at the record's own bar, and its coverage statistics."""
    rec = np.load(os.path.join(DATA, "flagship_var.npz"))
    data = from_csv(CSV, n_insample=N_IN)
    bt = load_artifacts(_artifact(est), data)
    var = bt.calc_var(float(rec["obj_var"]))
    np.testing.assert_allclose(var, rec[f"{est}_var"], rtol=0,
                               atol=ATOL_ROOT)
    ptf = data.portfolio_out_sample()
    np.testing.assert_allclose(tstats.exception_rate(ptf, var),
                               float(rec[f"{est}_exception_rate"]),
                               atol=1e-12)
    kup = tstats.kupiec_pof(ptf, var, float(rec["obj_var"]))
    np.testing.assert_allclose(kup.p_value, float(rec[f"{est}_kupiec_p"]),
                               atol=1e-9)


def test_portfolio_rows_equal_single_portfolio_solves(tmp_path):
    """Row l of a batch equals calc_var of a backtest carrying weights[l],
    to the bisection tolerance: the batch runs until its widest bracket
    converges, so a row may take extra halvings (as in JAX)."""
    path, _, tdata = _truncated(tmp_path, "msm", 8)
    wb = np.array([[0.3, 0.7], [0.8, 0.2]])
    rows = load_artifacts(path, tdata).calc_var_portfolios(wb, [0.05, 0.01])
    for w, a, row in zip(wb, [0.05, 0.01], rows):
        single = from_returns(tdata.returns, tdata.tickers, N_IN, weights=w)
        np.testing.assert_allclose(
            load_artifacts(path, single).calc_var(a), row, rtol=0,
            atol=1e-6)


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports and solves with `jax` unimportable, and pulls in
    nothing of the JAX package."""
    path, _, _ = _truncated(tmp_path, "garch", 6)
    code = f"""
import sys
sys.modules["jax"] = None
import numpy as np
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.utils.artifacts import load_artifacts
full = from_csv({CSV!r}, n_insample={N_IN})
data = from_returns(full.returns[:{N_IN + 6}], full.tickers, {N_IN})
var = load_artifacts({path!r}, data).calc_var(0.05)
assert var.shape == (6,) and np.all(np.isfinite(var)), var
leaked = [m for m, mod in sys.modules.items() if mod is not None
          and m.split(".")[0] in ("jax", "jaxlib", "copula_var_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cuda_request_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    path, _, tdata = _truncated(tmp_path, "garch", 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifacts(path, tdata, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_unported_options_raise_naming_the_roadmap(tmp_path):
    path, _, tdata = _truncated(tmp_path, "msm", 4)
    bt = load_artifacts(path, tdata)
    from copula_var_tpu_torch.backtest import VaRBacktest

    with pytest.raises(ValueError, match="ROADMAP"):
        VaRBacktest(tdata, bt.adapter, bt.copula, bt.copula_fit,
                    bt.model_fits, bt.integration_inputs, refine_root=True)
    three = from_returns(np.zeros((N_IN + 4, 3)), n_insample=N_IN)
    with pytest.raises(ValueError, match="ROADMAP"):
        VaRBacktest(three, bt.adapter, bt.copula, bt.copula_fit,
                    bt.model_fits, bt.integration_inputs)
    for adapter in (MsmAdapter(), GarchAdapter()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            adapter.fit(tdata.in_sample)


def test_cpu_main_path_launches_no_kernel(tmp_path):
    path, _, tdata = _truncated(tmp_path, "msm", 4)
    before = (cq.masked_sweep.launches, cs.bisect_levels.launches)
    load_artifacts(path, tdata).calc_var(0.05)
    assert (cq.masked_sweep.launches, cs.bisect_levels.launches) == before
    meta = json.loads(str(np.load(path)["meta"]))
    assert meta["adapter"] == "msm"
