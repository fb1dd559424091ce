"""The port's entry scripts on the CPU, each run as its own process with
JAX and the JAX package blocked from import:
`examples/run_backtest_torch.py --quick --device cpu`, whose saved VaR
series must equal `config.run_backtest` called directly on the same
seeded synthetic data and configs (bit for bit: the same code on the same
device), and `examples/model_diagnostics_torch.py --quick --device cpu`,
which must write its four figures. Both scripts start together, while
this process computes the direct series."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run a script with `jax` and `copula_var_tpu` unimportable
BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; "
           "sys.modules['copula_var_tpu'] = None; "
           "script = sys.argv[1]; sys.argv = sys.argv[1:]; "
           "runpy.run_path(script, run_name='__main__')")


def _start(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-c", BLOCKED,
         os.path.join(ROOT, "examples", script), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripts")
    procs = {
        "run": _start("run_backtest_torch.py", "--quick", "--device", "cpu",
                      "--save", str(tmp / "var.npz")),
        "diag": _start("model_diagnostics_torch.py", "--quick", "--device",
                       "cpu", "--outdir", str(tmp / "diag")),
    }
    yield procs, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _finish(proc):
    out = proc.communicate(timeout=900)[0]
    assert proc.returncode == 0, out
    return out


def _direct():
    """{family: VaR} of `config.run_backtest` on the script's --quick
    problem, built here from the config and data APIs."""
    from copula_var_tpu_torch.config import BacktestConfig, run_backtest
    from copula_var_tpu_torch.data import synthetic_dataset

    data = synthetic_dataset(0, 260, 220, spec=("garch", "msm"),
                             device="cpu")
    out = {}
    for est in ("garch", "msm"):
        cfg = BacktestConfig(estimation_type=est, copula_type="student",
                             n_insample=220, num_points=24)
        cfg.msm.k, cfg.msm.basin_iter = 2, 10
        cfg.garch.p_max = cfg.garch.q_max = 1
        cfg.garch.newton_max_iter = 40
        out[est] = run_backtest(data, cfg, device="cpu")[1]
    return out, data.portfolio_out_sample()


def test_run_backtest_script_equals_run_backtest(scripts):
    procs, tmp = scripts
    want, ptf = _direct()
    out = _finish(procs["run"])
    assert "data: 2 assets, N=220 in-sample, T=40" in out
    got = np.load(tmp / "var.npz")
    np.testing.assert_array_equal(got["portfolio"], ptf)
    for est, var in want.items():
        assert var.shape == (40,) and np.all(np.isfinite(var))
        np.testing.assert_array_equal(got[est], var, err_msg=est)
        assert f"{est} exceptions at 5%:" in out


def test_model_diagnostics_script_writes_its_figures(scripts):
    procs, tmp = scripts
    out = _finish(procs["diag"])
    for line in ("MSM held-out LL:", "GARCH BIC pick:", "UKF EM fit:"):
        assert line in out
    assert sorted(os.listdir(tmp / "diag")) == [
        "garch_residuals.png", "msm_marginals.png", "msm_states.png",
        "ukf_vol.png"]
