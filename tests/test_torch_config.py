"""Port parity: `copula_var_tpu_torch.config` against
`copula_var_tpu.config` on the CPU: the dataclass defaults, the kwargs
the config maps onto the factory and the copula fitters, `from_dict` of a
JAX config, and `run_backtest` through both packages on a cut of
`data/flagship.csv` (GARCH with p_max = q_max = 1 and a Gaussian copula
over a ladder of levels; mean-reverting at perturb_scale=0 with a
Plackett copula at one level), the VaR equal at atol 1e-9. The copulas
are the cheap ones: a Student-t fit at the config's tol = 1e-9 takes
~30 s per package on the CPU, and the Student path is held through
`create_var_backtest` elsewhere."""

import numpy as np
import pytest
import torch

from copula_var_tpu import config as jcfg
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu_torch import config as tcfg
from copula_var_tpu_torch.data import from_csv, from_returns

torch.set_num_threads(2)

ATOL_VAR = 1e-9
CUT_N, CUT_T = 300, 20  # as tests/test_torch_fit_path.py
JAX_ONLY = {"pallas_day_block": 32}


def _without_jax_keys(d):
    return {k: v for k, v in d.items() if k not in JAX_ONLY}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_defaults_equal_jax():
    got = tcfg.BacktestConfig().to_dict()
    want = jcfg.BacktestConfig().to_dict()
    assert {k: want[k] for k in JAX_ONLY} == JAX_ONLY
    assert got == _without_jax_keys(want)


@pytest.mark.parametrize("est", ["msm", "garch", "mean_reverting"])
@pytest.mark.parametrize("copula", ["gaussian", "student", "plackett"])
def test_kwargs_equal_jax(est, copula):
    cfg_t = tcfg.BacktestConfig(estimation_type=est, copula_type=copula)
    cfg_j = jcfg.BacktestConfig(estimation_type=est, copula_type=copula)
    cfg_t.msm.k = cfg_j.msm.k = 3
    cfg_t.copula.tol = cfg_j.copula.tol = 1e-7
    _equal(tcfg.adapter_kwargs(cfg_t), jcfg.adapter_kwargs(cfg_j))
    _equal(tcfg.copula_fit_kwargs(cfg_t), jcfg.copula_fit_kwargs(cfg_j))


def test_unknown_estimation_type_raises_as_jax():
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="Unsupported estimation type"):
            mod.adapter_kwargs(mod.BacktestConfig(estimation_type="arma"))


def test_from_dict_takes_a_jax_dict():
    j = jcfg.BacktestConfig(estimation_type="mean_reverting",
                            copula_type="plackett")
    j.mean_reverting.perturb_scale = 0.0
    j.solver.obj_levels = (0.01, 0.05)
    got = tcfg.BacktestConfig.from_dict(j.to_dict())
    assert got.to_dict() == _without_jax_keys(j.to_dict())
    assert isinstance(got.mean_reverting, tcfg.MeanRevertingConfig)
    assert tcfg.BacktestConfig.from_dict(got.to_dict()) == got


@pytest.mark.parametrize("key, value", [
    ("pallas_day_block", 8),
])
def test_from_dict_refuses_jax_engine_settings(key, value):
    """The JAX setting the port does not serve: the TPU grid's day block of
    its f32 Pallas kernel (the port's f32 engine runs one block per day;
    its f64 xla engine has none)."""
    d = jcfg.BacktestConfig().to_dict()
    d[key] = value
    with pytest.raises(ValueError, match="f64 xla engine"):
        tcfg.BacktestConfig.from_dict(d)


def test_from_dict_accepts_the_pallas_engine():
    """A JAX `BacktestConfig(engine="pallas")` dict round-trips: the port
    serves the f32 engine."""
    j = jcfg.BacktestConfig(engine="pallas")
    got = tcfg.BacktestConfig.from_dict(j.to_dict())
    assert got.engine == "pallas"
    assert got.to_dict() == _without_jax_keys(j.to_dict())
    assert tcfg.BacktestConfig.from_dict(got.to_dict()) == got


def test_run_backtest_serves_the_f32_engine():
    """`run_backtest` with engine="pallas" on the CPU serves the f32
    engine (its plain twins), against JAX's `run_backtest` on its f32
    engine (interpret mode): every day within the plateau bound."""
    from copula_var_tpu.ops.pallas_solver import root_plateau_bound

    returns, tickers = _cut()
    cfgs = [mod.BacktestConfig(estimation_type="garch", copula_type="gaussian",
                               n_insample=CUT_N, engine="pallas",
                               num_points=40)
            for mod in (tcfg, jcfg)]
    for c in cfgs:
        c.garch.p_max = c.garch.q_max = 1
    bt, var = tcfg.run_backtest(
        from_returns(returns, tickers=tickers, n_insample=CUT_N), cfgs[0],
        device="cpu")
    jbt, jvar = jcfg.run_backtest(
        jax_from_returns(returns, tickers=tickers, n_insample=CUT_N),
        cfgs[1])
    assert bt.engine == "pallas" and bt.sweep_operands().dtype == \
        torch.float32
    assert var.shape == (CUT_T,) and np.all(np.isfinite(var))
    bound = root_plateau_bound(np.asarray(jbt.integration_inputs.dx),
                               bt.data.weights)
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=0, atol=bound)


@pytest.mark.parametrize("engine, n", [
    ("sharded", 4), ("sharded", None), ("sharded_pallas", 2),
    ("grid_sharded", 4), ("grid_sharded", None),
])
def test_from_dict_accepts_sharded_engines(engine, n):
    """The sharded engines (and their mesh size) round-trip from a JAX
    dict: "sharded" and "sharded_pallas" mean the port's f64 day-sharded
    path, "grid_sharded" its grid-sharded path."""
    j = jcfg.BacktestConfig(engine=engine, n_mesh_devices=n)
    got = tcfg.BacktestConfig.from_dict(j.to_dict())
    assert (got.engine, got.n_mesh_devices) == (engine, n)
    assert got.to_dict() == _without_jax_keys(j.to_dict())


def test_sharded_engine_needs_the_world_it_names():
    """engine="sharded" builds its mesh over the world: in one process
    n_mesh_devices=4 is refused before any fit runs."""
    cfg = tcfg.BacktestConfig(engine="sharded", n_mesh_devices=4)
    data = from_returns(np.zeros((40, 2)), tickers=["A", "B"], n_insample=30)
    with pytest.raises(ValueError, match="one process per device"):
        tcfg.run_backtest(data, cfg, device="cpu")


def test_grid_sharded_engine_needs_the_world_it_names():
    """engine="grid_sharded" builds a (1, n_mesh_devices) mesh over the
    world: in one process n_mesh_devices=4 is refused before any fit
    runs."""
    cfg = tcfg.BacktestConfig(engine="grid_sharded", n_mesh_devices=4)
    data = from_returns(np.zeros((40, 2)), tickers=["A", "B"], n_insample=30)
    with pytest.raises(ValueError, match="one process per device"):
        tcfg.run_backtest(data, cfg, device="cpu")


def _cut():
    data = from_csv("data/flagship.csv", n_insample=1135)
    return data.returns[:CUT_N + CUT_T], data.tickers


@pytest.mark.parametrize("est", ["garch", "mean_reverting"])
def test_run_backtest_equals_jax(est):
    returns, tickers = _cut()
    cfgs = [mod.BacktestConfig(estimation_type=est, n_insample=CUT_N)
            for mod in (tcfg, jcfg)]
    for c in cfgs:
        if est == "garch":
            c.garch.p_max = c.garch.q_max = 1
            c.copula_type = "gaussian"
            c.solver.obj_levels = (0.025, 0.05)
        else:
            c.mean_reverting.perturb_scale = 0.0
            c.copula_type = "plackett"
    bt, var = tcfg.run_backtest(
        from_returns(returns, tickers=tickers, n_insample=CUT_N), cfgs[0],
        device="cpu")
    jbt, jvar = jcfg.run_backtest(
        jax_from_returns(returns, tickers=tickers, n_insample=CUT_N),
        cfgs[1])
    want_shape = (2, CUT_T) if est == "garch" else (CUT_T,)
    assert var.shape == want_shape and np.all(np.isfinite(var))
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=0, atol=ATOL_VAR)
    assert bt.adapter.name == est and bt.device.type == "cpu"
