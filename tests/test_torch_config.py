"""Port parity: `copula_var_tpu_torch.config` against
`copula_var_tpu.config` on the CPU: the dataclass defaults, the kwargs
the config maps onto the factory and the copula fitters, `from_dict` of a
JAX config, and `run_backtest` through both packages on a cut of
`data/flagship.csv` (GARCH with p_max = q_max = 1 and a Gaussian copula
over a ladder of levels; mean-reverting at perturb_scale=0 with a
Plackett copula at one level), the VaR equal at atol 1e-9; and
`pallas_day_block`, which the port keeps for the round trip because
JAX's f32 roots do not move with it. The copulas
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
    assert got == want


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
    assert got.to_dict() == j.to_dict()
    assert isinstance(got.mean_reverting, tcfg.MeanRevertingConfig)
    assert tcfg.BacktestConfig.from_dict(got.to_dict()) == got


@pytest.mark.parametrize("key, value", [
    ("pallas_day_block", 0),
    ("pallas_day_block", 2.5),
])
def test_from_dict_refuses_jax_engine_settings(key, value):
    """A JAX setting that names no day block of its f32 Pallas kernel: a
    block is a positive whole number of days."""
    d = jcfg.BacktestConfig().to_dict()
    d[key] = value
    with pytest.raises(ValueError, match="positive number of days"):
        tcfg.BacktestConfig.from_dict(d)


@pytest.mark.parametrize("block", [8, 16, 64])
def test_from_dict_keeps_any_pallas_day_block(block):
    """Any positive day block of a JAX dict round-trips: `to_dict` gives
    it back, and the config equals the JAX one's dict."""
    j = jcfg.BacktestConfig(engine="pallas", pallas_day_block=block)
    got = tcfg.BacktestConfig.from_dict(j.to_dict())
    assert got.pallas_day_block == block
    assert got.to_dict() == j.to_dict()
    assert tcfg.BacktestConfig.from_dict(got.to_dict()) == got


def test_pallas_day_block_does_not_move_jax_f32_roots():
    """Why the port keeps the block and ignores it: JAX's f32 engine
    (interpret mode) at day blocks 8, 16, 32 and 64 gives series within
    the plateau bound of each other (every day; 0.9 quantile within the
    median-dx bound) on a dim-2 MSM and a GARCH backtest of 24 days at
    n = 32 (the block sets only the TPU grid of the kernel)."""
    from copula_var_tpu import backtest as jbt
    from copula_var_tpu.copulas.fit import StudentFit
    from copula_var_tpu.models.fit import GarchFit, MsmFit
    from copula_var_tpu.ops.pallas_solver import root_plateau_bound

    rng = np.random.default_rng(7)
    rets = rng.standard_normal((150 + 24, 2))
    w = np.array([0.6, 0.4])
    fits = {"msm": [MsmFit(0.5 + 0.05 * i, 3.0 + i, 0.5 - 0.05 * i,
                           1.0 + 0.1 * i, 0.0) for i in range(2)],
            "garch": [GarchFit(1, 1, 0.2, np.array([0.1]), np.array([0.7]),
                               0.0, 0.0, np.array([0.2, 0.1, 0.7]))] * 2}
    copula = StudentFit(6.0, np.array([[1.0, 0.4], [0.4, 1.0]]), 0.0,
                        np.zeros(1))
    for est, kw in (("msm", {"k": 2}), ("garch", {"p_max": 1,
                                                  "q_max": 1})):
        series = {}
        for block in (8, 16, 32, 64):
            jb = jbt.create_var_backtest(
                jax_from_returns(rets, n_insample=150, weights=w), est,
                "student", num_points=32, engine="pallas",
                pallas_day_block=block, model_fits_override=fits[est],
                copula_fit_override=copula, **kw)
            series[block] = np.asarray(jb.calc_var_levels((0.01, 0.05)))
        dx = np.asarray(jb.integration_inputs.dx)
        bound = root_plateau_bound(dx, w)
        median = root_plateau_bound(np.median(dx, keepdims=True), w)
        for block in (8, 16, 64):
            d = np.abs(series[block] - series[32])
            assert np.isfinite(series[block]).all()
            assert d.max() <= bound and np.quantile(d, 0.9) <= median


def test_from_dict_accepts_the_pallas_engine():
    """A JAX `BacktestConfig(engine="pallas")` dict round-trips: the port
    serves the f32 engine."""
    j = jcfg.BacktestConfig(engine="pallas")
    got = tcfg.BacktestConfig.from_dict(j.to_dict())
    assert got.engine == "pallas"
    assert got.to_dict() == j.to_dict()
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
    dict: "sharded" means the port's f64 day-sharded path,
    "sharded_pallas" its f32 engine on a day mesh, "grid_sharded" its
    grid-sharded path."""
    j = jcfg.BacktestConfig(engine=engine, n_mesh_devices=n)
    got = tcfg.BacktestConfig.from_dict(j.to_dict())
    assert (got.engine, got.n_mesh_devices) == (engine, n)
    assert got.to_dict() == j.to_dict()


def test_run_backtest_sharded_pallas_is_the_f32_engine_on_a_day_mesh():
    """`run_backtest` with engine "sharded_pallas" builds `engine="pallas"`
    on a `DayMesh` (here a world of one process) and serves the one-device
    f32 engine's series bit for bit (GARCH(1, 1), Gaussian copula, on a
    cut of the flagship CSV at n = 40)."""
    from copula_var_tpu_torch.parallel.mesh import DayMesh

    returns, tickers = _cut()
    out = {}
    for engine in ("pallas", "sharded_pallas"):
        cfg = tcfg.BacktestConfig(estimation_type="garch",
                                  copula_type="gaussian", n_insample=CUT_N,
                                  engine=engine, num_points=40)
        cfg.garch.p_max = cfg.garch.q_max = 1
        out[engine] = tcfg.run_backtest(
            from_returns(returns, tickers=tickers, n_insample=CUT_N), cfg,
            device="cpu")
    bt, var = out["sharded_pallas"]
    assert bt.engine == "pallas" and isinstance(bt.mesh, DayMesh)
    assert bt.sweep_operands().dtype == torch.float32
    assert out["pallas"][0].mesh is None
    np.testing.assert_array_equal(var, out["pallas"][1])


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
