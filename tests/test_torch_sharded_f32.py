"""The port's f32 engine on a day mesh (`VaRBacktest(engine="pallas",
mesh=<DayMesh>)`, the JAX engine "sharded_pallas") and its dim-3
functions (`parallel.place_dim3_cache`, `sharded_dim3_pallas_*`) on the
CPU, gloo backend, through the f32 plain twins.

Spawned worlds of 2 and 3 ranks (`parallel.distributed.run_world`; days
12 + 12 and 8 + 8 + 8 at dim 2, 6 + 6 and 4 + 4 + 4 at dim 3, and two
4-day cases that leave the third rank no day) serve the fixtures of
`_torch_sharded_f32_worker` (dim 2 MSM/Student and GARCH/Gaussian at
n = 32, T = 24; dim 3 GARCH/Gaussian and MSM/Student at n = 16, T = 12,
numpy-seeded returns) through every query: `calc_var`,
`calc_var_levels`, `calc_var_portfolios`, `calc_var_grid`,
`compute_integral`, `refine_root=True` and `reference_quirks=True`; each
rank saves what it got. The JAX side is computed while the worlds run.

Bars, each with its reason:
  * 0.0 against the port's one-device f32 engine, and every rank against
    rank 0: at dim 2 every day is independent and the count of halvings
    fixed, at dim 3 the three reduced decisions give the one-device
    loop's trajectory, and every operand is cut from the whole;
  * the dim-2 `compute_integral` is, as JAX's, the float64 day-sharded
    sweep: 0.0 against the port's f64 engine and 1e-12 against JAX's
    (tests/test_sharded_engine.py's bar); dim 3 the f32 sweep, 1e-6
    against JAX's (tests/test_torch_f32_engine.py's);
  * roots against JAX's engine "sharded_pallas" on a mesh of the same
    size (the conftest's 8 CPU devices, Pallas in interpret mode): every
    day within `root_plateau_bound(dx, weights)`, the 0.9 quantile within
    the median-dx bound, NaN days equal (JAX's contract for its f32
    engine). JAX compiles each program anew per mesh, so each case is
    held at one mesh size (`JAX_WORLDS`) to keep the file near two
    minutes; the bit-equality holds every case on both worlds;
  * refined roots within 5e-4 of JAX's `xla` refined roots
    (tests/test_support_matrix.py:169-185);
  * the dim-3 functions against JAX's on the same numpy inputs, 1e-6 on
    the integrals and the plateau bound on the roots.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_f32_worker as fw
from copula_var_tpu import backtest as jbt
from copula_var_tpu import config as jcfg
from copula_var_tpu.copulas import fit as jcfit
from copula_var_tpu.data.returns import from_returns as jax_from_returns
from copula_var_tpu.models import fit as jmfit
from copula_var_tpu.ops import pallas_quadrature3 as jpq3
from copula_var_tpu.ops.pallas_solver import root_plateau_bound
from copula_var_tpu.ops.quadrature import CopulaSpec as JaxSpec
from copula_var_tpu.parallel import make_mesh as jax_make_mesh
from copula_var_tpu.parallel import quadrature as jpq
from copula_var_tpu_torch import config as tcfg
from copula_var_tpu_torch.parallel import distributed
from copula_var_tpu_torch.parallel.mesh import DayMesh, make_mesh

torch.set_num_threads(2)

ATOL_F64_SWEEP = 1e-12
ATOL_F32_SWEEP = 1e-6
ATOL_REFINED = 5e-4
WORLDS = (2, 3)
# the mesh size at which each case is held to JAX's engine
JAX_WORLDS = {"msm2": 2, "msm3": 3, "garch2": 3, "garch3": 2, "short2": 3,
              "short3": 3}
ROOT_QUERIES = ("var", "levels", "ports", "grid", "quirks")
REFINED_QUERIES = ("refined", "refined_ports")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{D: future of [rank results]} of spawned gloo worlds of 2 and 3
    ranks, started together and left running while the JAX side is
    computed."""
    tmp = tmp_path_factory.mktemp("f32_worlds")

    def run(D):
        path = str(tmp / f"w{D}_%d.npz")
        distributed.run_world(fw.rank_main, D, (path, True), backend="gloo",
                              device="cpu", timeout_s=240)
        return [dict(np.load(path % r)) for r in range(D)]

    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {D: pool.submit(run, D) for D in WORLDS}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_device():
    return fw.serve(None)


def _jax_backtest(case, engine, D=None, **kw):
    est, kind, dim, days, n, k = fw.CASES[case]
    data = jax_from_returns(fw.returns(dim, days), n_insample=fw.N_IN,
                            weights=fw.WEIGHTS[dim])
    fit_cls = jmfit.MsmFit if est == "msm" else jmfit.GarchFit
    cfit_cls = jcfit.StudentFit if kind == "student" else jcfit.GaussianFit
    adapter = (jbt.MsmAdapter(k=k) if est == "msm"
               else jbt.GarchAdapter(p_max=1, q_max=1))
    return jbt.VaRBacktest(
        data, adapter, kind, num_points=n, engine=engine,
        mesh=None if D is None else jax_make_mesh(n_devices=D),
        model_fits_override=[fit_cls(**f) for f in fw.model_fits(est, dim)],
        copula_fit_override=cfit_cls(**fw.copula_fit(kind, dim)), **kw)


def _jax_queries(case):
    """{query: array} of JAX's "sharded_pallas" at the case's mesh size,
    and of its xla engine (one device) for the refined queries; plus the
    grid's dx."""
    out = {}
    for name, (opts, call) in fw.queries(case).items():
        engine, D = (("xla", None) if name in REFINED_QUERIES
                     else ("sharded_pallas", JAX_WORLDS[case]))
        bt = _jax_backtest(case, engine, D, **opts)
        out[name] = np.asarray(call(bt))
    out["dx"] = np.asarray(bt.integration_inputs.dx)
    return out


def _jax_functions(family):
    """JAX's dim-3 f32 functions on a mesh of 2 CPU devices, on the
    worker's numpy inputs."""
    a = fw.function_inputs(family)
    mesh = jax_make_mesh(n_devices=2)
    spec = JaxSpec("student", (fw.NU, jnp.asarray(fw.corr(3))))
    w = jnp.asarray(a["weights"])
    if family == "msm":
        cache = jpq3.build_msm_dim3_cache(
            a["fbs"], a["fcombos"], a["x"], a["dx"], a["densities"],
            a["vols"], w, spec)
    else:
        cache = jpq3.build_garch_dim3_cache(a["fv"], a["x"], a["dx"], w,
                                            spec)
    leaves, shared = jpq.place_dim3_cache(mesh, cache)
    tail = (family, "student")
    solve = (-3.0, (-3.5, -2.0), 1e-6, -7.5, 0.0)
    levels = np.array(fw.LEVELS)
    out = {"z": np.asarray(cache.z),
           "integrals": jpq.sharded_dim3_pallas_integrals(
               mesh, a["bounds"], leaves, shared, *tail, interpret=True),
           "bisect": jpq.sharded_dim3_pallas_bisection_solve_levels(
               mesh, leaves, shared, *a["state"].values(), levels, 1e-6,
               *tail, interpret=True)}
    out["full"], out["full_nan"] = jpq.sharded_dim3_pallas_full_solve_levels(
        mesh, leaves, shared, levels, *solve, *tail, interpret=True,
        T=fw.FN_T)
    out["full_ports"] = jpq.sharded_dim3_pallas_full_solve_levels(
        mesh, leaves, shared, levels, *solve, *tail, interpret=True,
        reference_quirks=True, T=fw.FN_T, weights_batch=fw.W_ROWS[3])[0]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_side(worlds):
    """JAX's results, computed in this process while the worlds run."""
    out = {case: _jax_queries(case) for case in fw.CASES}
    out["fn"] = {family: _jax_functions(family)
                 for family in ("msm", "garch")}
    return out


def _hold_to_plateau(got, want, dx, weights):
    """Every day within the plateau bound of its row's weights, the 0.9
    quantile within the median-dx bound, NaN days equal."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    weights = np.atleast_2d(weights)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for row in range(got.shape[0]):
        w = weights[row % weights.shape[0]]
        ok = ~np.isnan(want[row])
        diff = np.abs(got[row][ok] - want[row][ok])
        assert diff.max(initial=0.0) <= root_plateau_bound(dx, w)
        med = root_plateau_bound(np.median(dx, keepdims=True), w)
        assert np.quantile(diff, 0.9) <= med


def _row_weights(case, name):
    """The weights of each flattened row of a query's result."""
    dim = fw.CASES[case][2]
    if name in ("ports", "refined_ports"):
        return fw.W_ROWS[dim]
    if name == "grid":
        return np.repeat(fw.W_ROWS[dim], len(fw.LEVELS), axis=0)
    return fw.WEIGHTS[dim]


KEYS = [f"{c}/{q}" for c in fw.CASES for q in fw.queries(c)]


# first in the file: its set-up starts the worlds, and JAX's programs
# compile while they run
@pytest.mark.parametrize("key", [k for k in KEYS
                                 if k.split("/")[1] in ROOT_QUERIES])
def test_roots_within_plateau_of_jax_sharded_pallas(worlds, jax_side, key):
    case, name = key.split("/")
    got = worlds[JAX_WORLDS[case]].result()[0][key]
    want = jax_side[case][name]
    assert got.shape == want.shape
    _hold_to_plateau(got.reshape(-1, got.shape[-1]),
                     want.reshape(-1, want.shape[-1]), jax_side[case]["dx"],
                     _row_weights(case, name))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("D", WORLDS)
def test_every_rank_equals_the_one_device_f32_engine(worlds, one_device, D,
                                                     key):
    """Bit-equal to the one-device f32 engine (the dim-2 integrals: see
    `test_dim2_integral_is_the_f64_sweep`), every rank to rank 0."""
    case, name = key.split("/")
    ranks = worlds[D].result()
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], ranks[0][key],
                                      err_msg=f"rank {r} of {D}")
    if name == "integral" and fw.CASES[case][2] == 2:
        assert ranks[0][key].dtype == np.float64
        assert one_device[key].dtype == np.float32
    else:
        np.testing.assert_array_equal(ranks[0][key], one_device[key])


@pytest.mark.parametrize("case", [c for c in fw.CASES
                                  if fw.CASES[c][2] == 2])
def test_dim2_integral_is_the_f64_sweep(worlds, jax_side, case):
    """JAX's "sharded_pallas" sweeps its f64 day tensors: the port's
    ranks give its f64 engine's bits and JAX's within 1e-12."""
    bt = fw.port_backtest(case)
    bt.engine = "xla"
    days = fw.CASES[case][3]
    f64 = bt.compute_integral(np.stack([np.full(days, -100.0),
                                        np.full(days, -3.0)], -1))
    for D in WORLDS:
        got = worlds[D].result()[0][f"{case}/integral"]
        np.testing.assert_array_equal(got, f64)
    np.testing.assert_allclose(got, jax_side[case]["integral"], rtol=0,
                               atol=ATOL_F64_SWEEP)


@pytest.mark.parametrize("case", [c for c in fw.CASES
                                  if fw.CASES[c][2] == 3])
def test_dim3_integral_is_the_f32_sweep(worlds, jax_side, case):
    got = worlds[JAX_WORLDS[case]].result()[0][f"{case}/integral"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jax_side[case]["integral"], rtol=0,
                               atol=ATOL_F32_SWEEP)


@pytest.mark.parametrize("key", [k for k in KEYS
                                 if k.split("/")[1] in REFINED_QUERIES])
def test_refined_roots_match_jax_xla_refined(worlds, jax_side, key):
    case, name = key.split("/")
    for D in WORLDS:
        np.testing.assert_allclose(worlds[D].result()[0][key],
                                   jax_side[case][name], rtol=0,
                                   atol=ATOL_REFINED)


def test_ranks_hold_their_blocks(worlds):
    for D in WORLDS:
        for r, got in enumerate(worlds[D].result()):
            want = [DayMesh(None, r, D, torch.device("cpu")).day_block(c[3])
                    for c in fw.CASES.values()]
            np.testing.assert_array_equal(got["blocks"], want)
    # the 4-day cases leave the last of three ranks nothing
    blocks = worlds[3].result()[2]["blocks"]
    assert [tuple(blocks[i]) for i, c in enumerate(fw.CASES)
            if c.startswith("short")] == [(4, 4), (4, 4)]


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_dim3_functions_match_jax(worlds, jax_side, family):
    """`place_dim3_cache` (each rank's block of the float32 columns) and
    the `sharded_dim3_pallas_*` functions against JAX's (on a mesh of 2)
    on the same numpy inputs, on both worlds; every rank bit-equal to its
    rank 0. (The plain dim-3 sweep contracts a chunk of days in one BLAS
    product, so a raw CDF value may round an ulp apart between worlds
    whose blocks differ.)"""
    want = jax_side["fn"][family]
    key = f"fn/{family}/"
    a = fw.function_inputs(family)
    dx = a["dx"]
    for D in WORLDS:
        ranks = worlds[D].result()
        z = np.concatenate([r[key + "block_z"] for r in ranks])
        np.testing.assert_allclose(z, want["z"].reshape(z.shape), rtol=0,
                                   atol=1e-5)
        got = ranks[0]
        for r in ranks:
            for name in ("integrals", "bisect", "full", "full_nan",
                         "full_ports"):
                np.testing.assert_array_equal(r[key + name], got[key + name])
        np.testing.assert_allclose(got[key + "integrals"],
                                   want["integrals"], rtol=0,
                                   atol=ATOL_F32_SWEEP)
        _hold_to_plateau(got[key + "bisect"], want["bisect"], dx,
                         a["weights"])
        np.testing.assert_array_equal(got[key + "full_nan"],
                                      want["full_nan"])
        _hold_to_plateau(got[key + "full"], want["full"], dx, a["weights"])
        _hold_to_plateau(got[key + "full_ports"], want["full_ports"], dx,
                         fw.W_ROWS[3])


# -- refusals, in JAX's words -------------------------------------------------


def test_grid_mesh_with_the_f32_engine_raises():
    """JAX's engine is one string: it has no f32 grid-sharded engine."""
    mesh = make_mesh(device="cpu", axis_names=("days", "grid"), shape=(1, 1))
    bt = fw.port_backtest("garch2", mesh)
    with pytest.raises(ValueError, match="no f32 grid-sharded engine"):
        bt.calc_var(0.05)


def _jax_message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_dim4_with_sharded_pallas_raises_as_jax():
    """A dim-4 backtest under the config's "sharded_pallas" (the f32
    engine on a day mesh of one process) raises JAX's message."""
    from copula_var_tpu_torch.data import from_returns

    rets = np.random.default_rng(3).standard_normal((fw.N_IN + 4, 4))
    cfg = tcfg.BacktestConfig(estimation_type="garch",
                              copula_type="gaussian", n_insample=fw.N_IN,
                              engine="sharded_pallas", num_points=8)
    cfg.garch.p_max = cfg.garch.q_max = 1
    jc = jcfg.BacktestConfig(estimation_type="garch", copula_type="gaussian",
                             n_insample=fw.N_IN, engine="sharded_pallas",
                             num_points=8, n_mesh_devices=1)
    jc.garch.p_max = jc.garch.q_max = 1
    want = _jax_message(lambda: jcfg.run_backtest(
        jax_from_returns(rets, n_insample=fw.N_IN), jc))
    with pytest.raises(ValueError) as got:
        tcfg.run_backtest(from_returns(rets, n_insample=fw.N_IN), cfg,
                          device="cpu")
    assert str(got.value) == want


class _MinimalGarch:
    """JAX's minimal plugin contract (no day_tensors / day_columns), for
    either package's GARCH adapter."""

    def __init__(self, inner):
        self._inner = inner

    def fit(self, in_sample, device=None, timings=None):
        return self._inner.fit(in_sample)

    def marginals_densities(self, in_sample, fits, device=None):
        return self._inner.marginals_densities(in_sample, fits)

    def integration_inputs(self, windows, fits, num_points, box=(-5.0, 5.0),
                           device=None):
        kw = {} if device is None else {"device": device}
        return self._inner.integration_inputs(windows, fits, num_points, box,
                                              **kw)

    def integrals(self, bounds, inputs, spec, weights, box_min=-5.0):
        return self._inner.integrals(bounds, inputs, spec, weights, box_min)


def test_plugin_adapter_on_a_day_mesh_raises_as_jax():
    """A plugin adapter with the f32 engine on a day mesh: JAX's
    "sharded_pallas" message (the port refuses it when the backtest is
    built, JAX at the first query)."""
    from copula_var_tpu_torch import backtest as tbt
    from copula_var_tpu_torch.data import from_returns

    est, kind, dim, days, n, _ = fw.CASES["garch2"]
    rets = fw.returns(dim, days)
    fits = fw.model_fits(est, dim)
    copula = fw.copula_fit(kind, dim)
    jb = jbt.VaRBacktest(
        jax_from_returns(rets, n_insample=fw.N_IN, weights=fw.WEIGHTS[2]),
        _MinimalGarch(jbt.GarchAdapter(p_max=1, q_max=1)), kind,
        num_points=8, engine="sharded_pallas",
        mesh=jax_make_mesh(n_devices=1),
        model_fits_override=[jmfit.GarchFit(**f) for f in fits],
        copula_fit_override=jcfit.GaussianFit(**copula))
    want = _jax_message(lambda: jb.calc_var(0.05))
    data = from_returns(rets, n_insample=fw.N_IN, weights=fw.WEIGHTS[2])
    adapter = _MinimalGarch(tbt.GarchAdapter(p_max=1, q_max=1))
    from copula_var_tpu_torch.copulas import fit as cfit
    from copula_var_tpu_torch.models import fit as mfit

    tfits = [mfit.GarchFit(**f) for f in fits]
    inputs = adapter.integration_inputs(data.rolling_windows(), tfits, 8,
                                        device="cpu")
    with pytest.raises(ValueError) as got:
        tbt.VaRBacktest(data, adapter, kind, cfit.GaussianFit(**copula),
                        tfits, inputs, num_points=8, device="cpu",
                        engine="pallas", mesh=make_mesh(device="cpu"))
    assert str(got.value).startswith(want)
