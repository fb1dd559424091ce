"""Day-sharded serving of the port (`copula_var_tpu_torch/parallel/`,
`VaRBacktest(mesh=...)`) on the CPU, gloo backend.

A world of one process in the test process holds the mesh, the day
blocks and the gather. Spawned worlds of 2 and 3 ranks
(`parallel.distributed.run_world`; 3 ranks give uneven blocks, and a
4-day case an empty one) serve the fixtures of `_torch_parallel_worker`
(tests/test_sharded_engine.py's dim-2 MSM/Student and GARCH/Gaussian,
a dim-3 and a dim-4 GARCH/Gaussian book) through every query, and each
rank saves what it got. Each result is held against the port unsharded
at 0.0 (a raw dim >= 3 sweep value to its day chunk's rounding), against
the JAX package's engine="sharded" on a mesh of the same size (the
conftest's 8-device CPU mesh) at atol 1e-12, the JAX test's own bar, and
the flagship record on a day cut at 1e-9."""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_worker as wk
from copula_var_tpu import backtest as jbt
from copula_var_tpu.copulas import fit as jcfit
from copula_var_tpu.data.returns import from_returns as jax_from_returns
from copula_var_tpu.models import fit as jmfit
from copula_var_tpu.parallel import make_mesh as jax_make_mesh
from copula_var_tpu.parallel import quadrature as jpq
from copula_var_tpu_torch import parallel as par
from copula_var_tpu_torch.parallel import distributed
from copula_var_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

ATOL_JAX = 1e-12  # tests/test_sharded_engine.py
ATOL_RECORD = 1e-9  # tests/test_flagship.py:63
WORLDS = (2, 3)


@pytest.fixture
def world1(tmp_path):
    """A gloo world of one process (this one), left in teardown."""
    distributed.initialize(f"file://{tmp_path}/store", world_size=1,
                           rank=0, device="cpu")
    yield make_mesh(device="cpu")
    distributed.shutdown()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{D: [rank results]} of spawned gloo worlds of 2 and 3 ranks; the
    2-rank world also serves the flagship cut and the parallel
    functions."""
    tmp = tmp_path_factory.mktemp("worlds")
    wk.cut_flagship(str(tmp))

    def run(D):
        path = str(tmp / f"w{D}_%d.npz")
        distributed.run_world(wk.rank_main, D, (path, str(tmp), D == 2),
                              backend="gloo", device="cpu", timeout_s=120)
        return [dict(np.load(path % r)) for r in range(D)]

    with ThreadPoolExecutor(len(WORLDS)) as pool:  # the two worlds at once
        return dict(zip(WORLDS, pool.map(run, WORLDS)))


@pytest.fixture(scope="module")
def unsharded():
    return wk.serve(None)


# -- world of one, in this process ------------------------------------------


def test_initialize_without_a_world_is_a_no_op():
    distributed.initialize()
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_device_count": 1,
        "global_device_count": 1}
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.sum(t) is t and par.shard_days(t, mesh, 1) is not None


def test_world_of_one_mesh_blocks_and_gather(world1):
    mesh = world1
    assert dist.is_initialized() and mesh.group is not None
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    assert mesh.day_block(500) == (0, 500)
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_device_count": 1,
        "global_device_count": 1}
    t = torch.randn(3, 7, dtype=torch.float64)
    local = par.shard_days(t, mesh, axis=1)
    assert torch.equal(par.gather_days(local, mesh, 7, axis=1), t)
    flags = t > 0
    assert torch.equal(par.gather_days(flags, mesh, 7), flags)
    assert bool(mesh.all(torch.tensor([True]))) and \
        not bool(mesh.any(torch.tensor(False)))
    assert float(mesh.max(torch.tensor(2.5, dtype=torch.float64))) == 2.5
    with pytest.raises(ValueError, match="gather_days"):
        par.gather_days(local[:, :3], mesh, 7)


def test_world_of_one_serves_the_unsharded_series(world1, unsharded):
    bt = wk.port_backtest("msm2", world1)
    np.testing.assert_array_equal(bt.calc_var_levels(wk.LEVELS),
                                  unsharded["msm2/levels"])


@pytest.mark.parametrize("n", [2, 8])
def test_make_mesh_refuses_another_world_size(n):
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(n_devices=n, device="cpu")
    assert make_mesh(n_devices=1, device="cpu").size == 1


def test_cuda_mesh_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA mesh is served")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("file:///nonexistent/store", world_size=2,
                               rank=0)
    assert not dist.is_initialized()


def test_backtest_refuses_a_device_the_mesh_does_not_serve():
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="the mesh's ranks serve"):
        wk.port_backtest("garch2", mesh, device="cuda")


@pytest.mark.parametrize("T, D", [(16, 2), (16, 3), (14, 8), (500, 3),
                                  (4, 3), (5, 4)])
def test_day_blocks_are_jax_pad_blocks(T, D):
    """Blocks of ceil(T / D), JAX's `pad_days` blocks with the pad sliced
    off; together they cover the days once, in order."""
    blocks = [par.DayMesh(None, r, D, torch.device("cpu")).day_block(T)
              for r in range(D)]
    block = len(np.asarray(jpq.pad_days(np.arange(T), D))) // D
    assert all(b == (min(r * block, T), min((r + 1) * block, T))
               for r, b in enumerate(blocks))
    a = np.arange(2 * T, dtype=np.float64).reshape(2, T)
    np.testing.assert_array_equal(
        par.pad_days(torch.as_tensor(a), D, axis=1).numpy(),
        np.asarray(jpq.pad_days(a, D, axis=1)))


# -- spawned worlds -----------------------------------------------------------

QUERY_KEYS = [f"{c}/{q}" for c in wk.CASES for q in wk.queries(c)]


# one CDF value of the plain transform-cached sweep (dim >= 3 on the CPU):
# its state contraction is one BLAS product over a chunk of days, and a
# rank's chunk holds only its block, so a value may round one ulp apart
RTOL_CHUNK = 1e-15


@pytest.mark.parametrize("key", QUERY_KEYS)
@pytest.mark.parametrize("D", WORLDS)
def test_sharded_equals_unsharded(worlds, unsharded, D, key):
    """Every rank returns the full series, bit-equal to one process's
    (a raw dim >= 3 sweep to its chunk's rounding)."""
    case, name = key.split("/")
    for r, got in enumerate(worlds[D]):
        if name == "integral" and wk.CASES[case][2] >= 3:
            np.testing.assert_allclose(got[key], unsharded[key],
                                       rtol=RTOL_CHUNK, atol=0,
                                       err_msg=f"rank {r} of {D}")
        else:
            np.testing.assert_array_equal(got[key], unsharded[key],
                                          err_msg=f"rank {r} of {D}")


@pytest.mark.parametrize("D", WORLDS)
def test_ranks_hold_their_blocks(worlds, D):
    for r, got in enumerate(worlds[D]):
        want = [par.DayMesh(None, r, D, torch.device("cpu")).day_block(
            c[3]) for c in wk.CASES.values()]
        np.testing.assert_array_equal(got["blocks"], want)
        # sorted keys: global_device_count, local_device_count,
        # process_count, process_index
        np.testing.assert_array_equal(got["info"], [D, 1, D, r])
    if D == 3:  # the 4-day case leaves the last rank nothing
        assert tuple(worlds[D][2]["blocks"][-1]) == (4, 4)


def _jax_backtest(case, D, **kw):
    est, kind, dim, days, n, k = wk.CASES[case]
    data = jax_from_returns(wk.returns(dim, days),
                            [f"A{i}" for i in range(dim)], wk.N_IN,
                            wk.weights(dim))
    fit_cls = jmfit.MsmFit if est == "msm" else jmfit.GarchFit
    cfit_cls = jcfit.StudentFit if kind == "student" else jcfit.GaussianFit
    adapter = jbt.MsmAdapter(k=k) if est == "msm" else jbt.GarchAdapter()
    return jbt.VaRBacktest(
        data, adapter, kind, num_points=n, engine="sharded",
        mesh=jax_make_mesh(n_devices=D),
        model_fits_override=[fit_cls(**f) for f in wk.model_fits(est, dim)],
        copula_fit_override=cfit_cls(**wk.copula_fit(kind, dim)), **kw)


@pytest.fixture(scope="module")
def jax_backtests():
    """JAX engine="sharded" backtests, one per (case, D, options)."""
    cache = {}

    def get(case, D, **opts):
        key = (case, D, tuple(sorted(opts.items())))
        if key not in cache:
            cache[key] = _jax_backtest(case, D, **opts)
        return cache[key]

    return get


@pytest.mark.parametrize("key", QUERY_KEYS)
@pytest.mark.parametrize("D", WORLDS)
def test_sharded_equals_jax_sharded_engine(worlds, jax_backtests, D, key):
    case, name = key.split("/")
    opts, call = wk.queries(case)[name]
    want = np.asarray(call(jax_backtests(case, D, **opts)))
    np.testing.assert_allclose(worlds[D][0][key], want, rtol=0,
                               atol=ATOL_JAX)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_flagship_record_served_by_two_ranks(worlds, est):
    rec = np.load(os.path.join(wk.ROOT, "data", "flagship_var.npz"))
    want = rec[f"{est}_var"][:wk.FLAGSHIP_DAYS]
    for got in worlds[2]:
        np.testing.assert_allclose(got[f"flagship/{est}"], want, rtol=0,
                                   atol=ATOL_RECORD)


def _jax_functions(case):
    a = wk.function_inputs(case)
    spec = _jax_backtest(case, 2).copula_spec
    mesh = jax_make_mesh(n_devices=2)
    msm = case.startswith("msm")
    fc, dens = ((a["forecast_combos"], a["densities"]) if msm
                else (None, None))
    out = {}
    if msm:
        ints, mean = jpq.sharded_msm_step(
            mesh, a["bounds"], a["forecasts_by_states"], fc, a["x"],
            a["dx"], dens, a["unique_vols"], a["weights"], spec)
        out["mean"] = mean
    else:
        ints = jpq.sharded_garch_step(mesh, a["bounds"], a["forecast_vols"],
                                      a["x"], a["dx"], a["weights"], spec)
    out["step"] = ints
    out["cached"] = jpq.sharded_cached_step(
        mesh, a["bounds"], a["day_tensors"], fc, a["x"], a["dx"], dens,
        a["weights"])
    common = (mesh, a["day_tensors"], fc, dens, a["x"], a["dx"])
    st = a["state"]
    out["bisect_levels"] = jpq.sharded_bisection_solve_levels(
        *common, a["weights"], *st.values(), np.array([0.01, 0.05]), 1e-6)
    out["bisect"] = jpq.sharded_bisection_solve(
        *common, a["weights"], *(v[1] for v in st.values()), 0.05, 1e-6)
    solve = (-3.0, (-3.5, -2.0), 1e-6, -7.5, 0.0)
    out["full_levels"] = jpq.sharded_full_solve_levels(
        *common, a["weights"], [0.01, 0.05], *solve, refine=True,
        refine_h=0.05)[0]
    out["full_ports"] = jpq.sharded_full_solve_portfolios(
        *common, wk.W_ROWS, np.array([0.05, 0.01]), *solve,
        reference_quirks=True)[0]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", ["msm2", "garch2"])
def test_parallel_functions_equal_jax(worlds, case):
    want = _jax_functions(case)
    got = worlds[2][0]
    for name, w in want.items():
        np.testing.assert_allclose(got[f"fn/{case}/{name}"], w, rtol=0,
                                   atol=ATOL_JAX, err_msg=name)
    for other in worlds[2][1:]:
        for name in want:
            np.testing.assert_array_equal(other[f"fn/{case}/{name}"],
                                          got[f"fn/{case}/{name}"])


def test_run_backtest_sharded_engine_equals_one_process(worlds):
    """engine="sharded" over 2 ranks: each rank fits, rank 0's state is
    broadcast, and the series equals the unsharded pipeline's."""
    want = wk.config_run(None)
    for got in worlds[2]:
        np.testing.assert_array_equal(got["config/garch"], want)


def _raise_on_rank_one():
    mesh = make_mesh(device="cpu")
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)  # the survivor, stopped when rank 1 fails


def test_a_failing_rank_fails_the_world():
    """The failing rank's error reaches the caller, and the survivor is
    terminated rather than waited for."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails"):
        distributed.run_world(_raise_on_rank_one, 2, backend="gloo",
                              device="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 120
