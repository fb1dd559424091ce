"""Grid-sharded serving of the port (`VaRBacktest(mesh=GridMesh)`, the
`grid_sharded_*` functions of `copula_var_tpu_torch/parallel/`) on the
CPU, gloo backend.

Spawned worlds of 2 and 4 ranks (`parallel.distributed.run_world`) serve
the fixtures of `_torch_grid_worker` (dim-2 MSM/Student and
GARCH/Gaussian, dim-3 GARCH/Gaussian and MSM/Student, a dim-4
GARCH/Gaussian book) on ('days', 'grid') meshes (1, 2), (1, 4) and
(2, 2): `calc_var`, `calc_var_levels`, `calc_var_portfolios`,
`compute_integral` and refined levels; each rank saves what it got. Each
result is held against the JAX package's engine "grid_sharded" on a mesh
of the same shape (the conftest's 8 CPU devices) at atol 1e-12, or where
noted against its `xla` engine (JAX's own bar for its grid engine,
tests/test_sharded_engine.py), against the port in one process at
1e-12, and bit-equal across the ranks of a world. The flagship cut is
held to its record at 1e-9, the grid-sharded functions to JAX's, and a
world of one process to the one-card bits."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_grid_worker as gw
import _torch_parallel_worker as wk
from copula_var_tpu import backtest as jbt
from copula_var_tpu.copulas import fit as jcfit
from copula_var_tpu.data.returns import from_returns as jax_from_returns
from copula_var_tpu.models import fit as jmfit
from copula_var_tpu.ops.quadrature import CopulaSpec as JaxSpec
from copula_var_tpu.parallel import make_mesh as jax_make_mesh
from copula_var_tpu.parallel import quadrature as jpq
from copula_var_tpu_torch import parallel as par
from copula_var_tpu_torch.ops.quadrature import CopulaSpec
from copula_var_tpu_torch.parallel import distributed
from copula_var_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

ATOL_JAX = 1e-12  # tests/test_sharded_engine.py, grid engine vs xla
ATOL_RECORD = 1e-9  # tests/test_flagship.py:63
SHAPES = [s for shapes in gw.MESHES.values() for s in shapes]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{D: future of [rank results]} of spawned gloo worlds of 2 and 4
    ranks, started together and left running while the JAX side is
    computed."""
    tmp = tmp_path_factory.mktemp("grid_worlds")
    wk.cut_flagship(str(tmp))

    def run(D):
        path = str(tmp / f"w{D}_%d.npz")
        distributed.run_world(gw.rank_main, D, (path, str(tmp), D),
                              backend="gloo", device="cpu", timeout_s=120)
        return [dict(np.load(path % r)) for r in range(D)]

    pool = ThreadPoolExecutor(len(gw.MESHES))
    futures = {D: pool.submit(run, D) for D in gw.MESHES}
    yield futures
    pool.shutdown(wait=True)


def _ranks(worlds, shape):
    """Every rank's results on the mesh `shape`, keys without its tag."""
    D = shape[0] * shape[1]
    t = gw.tag(shape) + "/"
    return [{k[len(t):]: v for k, v in got.items() if k.startswith(t)}
            for got in worlds[D].result()]


@pytest.fixture(scope="module")
def one_process():
    return gw.serve(None)


@pytest.fixture(scope="module")
def jax_functions():
    """JAX's grid-sharded functions on the inputs the ranks get, at a
    (1, 4) mesh: the GARCH and MSM integrals and trap sweeps on
    `function_inputs` (Gaussian), the tcached sweep and trap sweep on
    `tcached_inputs` (dim-3 Student columns); and the MSM integrals with
    the day axis at (2, 2)."""
    a = gw.function_inputs()
    spec = JaxSpec("gaussian", (jnp.asarray(a["corr"]),))
    meshes = {s: jax_make_mesh(n_devices=4, axis_names=("days", "grid"),
                               shape=s) for s in ((1, 4), (2, 2))}
    m = meshes[1, 4]
    out = {"garch_integrals": jpq.grid_sharded_garch_integrals(
        m, a["bounds"], a["fv"], a["x"], a["dx"], a["w"], spec)}
    for shape, day, key in (((1, 4), None, "msm_integrals"),
                            ((2, 2), "days", "2x2/msm_integrals")):
        out[key] = jpq.grid_sharded_msm_integrals(
            meshes[shape], a["bounds"], a["fbs"], a["fcombos"], a["x"],
            a["dx"], a["dens"], a["uv"], a["w"], spec, day_axis=day)
    t0, p0, t1, p1 = jpq.grid_sharded_garch_transforms(a["fv"], a["x"], spec)
    out["garch_trap"] = jpq.grid_sharded_garch_trap_sweep(
        m, a["bounds"], t0, p0, t1, p1, a["x"], a["w"], spec)
    m0, m1, w0, w1 = jpq.grid_sharded_msm_transforms(
        a["fbs"], a["x"], a["dx"], a["dens"], a["uv"], spec)
    out["msm_trap"] = jpq.grid_sharded_msm_trap_sweep(
        m, a["bounds"], m0, m1, w0, w1, a["fcombos"], a["x"], a["w"], spec)
    t = gw.tcached_inputs()
    common = (m, t["bounds"], t["cols0"], t["cols_rest"], None, None,
              t["fcombos"], jnp.asarray(t["x"]))
    tail = (jnp.asarray(t["w"]), "student",
            (t["nu"], jnp.asarray(t["corr"])), "msm", 4)
    dens = jnp.asarray(t["dens"])
    out["tcached"] = jpq.grid_sharded_tcached_sweep(
        *common, jnp.asarray(t["dx"]), dens, *tail)
    out["tcached_trap"] = jpq.grid_sharded_tcached_trap_sweep(
        *common, dens, *tail)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def one_process_functions():
    """The port's grid-sharded functions on a (1, 1) mesh: the
    one-process series."""
    return gw.functions(_fake_grid(1), (1, 1))


FUNCTIONS = ["garch_integrals", "msm_integrals", "garch_trap", "msm_trap",
             "tcached", "tcached_trap"]


# first in the file: its set-up starts the worlds, and JAX's functions
# compile while they run
@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("shape", SHAPES, ids=gw.tag)
def test_grid_sharded_functions(worlds, jax_functions, one_process_functions,
                                shape, name):
    """The `grid_sharded_*` functions on every rank: against JAX's on the
    same inputs (at (1, 4); the MSM integrals with the day axis at
    (2, 2)), against the port's on a mesh of one at 1e-12, and bit-equal
    across the ranks."""
    key = f"fn/{name}"
    ranks = _ranks(worlds, shape)
    got = ranks[0][key]
    want = jax_functions.get(f"{gw.tag(shape)}/{name}",
                             jax_functions.get(name))
    assert want is not None, f"no JAX result for {name}"
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=ATOL_JAX)
    np.testing.assert_allclose(got, one_process_functions[key], rtol=1e-12,
                               atol=ATOL_JAX)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[key], got)


# -- the JAX side -------------------------------------------------------------

# (case, query) held against JAX's engine "grid_sharded" at each mesh
# shape; the rest against its `xla` engine, to which JAX holds its grid
# engine at the same 1e-12: the dim-2 MSM engine's compiles (JAX marks
# its own test of it slow, tests/test_sharded_engine.py:240) and each
# engine's separate compute_integral / portfolio / refine programs would
# not fit the file's time budget
GRID_ENGINE = ({("garch2", q) for q in ("var", "levels", "ports", "refined")}
               | {(c, q) for c in ("garch3", "msm3", "garch4")
                  for q in ("var", "levels")})


def _jax_backtest(case, shape, **kw):
    est, kind, dim, days, n, k = gw.CASES[case]
    data = jax_from_returns(wk.returns(dim, days),
                            [f"A{i}" for i in range(dim)], wk.N_IN,
                            wk.weights(dim))
    fit_cls = jmfit.MsmFit if est == "msm" else jmfit.GarchFit
    cfit_cls = jcfit.StudentFit if kind == "student" else jcfit.GaussianFit
    adapter = jbt.MsmAdapter(k=k) if est == "msm" else jbt.GarchAdapter()
    mesh = None if shape is None else jax_make_mesh(
        n_devices=shape[0] * shape[1], axis_names=("days", "grid"),
        shape=shape)
    return jbt.VaRBacktest(
        data, adapter, kind, num_points=n,
        engine="xla" if shape is None else "grid_sharded", mesh=mesh,
        model_fits_override=[fit_cls(**f) for f in wk.model_fits(est, dim)],
        copula_fit_override=cfit_cls(**wk.copula_fit(kind, dim)), **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """(case, query, shape) -> the JAX series: engine "grid_sharded" at
    `shape` for GRID_ENGINE, else the `xla` engine; backtests cached."""
    bts, cache = {}, {}

    def get(case, name, shape):
        if (case, name) not in GRID_ENGINE:
            shape = None
        key = (case, name, shape)
        if key not in cache:
            opts, call = gw.query(case, name)
            bkey = (case, shape, tuple(sorted(opts.items())))
            if bkey not in bts:
                bts[bkey] = _jax_backtest(case, shape, **opts)
            cache[key] = np.asarray(call(bts[bkey]))
        return cache[key]

    return get


# -- spawned worlds -------------------------------------------------------------


@pytest.mark.parametrize("query", gw.QUERIES)
@pytest.mark.parametrize("case", list(gw.CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=gw.tag)
def test_grid_sharded_equals_jax_and_one_process(worlds, jax_ref,
                                                 one_process, shape, case,
                                                 query):
    """Every rank returns the full series, bit-equal to rank 0's, within
    1e-12 of JAX's engine and of the port in one process."""
    want = jax_ref(case, query, shape)
    ranks = _ranks(worlds, shape)
    key = f"{case}/{query}"
    got = ranks[0][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(got, one_process[key], rtol=0, atol=ATOL_JAX)
    for r, other in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(other[key], got, err_msg=f"rank {r}")


@pytest.mark.parametrize("shape", SHAPES, ids=gw.tag)
def test_ranks_hold_their_outer_rows(worlds, shape):
    """Rank r at (r // g, r % g) holds rows [k n / g, (k + 1) n / g) of
    every case, k = r % g."""
    g = shape[1]
    for r, got in enumerate(_ranks(worlds, shape)):
        k = r % g
        want = [(k * c[4] // g, (k + 1) * c[4] // g)
                for c in gw.CASES.values()]
        np.testing.assert_array_equal(got["rows"], want)


@pytest.mark.parametrize("shape", SHAPES, ids=gw.tag)
def test_grid_sum_is_rank_ordered_and_equal_on_every_rank(worlds, shape):
    """`grid_sum` gives every grid rank the same bits: its ranks' values
    added in rank order."""
    d, g = shape
    ranks = _ranks(worlds, shape)
    for r, got in enumerate(ranks):
        row = [gw.grid_sum_input(a) for a in
               range((r // g) * g, (r // g + 1) * g)]
        want = row[0]
        for v in row[1:]:
            want = want + v
        np.testing.assert_array_equal(got["grid_sum"], want)


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_flagship_record_served_by_four_grid_ranks(worlds, est):
    """The flagship cut (n = 100, 25 outer rows per rank) at the record's
    bar, on every rank."""
    rec = np.load(os.path.join(wk.ROOT, "data", "flagship_var.npz"))
    want = rec[f"{est}_var"][:wk.FLAGSHIP_DAYS]
    for got in _ranks(worlds, (1, 4)):
        np.testing.assert_allclose(got[f"flagship/{est}"], want, rtol=0,
                                   atol=ATOL_RECORD)


def test_run_backtest_grid_sharded_engine(worlds):
    """engine="grid_sharded" over 4 ranks: each rank fits, rank 0's state
    is broadcast, and the series is the one-process pipeline's."""
    want = gw.config_run(None)
    for got in _ranks(worlds, (1, 4)):
        np.testing.assert_allclose(got["config/garch"], want, rtol=0,
                                   atol=ATOL_JAX)


# -- in this process ------------------------------------------------------------


@pytest.fixture
def world1(tmp_path):
    """A gloo world of one process (this one), left in teardown."""
    distributed.initialize(f"file://{tmp_path}/store", world_size=1,
                           rank=0, device="cpu")
    yield
    distributed.shutdown()


@pytest.mark.parametrize("case", ["msm2", "garch3"])
def test_grid_mesh_of_one_serves_the_one_process_bits(world1, one_process,
                                                      case):
    """A (1, 1) mesh over a gloo world of one: its grid group is the
    world, its rows all n, and every series the one-process bits."""
    mesh = make_mesh(device="cpu", axis_names=("days", "grid"),
                     shape=(1, 1))
    assert mesh.grid_group is not None and mesh.rows(24) == (0, 24)
    bt = gw.port_backtest(case, mesh)
    for name in ("levels", "ports", "integral"):
        np.testing.assert_array_equal(gw.query(case, name)[1](bt),
                                      one_process[f"{case}/{name}"])


def _fake_grid(g, rank=0):
    """Rank `rank` of a (1, g) grid mesh without a process group, for
    what runs before any collective."""
    dev = torch.device("cpu")
    return par.GridMesh((1, g), rank, None, par.DayMesh(None, 0, 1, dev),
                        None, dev)


def test_indivisible_num_points_is_refused():
    """JAX's "not divisible" refusal, from the backtest, the mesh and the
    functions (tests/test_sharded_engine.py, tests/test_parallel.py)."""
    mesh = _fake_grid(5)  # 24 % 5 != 0
    with pytest.raises(ValueError, match="not divisible"):
        gw.port_backtest("garch2", mesh).calc_var()
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rows(24)
    a = gw.function_inputs()
    spec = CopulaSpec("gaussian", (torch.as_tensor(a["corr"]),))
    with pytest.raises(ValueError, match="not divisible"):
        par.grid_sharded_garch_integrals(mesh, a["bounds"], a["fv"], a["x"],
                                         a["dx"], a["w"], spec)
    with pytest.raises(ValueError, match="not divisible"):
        par.grid_sharded_msm_integrals(mesh, a["bounds"], a["fbs"],
                                       a["fcombos"], a["x"], a["dx"],
                                       a["dens"], a["uv"], a["w"], spec)


def test_axis_names_other_than_the_meshs_are_refused():
    """The grid functions take JAX's axis-name arguments; a name that is
    not the mesh's ('grid', 'days') raises instead of being ignored."""
    mesh = _fake_grid(1)
    a = gw.function_inputs()
    spec = CopulaSpec("gaussian", (torch.as_tensor(a["corr"]),))
    with pytest.raises(ValueError, match="axes are 'grid' and 'days'"):
        par.grid_sharded_garch_integrals(mesh, a["bounds"], a["fv"], a["x"],
                                         a["dx"], a["w"], spec, axis="x")
    with pytest.raises(ValueError, match="axes are 'grid' and 'days'"):
        par.grid_sharded_msm_integrals(mesh, a["bounds"], a["fbs"],
                                       a["fcombos"], a["x"], a["dx"],
                                       a["dens"], a["uv"], a["w"], spec,
                                       day_axis="batch")


def test_make_grid_mesh_needs_its_world():
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(device="cpu", axis_names=("days", "grid"), shape=(1, 4))
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(device="cpu", axis_names=("days", "grid"))
    with pytest.raises(ValueError, match="axis_names"):
        make_mesh(device="cpu", axis_names=("grid", "days"), shape=(1, 1))
    mesh = make_mesh(device="cpu", axis_names=("grid",))
    assert mesh.shape == (1, 1) and mesh.grid_group is None
    t = torch.arange(4.0)
    assert mesh.grid_sum(t) is t


def test_grid_slab_budget_is_per_device():
    """JAX's per-device budget (backtest.py:1464-1473): a dim-4 grid that
    one device refuses is served once its slab fits."""
    from copula_var_tpu_torch.ops.quadrature import MAX_GRID_ELEMENTS_PER_DAY
    from copula_var_tpu_torch.ops.tcached import column_operands

    n = int(round(MAX_GRID_ELEMENTS_PER_DAY ** 0.25)) + 2  # n^4 > budget
    cols = (torch.zeros((1, 4, n), dtype=torch.float64),)
    x = torch.linspace(-5.0, 5.0, n, dtype=torch.float64)
    spec = CopulaSpec("gaussian", (torch.eye(4, dtype=torch.float64),))
    with pytest.raises(ValueError, match="transient budget"):
        column_operands(cols, x, x, spec, p_cols=cols[0])
    with pytest.raises(ValueError, match="per-device grid slab"):
        column_operands(cols, x, x, spec, p_cols=cols[0], rows=(0, n - 1))
    ops = column_operands(cols, x, x, spec, p_cols=cols[0], rows=(0, 8))
    assert ops.rows == (0, 8)


# -- the plain twins on a range of rows -----------------------------------------

SPLITS = [(0, 8), (8, 12), (12, 24)]  # uneven ranges of n = 24
RTOL_SPLIT = 1e-15  # the partials' sum against the whole sweep




@pytest.mark.parametrize("case", ["msm2", "garch2"])
def test_sweep_table_reference_of_rows_is_the_tables_rows(case):
    from copula_var_tpu_torch.ops import cuda_quadrature as cq

    bt = gw.port_backtest(case)
    full = bt.sweep_operands()
    P, flags = cq.sweep_table_reference(full)
    V = bt.adapter.day_tensors(bt.integration_inputs, bt.copula_spec)
    for i0, i1 in SPLITS:
        ops = bt.adapter.sweep_operands(V, bt.integration_inputs,
                                        rows=(i0, i1))
        assert ops.row0 == i0 and ops.V.shape[1] == i1 - i0
        p_r, f_r = cq.sweep_table_reference(ops)
        assert torch.equal(p_r, P[:, i0:i1]) and torch.equal(f_r,
                                                             flags[:, i0:i1])


def _bounds(T, L, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-6.0, -1.0, (L, T))
    lo[0] = -100.0  # a stage-1 row
    return torch.as_tensor(np.stack([lo, lo + rng.uniform(0.5, 4.0, (L, T))],
                                    -1))


@pytest.mark.parametrize("case", ["msm2", "garch2", "garch3", "msm3",
                                  "garch4"])
def test_plain_partials_of_a_split_add_up_to_the_sweep(case):
    """The plain twins' shares of uneven row ranges, summed, against the
    whole sweep at rtol 1e-15 (trap sweeps too); rows (0, n) give the
    whole sweep's bits."""
    from copula_var_tpu_torch.ops.cuda_solver import _routes
    from copula_var_tpu_torch.ops.refine import trap_sweep

    bt = gw.port_backtest(case)
    full = bt.sweep_operands()
    dim, T = bt.data.dim, bt.data.out_sample_n
    n = full.x.shape[0]
    splits = [(0, n // 3), (n // 3, n // 2), (n // 2, n)]
    inputs, spec = bt.integration_inputs, bt.copula_spec
    if dim == 2:
        V = bt.adapter.day_tensors(inputs, spec)

        def build(rows):
            return bt.adapter.sweep_operands(V, inputs, rows=rows)
    else:
        cols = bt.adapter.day_columns(inputs, spec)
        make = (bt.adapter.contract3_operands if dim == 3
                else bt.adapter.column_operands)

        def build(rows):
            return make(cols, inputs, spec, rows=rows)
    b = _bounds(T, 3)
    w = torch.as_tensor(np.stack([wk.weights(dim)] * 3))
    for sweep in (_routes(full, False)[0], trap_sweep):
        want = sweep(full, b, w)
        parts = [sweep(build(r), b, w) for r in splits]
        got = parts[0] + parts[1] + parts[2]
        torch.testing.assert_close(got, want, rtol=RTOL_SPLIT, atol=1e-300)
        assert torch.equal(sweep(build((0, n)), b, w), want)
