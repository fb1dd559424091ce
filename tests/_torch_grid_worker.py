"""The grid-sharded worlds of `tests/test_torch_grid_sharded.py`: the
fixtures (numpy-seeded returns and fitted records of
`_torch_parallel_worker`, shared with the JAX side of the test), the
queries served through a ('days', 'grid') mesh, and the rank function
that `parallel.distributed.run_world` spawns. Imports the port and numpy
only, so a spawned rank starts without JAX."""

import os

import numpy as np
import torch

import _torch_parallel_worker as wk

# (family, copula, dim, days, num_points, k); every num_points divides
# over 2 and 4 grid ranks, and T = 16 over the 2-day axis of a (2, 2) mesh
CASES = {
    "msm2": wk.CASES["msm2"],  # MSM / Student, n = 24, T = 16
    "garch2": wk.CASES["garch2"],  # GARCH / Gaussian, n = 24
    "garch3": wk.CASES["garch3"],  # GARCH / Gaussian, dim 3, n = 12
    "msm3": ("msm", "student", 3, 8, 12, 2),
    "garch4": wk.CASES["garch4"],  # GARCH / Gaussian, dim 4, n = 8
}
# world size -> the mesh shapes its ranks serve, in order
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
QUERIES = ("var", "levels", "ports", "integral", "refined")
FN_T, FN_N = 6, 24  # the parallel functions' problem


def tag(shape):
    return f"{shape[0]}x{shape[1]}"


def grid_sum_input(rank):
    """Rank `rank`'s (3, 4) summand of the `grid_sum` check: magnitudes
    from 1e-17 to 1e17, so the order of the additions shows in the
    bits."""
    rng = np.random.default_rng(100 + rank)
    return rng.standard_normal((3, 4)) * np.array([1e-17, 1.0, 1e8, 1e17])


def port_backtest(case, mesh=None, device="cpu", **kw):
    return wk.port_backtest(CASES[case], mesh, device, **kw)


def query(case, name):
    """(backtest options, call) of query `name` on `case`."""
    dim, days = CASES[case][2], CASES[case][3]
    w_rows = wk.W_ROWS if dim == 2 else np.stack([wk.weights(dim),
                                                  wk.weights(dim)[::-1]])
    bounds = np.stack([np.full(days, -100.0), np.full(days, -3.0)], -1)
    return {
        "var": ({}, lambda bt: bt.calc_var(0.05)),
        "levels": ({}, lambda bt: bt.calc_var_levels(wk.LEVELS)),
        "ports": ({}, lambda bt: bt.calc_var_portfolios(w_rows,
                                                        [0.05, 0.01])),
        "integral": ({}, lambda bt: bt.compute_integral(bounds)),
        "refined": ({"refine_root": True},
                    lambda bt: bt.calc_var_levels((0.01, 0.05))),
    }[name]


def serve(mesh=None, device="cpu"):
    """Every case's queries -> {"case/query": array}; one backtest per
    case and refine option."""
    out = {}
    for case in CASES:
        bts = {}
        for name in QUERIES:
            opts, call = query(case, name)
            refine = opts.get("refine_root", False)
            if refine not in bts:
                bts[refine] = port_backtest(case, mesh, device,
                                            refine_root=refine)
            out[f"{case}/{name}"] = call(bts[refine])
    return out


def function_inputs(seed=0):
    """Numpy inputs of the grid-sharded functions: a dim-2 GARCH and MSM
    problem (T = FN_T days, n = FN_N points, q = 3 vol levels) and the
    dim-3 transform columns of the msm3 case."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-5.0, 5.0, FN_N)
    dx = np.full(FN_N, 10.0 / (FN_N - 1))
    uv = np.sort(rng.uniform(0.5, 2.0, (2, 3)), axis=1)
    x_d = x[None, :]
    dens = np.exp(-0.5 * (x_d[None] / uv[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * uv[:, :, None])
    fbs = rng.dirichlet(np.ones(3), size=(FN_T, 2))
    fcombos = (fbs[:, 0, :, None] * fbs[:, 1, None, :]).reshape(FN_T, 9)
    bounds = np.stack([np.full(FN_T, -100.0),
                       rng.uniform(-4.0, -1.0, FN_T)], -1)
    return dict(x=x, dx=dx, fv=rng.uniform(0.7, 1.5, (FN_T, 2)),
                fbs=fbs, fcombos=fcombos, dens=dens, uv=uv, bounds=bounds,
                w=np.array([0.6, 0.4]), corr=wk.corr(2))


def tcached_inputs():
    """Numpy inputs of the dim-3 grid-sharded tcached sweeps: the msm3
    backtest's Student transform columns (cols0 the dim-0 leaves (T, n),
    cols_rest dims 1.. (T, 2, n)), its forecast combos, grid, densities
    and weights, and bounds (-100, -2.5) on every day."""
    bt = port_backtest("msm3")
    ii = bt.integration_inputs
    cols = [c.numpy() for c in bt.adapter.day_columns(ii, bt.copula_spec)]
    T = bt.data.out_sample_n
    nu, corr = bt.copula_spec.params
    return dict(bounds=np.stack([np.full(T, -100.0), np.full(T, -2.5)], -1),
                cols0=tuple(c[:, 0] for c in cols),
                cols_rest=tuple(c[:, 1:] for c in cols),
                fcombos=ii.forecast_combos.numpy(), x=ii.x.numpy(),
                dx=ii.dx.numpy(), dens=ii.densities.numpy(),
                w=bt.weights.numpy(), nu=float(nu), corr=corr.numpy())


def functions(mesh, shape):
    """The grid-sharded functions of `parallel.quadrature` on this rank,
    Gaussian copula at dim 2, the msm3 backtest's Student columns at
    dim 3 -> {"fn/<name>": array}."""
    from copula_var_tpu_torch import parallel as par
    from copula_var_tpu_torch.ops.quadrature import CopulaSpec

    a = function_inputs()
    spec = CopulaSpec("gaussian", (torch.as_tensor(a["corr"]),))
    out = {
        "fn/garch_integrals": par.grid_sharded_garch_integrals(
            mesh, a["bounds"], a["fv"], a["x"], a["dx"], a["w"], spec),
        "fn/msm_integrals": par.grid_sharded_msm_integrals(
            mesh, a["bounds"], a["fbs"], a["fcombos"], a["x"], a["dx"],
            a["dens"], a["uv"], a["w"], spec,
            day_axis="days" if shape[0] > 1 else None),
    }
    t0, p0, t1, p1 = par.grid_sharded_garch_transforms(a["fv"], a["x"], spec)
    out["fn/garch_trap"] = par.grid_sharded_garch_trap_sweep(
        mesh, a["bounds"], t0, p0, t1, p1, a["x"], a["w"], spec)
    m0, m1, w0, w1 = par.grid_sharded_msm_transforms(
        a["fbs"], a["x"], a["dx"], a["dens"], a["uv"], spec)
    out["fn/msm_trap"] = par.grid_sharded_msm_trap_sweep(
        mesh, a["bounds"], m0, m1, w0, w1, a["fcombos"], a["x"], a["w"],
        spec)
    t = tcached_inputs()
    common = (mesh, t["bounds"], t["cols0"], t["cols_rest"], None, None,
              t["fcombos"], t["x"])
    tail = (t["w"], "student", (t["nu"], torch.as_tensor(t["corr"])),
            "msm", 4)
    out["fn/tcached"] = par.grid_sharded_tcached_sweep(
        *common, t["dx"], t["dens"], *tail)
    out["fn/tcached_trap"] = par.grid_sharded_tcached_trap_sweep(
        *common, t["dens"], *tail)
    return {k: v.cpu().numpy() for k, v in out.items()}


def config_run(n_ranks=None):
    """`config.run_backtest` of a GARCH(1, 1) / Gaussian config on a cut
    of the flagship CSV (300 in-sample days, 20 out), fitted on every
    rank; with `n_ranks` at engine "grid_sharded" over them."""
    from copula_var_tpu_torch import config
    from copula_var_tpu_torch.data import from_csv, from_returns

    full = from_csv(os.path.join(wk.ROOT, "data", "flagship.csv"), 1135)
    data = from_returns(full.returns[:320], full.tickers, 300)
    cfg = config.BacktestConfig(
        estimation_type="garch", copula_type="gaussian", n_insample=300,
        engine="xla" if n_ranks is None else "grid_sharded",
        n_mesh_devices=n_ranks)
    cfg.garch.p_max = cfg.garch.q_max = 1
    cfg.solver.obj_levels = (0.025, 0.05)
    return config.run_backtest(data, cfg, device="cpu")[1]


def rank_main(path, directory, size, device="cpu"):
    """One rank of a spawned gloo world of `size` ranks on `device`:
    serve every case through each mesh of MESHES[size] (at (1, 4) also
    the flagship cut, the grid-sharded functions and a grid-sharded
    `run_backtest`, on the CPU; the functions on every mesh), and save
    this rank's results and outer rows to `path` % rank."""
    from copula_var_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    meshes = [make_mesh(device=device, axis_names=("days", "grid"),
                        shape=s) for s in MESHES[size]]
    out = {}
    for shape, mesh in zip(MESHES[size], meshes):
        t = tag(shape)
        res = serve(mesh, device)
        if device == "cpu":
            res.update(functions(mesh, shape))
            if shape == (1, 4):
                res.update(wk.flagship(directory, mesh))
                res["config/garch"] = config_run(size)
        res["rows"] = np.array([mesh.rows(c[4]) for c in CASES.values()])
        res["grid_sum"] = mesh.grid_sum(torch.as_tensor(
            grid_sum_input(mesh.rank), device=mesh.device)).cpu().numpy()
        out.update({f"{t}/{k}": v for k, v in res.items()})
    np.savez(path % meshes[0].rank, **out)
