"""The day-sharded worlds of `tests/test_torch_parallel.py`: the fixtures
(numpy-seeded returns and fitted records, shared with the JAX side of the
test), the queries served through them, and the rank function that
`parallel.distributed.run_world` spawns. Imports the port and numpy only,
so a spawned rank starts without JAX."""

import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IN = 60
T_OUT = 16  # tests/test_sharded_engine.py::_data
LEVELS = (0.01, 0.025, 0.05)
W_ROWS = np.array([[0.3, 0.7], [0.8, 0.2]])
FLAGSHIP_DAYS = 12


def corr(dim, rho=0.45):
    c = np.full((dim, dim), rho)
    np.fill_diagonal(c, 1.0)
    return c


def returns(dim, t_out, seed=0):
    """(N_IN + t_out, dim) returns; at dim 2 those of
    tests/test_sharded_engine.py::_data."""
    rng = np.random.default_rng(seed)
    scale = np.linspace(1.0, 1.15, dim)
    return rng.multivariate_normal(np.zeros(dim), corr(dim),
                                   size=N_IN + t_out) * scale


def weights(dim):
    return np.array([0.6, 0.4]) if dim == 2 else np.linspace(
        0.4, 0.1, dim) / np.linspace(0.4, 0.1, dim).sum()


def model_fits(est, dim):
    """Per-asset fit fields (the names of both packages' records)."""
    if est == "msm":
        return [dict(m_0=0.45 + 0.1 * i, b=3.0 + 2 * i, gamma=0.5 - 0.2 * i,
                     sigma=1.0 + 0.15 * i, log_likelihood=0.0)
                for i in range(dim)]
    return [dict(p=1, q=1, omega=0.05 * (1 + i), alpha=np.array([0.08]),
                 beta=np.array([0.88 - 0.08 * i]), nll=0.0, bic=0.0,
                 params=np.array([0.05 * (1 + i), 0.08, 0.88 - 0.08 * i]))
            for i in range(dim)]


def copula_fit(kind, dim):
    c = corr(dim)
    rho = c[np.triu_indices(dim, 1)]
    if kind == "student":
        return dict(nu=6.0, corr_matrix=c, nll=0.0,
                    packed_params=np.concatenate([[6.0], rho]))
    return dict(corr_matrix=c, nll=0.0, packed_params=rho)


# (family, copula, dim, days, num_points, k): the fixtures the worlds serve
CASES = {
    "msm2": ("msm", "student", 2, T_OUT, 24, 2),
    "garch2": ("garch", "gaussian", 2, T_OUT, 24, None),
    "garch3": ("garch", "gaussian", 3, 8, 12, None),
    "garch4": ("garch", "gaussian", 4, 5, 8, None),
    # T = 4 over 3 ranks: blocks of 2, 2 and 0 days
    "short2": ("garch", "gaussian", 2, 4, 24, None),
}


def port_backtest(case, mesh=None, device="cpu", **kw):
    """The port's backtest of `case` (a name of CASES, or its tuple)."""
    from copula_var_tpu_torch.backtest import create_var_backtest
    from copula_var_tpu_torch.copulas import fit as cfit
    from copula_var_tpu_torch.data import from_returns
    from copula_var_tpu_torch.models import fit as mfit

    est, kind, dim, days, n, k = CASES[case] if isinstance(case, str) \
        else case
    data = from_returns(returns(dim, days), [f"A{i}" for i in range(dim)],
                        N_IN, weights(dim))
    fit_cls = mfit.MsmFit if est == "msm" else mfit.GarchFit
    cfit_cls = cfit.StudentFit if kind == "student" else cfit.GaussianFit
    extra = {} if k is None else {"k": k}
    return create_var_backtest(
        data, est, kind, num_points=n, device=device, mesh=mesh,
        model_fits_override=[fit_cls(**f) for f in model_fits(est, dim)],
        copula_fit_override=cfit_cls(**copula_fit(kind, dim)), **kw, **extra)


def queries(case):
    """The queries served on `case`: name -> (backtest options, call)."""
    dim, days = CASES[case][2], CASES[case][3]
    w_rows = W_ROWS if dim == 2 else np.stack([weights(dim),
                                               weights(dim)[::-1]])
    bounds = np.stack([np.full(days, -100.0), np.full(days, -3.0)], -1)
    return {
        "var": ({}, lambda bt: bt.calc_var(0.05)),
        "levels": ({}, lambda bt: bt.calc_var_levels(LEVELS)),
        "ports": ({}, lambda bt: bt.calc_var_portfolios(w_rows,
                                                        [0.05, 0.01])),
        "integral": ({}, lambda bt: bt.compute_integral(bounds)),
        "refined": ({"refine_root": True},
                    lambda bt: bt.calc_var_levels((0.01, 0.05))),
        "quirks": ({"reference_quirks": True},
                   lambda bt: bt.calc_var_levels((0.01, 0.05))),
    }


def serve(mesh=None, device="cpu"):
    """Every case's queries -> {"case/query": array}."""
    out = {}
    for case in CASES:
        for name, (opts, call) in queries(case).items():
            quirks = opts.get("reference_quirks", False)
            bt = port_backtest(case, mesh, device,
                               refine_root=opts.get("refine_root", False))
            bt.reference_quirks = quirks
            out[f"{case}/{name}"] = call(bt)
    return out


def cut_flagship(directory):
    """The flagship MSM and GARCH artifacts cut to their first
    FLAGSHIP_DAYS days, written to `directory`."""
    for est in ("msm", "garch"):
        z = np.load(os.path.join(ROOT, "data",
                                 f"flagship_artifacts_{est}.npz"))
        arrays = {k: z[k] for k in z.files}
        for k in ("ii_forecasts_by_states", "ii_forecast_combos",
                  "ii_forecast_vols"):
            if k in arrays:
                arrays[k] = arrays[k][:FLAGSHIP_DAYS]
        np.savez(os.path.join(directory, f"{est}.npz"), **arrays)


def flagship(directory, mesh=None):
    """The cut flagship artifacts in `directory` served on their
    FLAGSHIP_DAYS days -> {"flagship/<est>": (days,)}."""
    from copula_var_tpu_torch.data import from_csv, from_returns
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    full = from_csv(os.path.join(ROOT, "data", "flagship.csv"), 1135)
    data = from_returns(full.returns[:1135 + FLAGSHIP_DAYS], full.tickers,
                        1135)
    return {f"flagship/{est}": load_artifacts(
                os.path.join(directory, f"{est}.npz"), data, device="cpu",
                mesh=mesh).calc_var(0.05)
            for est in ("msm", "garch")}


def function_inputs(case):
    """Numpy inputs of the `parallel.quadrature` functions, from the
    port's unsharded backtest of a dim-2 case: its integration inputs and
    day tensors, one bound set and a bisection state (L = 2). Row 1's
    brackets lie below the grid on the first half of the days, so every
    halving's results there are exactly 0: a rank holding only such days
    would freeze the row, where all days together do not."""
    bt = port_backtest(case)
    ii = {k: v.numpy() for k, v in bt.integration_inputs._asdict().items()}
    T = bt.data.out_sample_n
    lower, upper = np.full((2, T), -7.5), np.zeros((2, T))
    lower[1, :T // 2], upper[1, :T // 2] = -90.0, -60.0
    state = dict(lower=lower, upper=upper, prev_result=np.zeros((2, T)),
                 prev_upper=lower.copy(), upper_stack=np.ones((2, T), bool))
    return dict(ii, weights=np.asarray(bt.data.weights), state=state,
                bounds=np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1),
                day_tensors=bt.adapter.day_tensors(
                    bt.integration_inputs, bt.copula_spec).numpy(),
                spec=bt.copula_spec)


def functions(mesh):
    """The `parallel.quadrature` functions on the dim-2 cases ->
    {"fn/<case>/<name>": array}."""
    from copula_var_tpu_torch import parallel as par

    out = {}
    for case in ("msm2", "garch2"):
        a = function_inputs(case)
        msm = case.startswith("msm")
        fc, dens = ((a["forecast_combos"], a["densities"]) if msm
                    else (None, None))
        key = f"fn/{case}/"
        if msm:
            ints, mean = par.sharded_msm_step(
                mesh, a["bounds"], a["forecasts_by_states"], fc, a["x"],
                a["dx"], dens, a["unique_vols"], a["weights"], a["spec"])
            out[key + "mean"] = mean.numpy()
        else:
            ints = par.sharded_garch_step(mesh, a["bounds"],
                                          a["forecast_vols"], a["x"],
                                          a["dx"], a["weights"], a["spec"])
        out[key + "step"] = ints.numpy()
        out[key + "cached"] = par.sharded_cached_step(
            mesh, a["bounds"], a["day_tensors"], fc, a["x"], a["dx"], dens,
            a["weights"]).numpy()
        common = (mesh, a["day_tensors"], fc, dens, a["x"], a["dx"])
        st = a["state"]
        out[key + "bisect_levels"] = par.sharded_bisection_solve_levels(
            *common, a["weights"], *st.values(), [0.01, 0.05],
            1e-6).numpy()
        out[key + "bisect"] = par.sharded_bisection_solve(
            *common, a["weights"], *(v[1] for v in st.values()), 0.05,
            1e-6).numpy()
        solve = (-3.0, (-3.5, -2.0), 1e-6, -7.5, 0.0)
        out[key + "full_levels"] = par.sharded_full_solve_levels(
            *common, a["weights"], [0.01, 0.05], *solve, refine=True,
            refine_h=0.05)[0]
        out[key + "full_ports"] = par.sharded_full_solve_portfolios(
            *common, W_ROWS, [0.05, 0.01], *solve,
            reference_quirks=True)[0]
    return out


def config_run(mesh=None):
    """`config.run_backtest` of a GARCH(1, 1) / Gaussian config on a
    cut of the flagship CSV (300 in-sample days, 20 out), fitted on
    every rank; with a mesh at engine "sharded" over it."""
    from copula_var_tpu_torch import config
    from copula_var_tpu_torch.data import from_csv, from_returns

    full = from_csv(os.path.join(ROOT, "data", "flagship.csv"), 1135)
    data = from_returns(full.returns[:320], full.tickers, 300)
    cfg = config.BacktestConfig(
        estimation_type="garch", copula_type="gaussian", n_insample=300,
        engine="xla" if mesh is None else "sharded",
        n_mesh_devices=None if mesh is None else mesh.size)
    cfg.garch.p_max = cfg.garch.q_max = 1
    cfg.solver.obj_levels = (0.025, 0.05)
    return config.run_backtest(data, cfg, device="cpu")[1]


def rank_main(path, directory, with_extras, device="cpu"):
    """One rank of a spawned gloo world on `device`: serve every case
    (and with `with_extras` the flagship cut, the `parallel.quadrature`
    functions and a sharded `run_backtest`, on the CPU) through the
    world's mesh, and save this rank's results, its day blocks and
    `process_info` to `path` % rank."""
    from copula_var_tpu_torch.parallel import distributed, make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(device=device)
    out = serve(mesh, device)
    if with_extras:
        out.update(flagship(directory, mesh))
        out.update(functions(mesh))
        out["config/garch"] = config_run(mesh)
    info = distributed.process_info()
    out["blocks"] = np.array([mesh.day_block(CASES[c][3]) for c in CASES])
    out["info"] = np.array([info[k] for k in sorted(info)])
    np.savez(path % mesh.rank, **out)
