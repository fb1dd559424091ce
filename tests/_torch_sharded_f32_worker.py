"""The spawned worlds of `tests/test_torch_sharded_f32.py`: the fixtures
(numpy-seeded returns and fitted records, shared with the JAX side of
the test), the queries served through them on the f32 engine, the
inputs of the dim-3 sharded f32 functions, and the rank function that
`parallel.distributed.run_world` spawns. Imports the port and numpy
only, so a spawned rank starts without JAX."""

import numpy as np
import torch

N_IN = 150
LEVELS = (0.01, 0.05)
W_ROWS = {2: np.array([[0.3, 0.7], [0.8, 0.2]]),
          3: np.array([[1 / 3, 1 / 3, 1 / 3], [0.2, 0.3, 0.5]])}
WEIGHTS = {2: np.array([0.6, 0.4]), 3: np.array([0.5, 0.3, 0.2])}

# (family, copula, dim, days, num_points, k): tests/test_torch_f32_engine
# .py's sizes; the 4-day cases leave the last of 3 ranks no day
CASES = {
    "msm2": ("msm", "student", 2, 24, 32, 2),
    "garch2": ("garch", "gaussian", 2, 24, 32, None),
    "garch3": ("garch", "gaussian", 3, 12, 16, None),
    "msm3": ("msm", "student", 3, 12, 16, 2),
    "short2": ("msm", "student", 2, 4, 32, 2),
    "short3": ("garch", "gaussian", 3, 4, 16, None),
}


def returns(dim, days, seed=7):
    """(N_IN + days, dim) returns (tests/test_torch_f32_engine.py's)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 + 0.5 * np.abs(np.sin(np.arange(N_IN + days) / 17.0))
    return rng.standard_normal((N_IN + days, dim)) * scale[:, None]


def corr(dim):
    c = np.full((dim, dim), 0.4) + 0.6 * np.eye(dim)
    c[0, -1] = c[-1, 0] = 0.25
    return c


def model_fits(est, dim):
    """Per-asset fit fields (the names of both packages' records)."""
    if est == "msm":
        return [dict(m_0=0.5 + 0.05 * i, b=3.0 + i, gamma=0.5 - 0.05 * i,
                     sigma=1.0 + 0.1 * i, log_likelihood=0.0)
                for i in range(dim)]
    return [dict(p=1, q=1, omega=0.2 + 0.05 * i, alpha=np.array([0.1]),
                 beta=np.array([0.7 + 0.05 * i]), nll=0.0, bic=0.0,
                 params=np.array([0.2 + 0.05 * i, 0.1, 0.7 + 0.05 * i]))
            for i in range(dim)]


def copula_fit(kind, dim):
    c = corr(dim)
    rho = c[np.triu_indices(dim, 1)]
    if kind == "student":
        return dict(nu=6.0, corr_matrix=c, nll=0.0,
                    packed_params=np.concatenate([[6.0], rho]))
    return dict(corr_matrix=c, nll=0.0, packed_params=rho)


def port_backtest(case, mesh=None, **kw):
    """The port's f32-engine backtest of `case` on the CPU."""
    from copula_var_tpu_torch.backtest import create_var_backtest
    from copula_var_tpu_torch.copulas import fit as cfit
    from copula_var_tpu_torch.data import from_returns
    from copula_var_tpu_torch.models import fit as mfit

    est, kind, dim, days, n, k = CASES[case]
    data = from_returns(returns(dim, days), n_insample=N_IN,
                        weights=WEIGHTS[dim])
    fit_cls = mfit.MsmFit if est == "msm" else mfit.GarchFit
    cfit_cls = cfit.StudentFit if kind == "student" else cfit.GaussianFit
    extra = {"k": k} if est == "msm" else {"p_max": 1, "q_max": 1}
    return create_var_backtest(
        data, est, kind, num_points=n, device="cpu", mesh=mesh,
        engine="pallas",
        model_fits_override=[fit_cls(**f) for f in model_fits(est, dim)],
        copula_fit_override=cfit_cls(**copula_fit(kind, dim)), **kw,
        **extra)


def queries(case):
    """The queries served on `case`: name -> (backtest options, call)."""
    dim, days = CASES[case][2], CASES[case][3]
    rows = W_ROWS[dim]
    bounds = np.stack([np.full(days, -100.0), np.full(days, -3.0)], -1)
    return {
        "var": ({}, lambda bt: bt.calc_var(0.05)),
        "levels": ({}, lambda bt: bt.calc_var_levels(LEVELS)),
        "ports": ({}, lambda bt: bt.calc_var_portfolios(rows, [0.05, 0.01])),
        "grid": ({}, lambda bt: bt.calc_var_grid(rows, LEVELS)),
        "integral": ({}, lambda bt: bt.compute_integral(bounds)),
        "refined": ({"refine_root": True},
                    lambda bt: bt.calc_var_levels(LEVELS)),
        "refined_ports": ({"refine_root": True},
                          lambda bt: bt.calc_var_portfolios(rows, 0.05)),
        "quirks": ({"reference_quirks": True},
                   lambda bt: bt.calc_var_levels(LEVELS)),
    }


def serve(mesh=None, cases=tuple(CASES)):
    """Every case's queries on the f32 engine -> {"case/query": array}."""
    out = {}
    for case in cases:
        for name, (opts, call) in queries(case).items():
            bt = port_backtest(case, mesh,
                               refine_root=opts.get("refine_root", False))
            bt.reference_quirks = opts.get("reference_quirks", False)
            out[f"{case}/{name}"] = call(bt)
    return out


# -- the dim-3 functions (`parallel.quadrature.sharded_dim3_pallas_*`) -----

FN_T, FN_N, FN_Q = 7, 10, 2  # 7 days: blocks of 4 + 3, and 3 + 3 + 1
NU = 6.5
FN_STATE_L = 2


def function_inputs(family, seed=9):
    """Numpy inputs of a dim-3 Student case of both packages' f32
    functions: the raw inputs (fbs, vols, fcombos, densities for the MSM
    family; the forecast vols for the GARCH family), the grid, the
    weights, one bound set and a bisection state of L = 2 rows whose row
    1 lies below the grid on the first days (every halving's results
    there exactly 0)."""
    from copula_var_tpu_torch.ops.grids import garch_grid, msm_grid

    rng = np.random.default_rng(seed)
    T, n, q = FN_T, FN_N, FN_Q
    if family == "msm":
        x, dx = msm_grid(n)
        vols = np.sort(rng.uniform(0.5, 2.0, (3, q)), axis=1)
        raw = dict(
            fbs=rng.dirichlet(np.ones(q), size=(T, 3)), vols=vols,
            fcombos=rng.dirichlet(np.ones(q ** 3), size=T),
            densities=np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
                np.sqrt(2 * np.pi) * vols[:, :, None]))
    else:
        x, dx = garch_grid(n)
        raw = dict(fv=rng.uniform(0.6, 1.8, (T, 3)))
    lower, upper = np.full((FN_STATE_L, T), -7.5), np.zeros((FN_STATE_L, T))
    lower[1, :3], upper[1, :3] = -90.0, -60.0
    state = dict(lower=lower, upper=upper,
                 prev_result=np.zeros((FN_STATE_L, T)),
                 prev_upper=lower.copy(),
                 upper_stack=np.ones((FN_STATE_L, T), bool))
    bounds = np.stack([np.full(T, -100.0), np.full(T, -2.5)], -1)
    return dict(raw, x=x, dx=dx, weights=WEIGHTS[3], state=state,
                bounds=bounds)


def port_columns(family, a):
    """(cols, fcombos, densities) of the port's transform columns."""
    from copula_var_tpu_torch.ops import quadrature as tq

    t = torch.tensor
    spec = tq.CopulaSpec("student", (NU, t(corr(3))))
    if family == "msm":
        cols = tq.msm_day_columns(t(a["fbs"]), t(a["x"]), t(a["vols"]), spec)
        return cols, a["fcombos"], a["densities"], spec
    return tq.garch_day_columns(t(a["fv"]), t(a["x"]), spec), None, None, \
        spec


def functions(mesh):
    """The port's dim-3 f32 functions on this rank -> {"fn/<family>/
    <name>": array}, and the placed block's U-free operands' days."""
    from copula_var_tpu_torch import parallel as par

    out = {}
    solve = (-3.0, (-3.5, -2.0), 1e-6, -7.5, 0.0)
    for family in ("msm", "garch"):
        a = function_inputs(family)
        cols, fc, dens, spec = port_columns(family, a)
        ops, shared = par.place_dim3_cache(mesh, cols, fc, dens, a["x"],
                                           a["dx"], a["weights"], spec,
                                           family)
        key, tail = f"fn/{family}/", (family, "student")
        out[key + "block_z"] = ops.z.numpy()
        out[key + "integrals"] = par.sharded_dim3_pallas_integrals(
            mesh, a["bounds"], ops, shared, *tail).numpy()
        out[key + "bisect"] = par.sharded_dim3_pallas_bisection_solve_levels(
            mesh, ops, shared, *a["state"].values(), np.array(LEVELS), 1e-6,
            *tail).numpy()
        roots, nan_days = par.sharded_dim3_pallas_full_solve_levels(
            mesh, ops, shared, np.array(LEVELS), *solve, *tail, T=FN_T)
        out[key + "full"], out[key + "full_nan"] = roots, nan_days
        out[key + "full_ports"] = par.sharded_dim3_pallas_full_solve_levels(
            mesh, ops, shared, np.array(LEVELS), *solve, *tail,
            reference_quirks=True, weights_batch=W_ROWS[3])[0]
    return out


def rank_main(path, with_functions):
    """One rank of a spawned gloo world on the CPU: every case's queries
    on the f32 engine through the world's mesh (with `with_functions` the
    dim-3 functions too), saved with this rank's day blocks to `path` %
    rank."""
    from copula_var_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = serve(mesh)
    if with_functions:
        out.update(functions(mesh))
    out["blocks"] = np.array([mesh.day_block(c[3]) for c in CASES.values()])
    np.savez(path % mesh.rank, **out)
