"""The spawned world of `tests/test_torch_public_names.py`: numpy inputs
of the day-sharded dim-3 functions (`parallel.quadrature.
sharded_tcached_*`), shared with the JAX side of the test, and the rank
function that `parallel.distributed.run_world` spawns. Imports the port
and numpy only, so a spawned rank starts without JAX."""

import numpy as np
import torch

T, N, Q = 7, 10, 2  # 7 days over 2 ranks: blocks of 4 and 3
NU = 6.5
CORR = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35], [0.25, 0.35, 1.0]])
WEIGHTS = np.array([0.5, 0.3, 0.2])
W_ROWS = np.array([[0.5, 0.3, 0.2], [0.2, 0.3, 0.5]])
LEVELS = np.array([0.05, 0.01])
SOLVE = (-3.0, (-3.5, -2.0), 1e-6, -7.5, 0.0)
FAMILIES = ("msm", "garch")


def spec():
    from copula_var_tpu_torch.ops.quadrature import CopulaSpec

    return CopulaSpec("student", (NU, torch.tensor(CORR)))


def inputs(family, seed=9):
    """{cols, fcombos, densities, x, dx, state} of a dim-3 Student case:
    the transform columns the port builds (numpy leaves), and a
    bisection state of L = 2 rows."""
    from copula_var_tpu_torch.ops import quadrature as tq
    from copula_var_tpu_torch.ops.grids import garch_grid, msm_grid

    rng = np.random.default_rng(seed)
    t = torch.tensor
    if family == "msm":
        x, dx = msm_grid(N)
        vols = np.sort(rng.uniform(0.5, 2.0, (3, Q)), axis=1)
        dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
            np.sqrt(2 * np.pi) * vols[:, :, None])
        fbs = rng.dirichlet(np.ones(Q), size=(T, 3))
        cols = tuple(c.numpy() for c in tq.msm_day_columns(
            t(fbs), t(x), t(vols), spec()))
        extra = dict(fcombos=rng.dirichlet(np.ones(Q ** 3), size=T),
                     densities=dens)
    else:
        x, dx = garch_grid(N)
        tcols, p_cols = tq.garch_day_columns(
            t(rng.uniform(0.6, 1.8, (T, 3))), t(x), spec())
        cols = (tuple(c.numpy() for c in tcols), p_cols.numpy())
        extra = dict(fcombos=None, densities=None)
    lower, upper = np.full((2, T), -7.5), np.zeros((2, T))
    state = dict(lower=lower, upper=upper, prev_result=np.zeros((2, T)),
                 prev_upper=lower.copy(), upper_stack=np.ones((2, T), bool))
    return dict(cols=cols, x=x, dx=dx, state=state, **extra)


def functions(mesh):
    """The port's `sharded_tcached_*` on this rank ->
    {"<family>/<name>": array}."""
    from copula_var_tpu_torch import parallel as par

    out = {}
    for family in FAMILIES:
        a = inputs(family)
        common = (a["cols"], a["fcombos"], a["densities"], a["x"], a["dx"])
        bounds = np.stack([np.full(T, -100.0), np.full(T, -2.5)], -1)
        out[f"{family}/integrals"] = par.sharded_tcached_integrals(
            mesh, bounds, *common, WEIGHTS, spec(), family).numpy()
        out[f"{family}/bisect"] = par.sharded_tcached_bisection_solve_levels(
            mesh, *common, WEIGHTS, *a["state"].values(), LEVELS, 1e-6,
            spec(), family).numpy()
        roots, nan_days = par.sharded_tcached_full_solve_levels(
            mesh, *common, WEIGHTS, LEVELS, *SOLVE, spec(), family)
        out[f"{family}/full"], out[f"{family}/full_nan"] = roots, nan_days
        out[f"{family}/full_ports"] = par.sharded_tcached_full_solve_levels(
            mesh, *common, W_ROWS, LEVELS, *SOLVE, spec(), family,
            portfolios=True, refine=True, refine_h=0.05)[0]
        out[f"{family}/trap"] = par.sharded_tcached_trap_refine(
            mesh, a["cols"], a["fcombos"], a["densities"], a["x"], WEIGHTS,
            roots, LEVELS, 0.05, spec(), family)
    return out


def rank_main(path):
    """One rank of a spawned gloo world on the CPU: every function, saved
    to `path` % rank."""
    from copula_var_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    np.savez(path % mesh.rank, **functions(mesh))
