"""Write the `reference_quirks` fit record of the flagship and the default
Student-t fixture with the JAX package.

`reference_quirks=True` replays the reference optimizers' own
trajectories: GARCH by finite-difference Newton with `np.linalg.pinv`
steps from one start per (p, q) pair (its defective mixed-partial
stencil included), MSM by the minimum final log-likelihood over the
basin starts with no polish. Both are deterministic (MSM at
basin_iter = 0), so any implementation of the same trajectory can be
held to them.

Writes data/flagship_quirk_fits.npz, on the CPU at f64 with the `xla`
engine, from the flagship in-sample (`data/flagship.csv`, N = 1135):
  * `garch_p`, `garch_q`, `garch_params` (rows [omega, alpha..., beta...]
    zero-padded to 7), `garch_nll`, `garch_bic`: `fit_garch_batch(...,
    reference_quirks=True)` at the GARCH adapter's defaults (p, q <= 3,
    max_iter 200, tol 1e-10, eps 1e-5), both assets;
  * `msm_params` (rows [m_0, b, gamma, sigma]), `msm_ll`:
    `fit_msm_batch(..., k=4, basin_iter=0, reference_quirks=True)`;
  * `garch_quirk_var`, the quirk pipeline's VaR:
    `create_var_backtest(data, "garch", "student", num_points=100,
    reference_quirks=True)`, then `VaRBacktest.reference_quirks = True`
    and `calc_var(0.05)`; with its copula fit (`quirk_copula_nu`,
    `quirk_copula_packed`);
  * `student_marginals`, `student_densities`:
    `generate_student_t_copula_data()` at its defaults (n = 100000,
    nu = 5, rho = 0.5, top_n = 1000).

Deterministic: re-running reproduces every array to the bit; only the
`*_wall_s` fields change. It takes about 2 minutes on 8 CPU cores.

    python examples/make_quirk_records.py
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from examples.flagship import series_hash  # noqa: E402

N_INSAMPLE = 1135
NUM_POINTS = 100
OBJ_VAR = 0.05
GARCH = dict(p_max=3, q_max=3, max_iter=200, tol=1e-10, eps=1e-5)
MSM = dict(k=4, basin_iter=0)
PARAMS_WIDTH = 7  # 1 + p_max + q_max


def main():
    from copula_var_tpu import data as data_mod
    from copula_var_tpu.backtest import create_var_backtest
    from copula_var_tpu.copulas.student_sampler import (
        generate_student_t_copula_data,
    )
    from copula_var_tpu.models import fit as mfit

    data = data_mod.from_csv(os.path.join(ROOT, "data", "flagship.csv"),
                             n_insample=N_INSAMPLE)
    out = dict(obj_var=OBJ_VAR, n_insample=N_INSAMPLE, num_points=NUM_POINTS,
               k=MSM["k"], basin_iter=MSM["basin_iter"],
               **{f"garch_{k}": v for k, v in GARCH.items()})

    t0 = time.time()
    gfits = mfit.fit_garch_batch(data.in_sample, reference_quirks=True,
                                 **GARCH)
    out["garch_wall_s"] = round(time.time() - t0, 1)
    out["garch_p"] = np.array([f.p for f in gfits])
    out["garch_q"] = np.array([f.q for f in gfits])
    out["garch_params"] = np.stack([
        np.pad(f.params, (0, PARAMS_WIDTH - len(f.params))) for f in gfits])
    out["garch_nll"] = np.array([f.nll for f in gfits])
    out["garch_bic"] = np.array([f.bic for f in gfits])
    print(f"garch quirk fits: {[(f.p, f.q, f.nll) for f in gfits]}, "
          f"{out['garch_wall_s']} s", flush=True)

    t0 = time.time()
    mfits = mfit.fit_msm_batch(data.in_sample, MSM["k"],
                               basin_iter=MSM["basin_iter"],
                               reference_quirks=True)
    out["msm_wall_s"] = round(time.time() - t0, 1)
    out["msm_params"] = np.array([[f.m_0, f.b, f.gamma, f.sigma]
                                  for f in mfits])
    out["msm_ll"] = np.array([f.log_likelihood for f in mfits])
    print(f"msm quirk fits: {out['msm_params'].tolist()}, "
          f"{out['msm_wall_s']} s", flush=True)

    t0 = time.time()
    bt = create_var_backtest(data, "garch", "student",
                             num_points=NUM_POINTS, engine="xla",
                             reference_quirks=True)
    bt.reference_quirks = True
    var = np.asarray(bt.calc_var(OBJ_VAR))
    out["quirk_wall_s"] = round(time.time() - t0, 1)
    for f, g in zip(bt.model_fits, gfits):  # the pipeline fits the same
        assert (f.p, f.q) == (g.p, g.q) and np.array_equal(f.params,
                                                           g.params)
    assert np.all(np.isfinite(var))
    out["garch_quirk_var"] = var
    out["garch_quirk_var_hash"] = series_hash(var)
    out["quirk_copula_nu"] = float(bt.copula_fit.nu)
    out["quirk_copula_packed"] = np.asarray(bt.copula_fit.packed_params)
    print(f"garch quirk pipeline: VaR {var.shape}, nu "
          f"{out['quirk_copula_nu']}, {out['quirk_wall_s']} s", flush=True)

    t0 = time.time()
    marg, dens = generate_student_t_copula_data()
    out["student_wall_s"] = round(time.time() - t0, 1)
    out["student_marginals"], out["student_densities"] = marg, dens
    print(f"student fixture: {marg.shape}, {out['student_wall_s']} s",
          flush=True)

    np.savez(os.path.join(ROOT, "data", "flagship_quirk_fits.npz"), **out)
    print("saved data/flagship_quirk_fits.npz")


if __name__ == "__main__":
    main()
