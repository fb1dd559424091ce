"""Generate the flagship record of the UKF mean-reverting family with the
JAX package.

The flagship configuration (`data/flagship.csv`, 2 assets, N = 1135
in-sample + T = 500 out-of-sample days, num_points = 100 on the box
(-5, 5), Student-t copula, obj_var = 0.05), fitted with the mean-reverting
family: `create_var_backtest(data, "mean_reverting", "student",
num_points=100, perturb_scale=0.0, seed=0)`. At perturb_scale = 0 the EM
draws nothing, so its optimum does not depend on a random stream and any
implementation of the same EM can be held to it.

Writes, on the CPU at f64 with the `xla` engine:
  * data/flagship_artifacts_mean_reverting.npz — fitted params
    (`save_artifacts`)
  * data/flagship_mr_var.npz — the (T,) VaR series + config + stats,
    with the keys of data/flagship_var.npz under the prefix
    "mean_reverting_"

Deterministic: re-running reproduces the artifacts byte for byte and the
VaR series to the bit (`mean_reverting_var_hash`); only the wall-clock
fields (`*_wall_s`, `*_prep_s`, `*_solve_s`) change. It takes about 30 s
on 8 CPU cores.

    python examples/make_mean_reverting_artifacts.py
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
PERTURB_SCALE = 0.0
SEED = 0
EST = "mean_reverting"


def main():
    from copula_var_tpu import data as data_mod
    from copula_var_tpu import stats
    from copula_var_tpu.backtest import create_var_backtest
    from copula_var_tpu.utils.artifacts import save_artifacts

    data = data_mod.from_csv(os.path.join(ROOT, "data", "flagship.csv"),
                             n_insample=N_INSAMPLE)
    assert data.dim == 2 and data.out_sample_n == 500
    t0 = time.time()
    bt = create_var_backtest(data, EST, "student", num_points=NUM_POINTS,
                             engine="xla", perturb_scale=PERTURB_SCALE,
                             seed=SEED)
    var = np.asarray(bt.calc_var(OBJ_VAR))
    wall = time.time() - t0
    assert np.all(np.isfinite(var))
    save_artifacts(
        os.path.join(ROOT, "data", f"flagship_artifacts_{EST}.npz"), bt)
    ptf = data.portfolio_out_sample()
    kup = stats.kupiec_pof(ptf, var, OBJ_VAR)
    chr_ = stats.christoffersen_conditional_coverage(ptf, var, OBJ_VAR)
    meta = dict(
        wall_s=round(wall, 1),
        prep_s=round(bt.prep_seconds, 1),
        solve_s=round(bt.solve_seconds, 2),
        exception_rate=float(stats.exception_rate(ptf, var)),
        kupiec_stat=float(kup.statistic), kupiec_p=float(kup.p_value),
        cc_stat=float(chr_.statistic), cc_p=float(chr_.p_value),
        var_hash=series_hash(var),
    )
    for f in bt.model_fits:
        print(f"fit: a {f.a!r} l {f.l!r} q {f.q!r} LL {f.log_likelihood!r}")
    print(f"{EST}: wall {wall:.1f}s  exc {meta['exception_rate']:.3f}"
          f"  kupiec p={meta['kupiec_p']:.3f}  cc p={meta['cc_p']:.3f}"
          f"  hash {meta['var_hash']}", flush=True)
    np.savez(
        os.path.join(ROOT, "data", "flagship_mr_var.npz"),
        mean_reverting_var=var, obj_var=OBJ_VAR, n_insample=N_INSAMPLE,
        num_points=NUM_POINTS, perturb_scale=PERTURB_SCALE, seed=SEED,
        **{f"{EST}_{k}": v for k, v in meta.items()},
    )
    print("saved data/flagship_mr_var.npz + flagship_artifacts_"
          f"{EST}.npz")


if __name__ == "__main__":
    main()
