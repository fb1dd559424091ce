"""Generate the three-asset (dim-3) serving fixture with the JAX package.

The flagship configuration in every dimension but the asset count:
3 assets, N = 1135 in-sample + T = 500 out-of-sample days,
num_points = 100 on the box (-5, 5), Student-t copula, MSM k = 4 and
GARCH, obj_var = 0.05, and unequal portfolio weights (0.5, 0.3, 0.2) so
that the pairing of weights with grid axes shows in the VaR.

Writes, on the CPU at f64 with the `xla` engine:
  * data/dim3.csv                    — `date` + 3 adjusted-close columns
  * data/dim3_artifacts_{msm,garch}.npz — fitted params (`save_artifacts`)
  * data/dim3_var.npz                — both (T,) VaR series + config + stats

Deterministic: the prices come from a seeded numpy process, and the fits
and solves run on the CPU, so re-running reproduces the csv and the
artifacts byte for byte and the VaR series to the bit (`*_var_hash`);
only the wall-clock fields of dim3_var.npz (`*_wall_s`, `*_prep_s`,
`*_solve_s`) change. It takes about 5 minutes on 8 CPU cores.

    python examples/make_dim3_artifacts.py
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
from examples.make_flagship_data import (  # noqa: E402
    N_PRICES, START, write_flagship_csv,
)

COLUMNS = ("SPX_SYN", "NDX_SYN", "RUT_SYN")
WEIGHTS = (0.5, 0.3, 0.2)
N_INSAMPLE = 1135
OBJ_VAR = 0.05


def dim3_prices():
    """Three index-like series: GARCH(1,1) volatility clustering per
    asset with a common gaussian factor (cross-correlation ~0.8)."""
    rng = np.random.default_rng(20090416)
    n = N_PRICES - 1
    z_c = rng.standard_normal(n)
    z_i = rng.standard_normal((3, n))
    lam = np.sqrt(np.array([0.85, 0.8, 0.7]))[:, None]
    eps = lam * z_c[None, :] + np.sqrt(1.0 - lam**2) * z_i

    params = [  # omega, alpha, beta, mu (returns in x100 units)
        (0.020, 0.085, 0.895, 0.045),   # large-cap-like: vol ~1.0%
        (0.030, 0.095, 0.885, 0.055),   # tech-like: vol ~1.25%
        (0.045, 0.080, 0.890, 0.040),   # small-cap-like: vol ~1.4%
    ]
    rets = np.zeros((3, n))
    for a, (om, al, be, mu) in enumerate(params):
        var = om / (1.0 - al - be)
        r2_prev, v_prev = var, var
        for t in range(n):
            v = om + al * r2_prev + be * v_prev
            r = np.sqrt(v) * eps[a, t]
            rets[a, t] = mu + r
            r2_prev, v_prev = r * r, v
    prices = 100.0 * np.exp(np.cumsum(
        np.concatenate([np.zeros((3, 1)), rets / 100.0], axis=1), axis=1
    ))
    return prices.T  # (N_PRICES, 3)


def main():
    import pandas as pd

    from copula_var_tpu import data as data_mod
    from copula_var_tpu import stats
    from copula_var_tpu.backtest import create_var_backtest
    from copula_var_tpu.utils.artifacts import save_artifacts

    csv = os.path.join(ROOT, "data", "dim3.csv")
    dates = pd.bdate_range(START, periods=N_PRICES).strftime("%Y-%m-%d")
    write_flagship_csv(dim3_prices(), list(dates), COLUMNS, csv)
    data = data_mod.from_csv(csv, n_insample=N_INSAMPLE, weights=WEIGHTS)
    assert data.dim == 3 and data.out_sample_n == 500

    results, meta = {}, {}
    for est in ("garch", "msm"):
        kw = dict(k=4, basin_iter=100, seed=0) if est == "msm" else {}
        t0 = time.time()
        bt = create_var_backtest(
            data, est, "student", num_points=100, engine="xla", **kw
        )
        var = np.asarray(bt.calc_var(OBJ_VAR))
        wall = time.time() - t0
        assert np.all(np.isfinite(var)), est
        results[est] = var
        save_artifacts(
            os.path.join(ROOT, "data", f"dim3_artifacts_{est}.npz"), bt
        )
        ptf = data.portfolio_out_sample()
        kup = stats.kupiec_pof(ptf, var, OBJ_VAR)
        chr_ = stats.christoffersen_conditional_coverage(ptf, var, OBJ_VAR)
        meta[est] = dict(
            wall_s=round(wall, 1),
            prep_s=round(bt.prep_seconds, 1),
            solve_s=round(bt.solve_seconds, 2),
            exception_rate=float(stats.exception_rate(ptf, var)),
            kupiec_stat=float(kup.statistic), kupiec_p=float(kup.p_value),
            cc_stat=float(chr_.statistic), cc_p=float(chr_.p_value),
            var_hash=series_hash(var),
        )
        print(f"{est}: wall {wall:.1f}s  exc {meta[est]['exception_rate']:.3f}"
              f"  kupiec p={meta[est]['kupiec_p']:.3f}"
              f"  cc p={meta[est]['cc_p']:.3f}  hash {meta[est]['var_hash']}",
              flush=True)

    np.savez(
        os.path.join(ROOT, "data", "dim3_var.npz"),
        garch_var=results["garch"], msm_var=results["msm"],
        obj_var=OBJ_VAR, n_insample=N_INSAMPLE, num_points=100, k=4,
        weights=np.asarray(WEIGHTS, np.float64),
        **{f"{e}_{k}": v for e, m in meta.items() for k, v in m.items()},
    )
    print("saved data/dim3.csv + dim3_var.npz + dim3 artifacts")


if __name__ == "__main__":
    main()
