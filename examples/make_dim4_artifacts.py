"""Generate the four-asset (dim-4) serving fixture with the JAX package.

Four index-like assets, N = 1135 in-sample + T = 500 out-of-sample days,
Student-t copula, MSM k = 4 (basin_iter 100, seed 0) and GARCH (p, q <=
3), obj_var = 0.05, unequal weights (0.4, 0.3, 0.2, 0.1). The JAX
package's transient budget (`ops/quadrature.py::_day_batch`, 2^26 cells
per day) caps the grid at num_points = 90 at dim 4, and one day of it
takes ~0.2 s per sweep on 8 CPU cores, so the full series is solved at
num_points = 32 and the widest grid on a 16-day cut.

Writes, on the CPU at f64 with the `xla` engine:
  * data/dim4.csv                     -- `date` + 4 adjusted-close columns
  * data/dim4_artifacts_{msm,garch}.npz -- fitted state at num_points = 32
    (`save_artifacts`)
  * data/dim4_var.npz, per family `{est}`:
      `{est}_var`      calc_var(0.05), all T = 500 days, num_points = 32,
                       with the coverage statistics and `{est}_var_hash`;
      `{est}_var90`    calc_var(0.05) at num_points = 90 on the first 16
                       days (`from_returns(returns[:N + 16], ...)`, the
                       same fits through `model_fits_override` /
                       `copula_fit_override`);
      `{est}_ptf`      calc_var_portfolios(PTF_ROWS, PTF_LEVELS) at
                       num_points = 32 on the first 16 days;
      `{est}_refined`  calc_var(0.05) with refine_root=True at
                       num_points = 32 on the first 8 days;
    and the configuration (weights, rows, levels, cuts).

XLA's CPU backend contracts a * b + c into a fused multiply-add where the
target has one, and where it does depends on how each program was fused:
at dim 4 the round weights and grid values put the inner cut exactly on
grid points, where the rounding of prev = x0 w1 + x1 w2 + x2 w3 decides
whether a cell is in, and a contracted prev flipped the last bisection
halving (2^-20) on a handful of days. So the script caps XLA's CPU ISA
at AVX (`--xla_cpu_max_isa=AVX`, no FMA): every operation is then
rounded as the program states it, on any machine.

Deterministic: the prices come from a seeded numpy process, and the fits
and solves run on the CPU, so re-running reproduces the csv and the
series to the bit (`*_hash`); only the wall-clock fields change. It takes
about 12 minutes on 8 CPU cores.

    python examples/make_dim4_artifacts.py
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from examples.flagship import series_hash  # noqa: E402
from examples.make_flagship_data import (  # noqa: E402
    N_PRICES, START, write_flagship_csv,
)

COLUMNS = ("SPX_SYN", "NDX_SYN", "RUT_SYN", "SX5E_SYN")
WEIGHTS = (0.4, 0.3, 0.2, 0.1)
N_INSAMPLE = 1135
OBJ_VAR = 0.05
NUM_POINTS = 32
NUM_POINTS_WIDE = 90  # the widest grid the budget serves at dim 4
DAYS_WIDE = 16  # days solved at NUM_POINTS_WIDE, and by the portfolio rows
DAYS_REFINED = 8
PTF_ROWS = ((0.25, 0.25, 0.25, 0.25), (0.1, 0.2, 0.3, 0.4))
PTF_LEVELS = (0.05, 0.01)


def dim4_prices():
    """Four index-like series: GARCH(1,1) volatility clustering per asset
    with a common gaussian factor (cross-correlations ~0.7-0.85)."""
    rng = np.random.default_rng(20090417)
    n = N_PRICES - 1
    z_c = rng.standard_normal(n)
    z_i = rng.standard_normal((4, n))
    lam = np.sqrt(np.array([0.88, 0.82, 0.76, 0.7]))[:, None]
    eps = lam * z_c[None, :] + np.sqrt(1.0 - lam**2) * z_i

    params = [  # omega, alpha, beta, mu (returns in x100 units)
        (0.020, 0.085, 0.895, 0.045),   # large-cap-like: vol ~1.0%
        (0.030, 0.095, 0.885, 0.055),   # tech-like: vol ~1.25%
        (0.045, 0.080, 0.890, 0.040),   # small-cap-like: vol ~1.4%
        (0.035, 0.090, 0.880, 0.030),   # euro-index-like: vol ~1.2%
    ]
    rets = np.zeros((4, n))
    for a, (om, al, be, mu) in enumerate(params):
        var = om / (1.0 - al - be)
        r2_prev, v_prev = var, var
        for t in range(n):
            v = om + al * r2_prev + be * v_prev
            r = np.sqrt(v) * eps[a, t]
            rets[a, t] = mu + r
            r2_prev, v_prev = r * r, v
    prices = 100.0 * np.exp(np.cumsum(
        np.concatenate([np.zeros((4, 1)), rets / 100.0], axis=1), axis=1
    ))
    return prices.T  # (N_PRICES, 4)


def main():
    import pandas as pd

    from copula_var_tpu import data as data_mod
    from copula_var_tpu import stats
    from copula_var_tpu.backtest import create_var_backtest
    from copula_var_tpu.utils.artifacts import save_artifacts

    csv = os.path.join(ROOT, "data", "dim4.csv")
    dates = pd.bdate_range(START, periods=N_PRICES).strftime("%Y-%m-%d")
    write_flagship_csv(dim4_prices(), list(dates), COLUMNS, csv)
    data = data_mod.from_csv(csv, n_insample=N_INSAMPLE, weights=WEIGHTS)
    assert data.dim == 4 and data.out_sample_n == 500
    print("in-sample return correlations:\n"
          f"{np.corrcoef(data.in_sample.T).round(3)}", flush=True)

    def cut(days):
        return data_mod.from_returns(
            data.returns[:N_INSAMPLE + days], data.tickers, N_INSAMPLE,
            weights=WEIGHTS)

    out = dict(obj_var=OBJ_VAR, n_insample=N_INSAMPLE,
               num_points=NUM_POINTS, num_points_wide=NUM_POINTS_WIDE,
               days_wide=DAYS_WIDE, days_refined=DAYS_REFINED, k=4,
               weights=np.asarray(WEIGHTS, np.float64),
               ptf_rows=np.asarray(PTF_ROWS, np.float64),
               ptf_levels=np.asarray(PTF_LEVELS, np.float64))
    for est in ("garch", "msm"):
        kw = dict(k=4, basin_iter=100, seed=0) if est == "msm" else {}
        t0 = time.time()
        bt = create_var_backtest(data, est, "student",
                                 num_points=NUM_POINTS, engine="xla", **kw)
        prep = time.time() - t0
        var = np.asarray(bt.calc_var(OBJ_VAR))
        wall = time.time() - t0
        assert np.all(np.isfinite(var)), est
        save_artifacts(
            os.path.join(ROOT, "data", f"dim4_artifacts_{est}.npz"), bt)
        ptf = data.portfolio_out_sample()
        kup = stats.kupiec_pof(ptf, var, OBJ_VAR)
        chr_ = stats.christoffersen_conditional_coverage(ptf, var, OBJ_VAR)
        over = dict(kw, model_fits_override=bt.model_fits,
                    copula_fit_override=bt.copula_fit)

        t1 = time.time()
        wide = create_var_backtest(cut(DAYS_WIDE), est, "student",
                                   num_points=NUM_POINTS_WIDE, engine="xla",
                                   **over)
        var90 = np.asarray(wide.calc_var(OBJ_VAR))
        wide_s = time.time() - t1
        del wide
        t1 = time.time()
        narrow = create_var_backtest(cut(DAYS_WIDE), est, "student",
                                     num_points=NUM_POINTS, engine="xla",
                                     **over)
        ptf_var = np.asarray(narrow.calc_var_portfolios(
            np.asarray(PTF_ROWS), obj_var=np.asarray(PTF_LEVELS)))
        refined = create_var_backtest(cut(DAYS_REFINED), est, "student",
                                      num_points=NUM_POINTS, engine="xla",
                                      refine_root=True, **over)
        ref_var = np.asarray(refined.calc_var(OBJ_VAR))
        cut_s = time.time() - t1
        for a in (var90, ptf_var, ref_var):
            assert np.all(np.isfinite(a)), est
        out.update({
            f"{est}_var": var, f"{est}_var90": var90, f"{est}_ptf": ptf_var,
            f"{est}_refined": ref_var,
            f"{est}_var_hash": series_hash(var),
            f"{est}_var90_hash": series_hash(var90),
            f"{est}_ptf_hash": series_hash(ptf_var),
            f"{est}_refined_hash": series_hash(ref_var),
            f"{est}_exception_rate": float(stats.exception_rate(ptf, var)),
            f"{est}_kupiec_stat": float(kup.statistic),
            f"{est}_kupiec_p": float(kup.p_value),
            f"{est}_cc_stat": float(chr_.statistic),
            f"{est}_cc_p": float(chr_.p_value),
            f"{est}_prep_s": round(prep, 1), f"{est}_wall_s": round(wall, 1),
            f"{est}_wide_s": round(wide_s, 1),
            f"{est}_cuts_s": round(cut_s, 1),
        })
        print(f"{est}: fit+prep {prep:.1f} s, T=500 at n={NUM_POINTS} "
              f"{wall - prep:.1f} s, n={NUM_POINTS_WIDE} on {DAYS_WIDE} days "
              f"{wide_s:.1f} s, portfolios + refined {cut_s:.1f} s; exc "
              f"{out[f'{est}_exception_rate']:.3f} kupiec p="
              f"{out[f'{est}_kupiec_p']:.3f} hash {out[f'{est}_var_hash']}",
              flush=True)

    np.savez(os.path.join(ROOT, "data", "dim4_var.npz"), **out)
    print("saved data/dim4.csv + dim4_var.npz + dim4 artifacts")


if __name__ == "__main__":
    main()
