"""Write the `refine_root` records of the flagship and the dim-3 fixture
with the JAX package.

`refine_root=True` re-solves each day's staircase root in a +-h window
against the second-order (trapezoid, fractional boundary cell) sweep of
the same integrand. Each backtest is built from the committed artifacts'
fits (`create_var_backtest(..., model_fits_override=...,
copula_fit_override=..., refine_root=True)`), so no fit runs, and solved
on the CPU at f64 with the `xla` engine (the in-program refine).

Writes:
  * data/flagship_refined_var.npz — MSM and GARCH (2 assets, T = 500,
    num_points = 100, Student-t): `{est}_levels`, `calc_var_levels((0.01,
    0.05))`, and `{est}_portfolios`, `calc_var_portfolios([[0.5, 0.5],
    [0.3, 0.7]], 0.05)`;
  * data/dim3_refined_var.npz — the same for the dim-3 fixture (weights
    (0.5, 0.3, 0.2)): `calc_var_levels((0.05,))` and
    `calc_var_portfolios([[0.5, 0.3, 0.2], [0.2, 0.3, 0.5]], 0.05)`.

Each file also holds the levels, the portfolio weights, obj_var,
n_insample, num_points and the series' hashes (`*_hash`). Deterministic:
re-running reproduces the series to the bit; only the `*_wall_s` fields
change. It takes about 13 minutes on 8 CPU cores (dim 3 is most of it).

    python examples/make_refined_records.py
"""

import json
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
CASES = {
    # record: (csv, artifact prefix, data weights, levels, portfolio rows)
    "flagship_refined_var.npz": (
        "flagship.csv", "flagship_artifacts", None, (0.01, 0.05),
        ((0.5, 0.5), (0.3, 0.7))),
    "dim3_refined_var.npz": (
        "dim3.csv", "dim3_artifacts", (0.5, 0.3, 0.2), (0.05,),
        ((0.5, 0.3, 0.2), (0.2, 0.3, 0.5))),
}


def artifact_fits(path):
    """(model fits, copula fit) restored from a committed artifact."""
    from copula_var_tpu.copulas import fit as copula_fit_mod
    from copula_var_tpu.models import fit as model_fit_mod
    from copula_var_tpu.utils.artifacts import _restore

    meta = json.loads(str(np.load(path)["meta"]))
    fit_cls = getattr(model_fit_mod, meta["fit_type"])
    fits = [fit_cls(**{k: _restore(v) for k, v in f.items()})
            for f in meta["model_fits"]]
    cfit = getattr(copula_fit_mod, meta["copula_fit_type"])(
        **{k: _restore(v) for k, v in meta["copula_fit"].items()})
    return fits, cfit, meta


def main():
    from copula_var_tpu import data as data_mod
    from copula_var_tpu.backtest import create_var_backtest

    for record, (csv, prefix, weights, levels, rows) in CASES.items():
        data = data_mod.from_csv(os.path.join(ROOT, "data", csv),
                                 n_insample=N_INSAMPLE, weights=weights)
        out = dict(levels=np.asarray(levels, np.float64),
                   portfolio_weights=np.asarray(rows, np.float64),
                   obj_var=OBJ_VAR, n_insample=N_INSAMPLE,
                   num_points=NUM_POINTS)
        for est in ("msm", "garch"):
            fits, cfit, meta = artifact_fits(
                os.path.join(ROOT, "data", f"{prefix}_{est}.npz"))
            kw = dict(k=4) if est == "msm" else {}
            t0 = time.time()
            bt = create_var_backtest(
                data, est, meta["copula"], num_points=NUM_POINTS,
                engine="xla", model_fits_override=fits,
                copula_fit_override=cfit, refine_root=True, **kw)
            lv = np.asarray(bt.calc_var_levels(levels))
            pf = np.asarray(bt.calc_var_portfolios(np.asarray(rows),
                                                   obj_var=OBJ_VAR))
            wall = time.time() - t0
            assert np.all(np.isfinite(lv)) and np.all(np.isfinite(pf)), est
            out.update({f"{est}_levels": lv, f"{est}_portfolios": pf,
                        f"{est}_levels_hash": series_hash(lv),
                        f"{est}_portfolios_hash": series_hash(pf),
                        f"{est}_wall_s": round(wall, 1)})
            print(f"{record} {est}: levels {lv.shape}, portfolios "
                  f"{pf.shape}, wall {wall:.1f} s", flush=True)
        np.savez(os.path.join(ROOT, "data", record), **out)
        print(f"saved data/{record}", flush=True)


if __name__ == "__main__":
    main()
