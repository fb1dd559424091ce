"""Write the wide-grid and minimal-plugin records with the JAX package.

The JAX package's `xla` engine serves a dim-2 grid of any width and a
dim-3 grid up to its 2^26-cell budget (num_points <= 406). This script
records `calc_var(0.05)` at grids wider than the flagship's 100 points,
and the answer of a plugin adapter that holds only JAX's minimal
contract (`fit`, `marginals_densities`, `integration_inputs`,
`integrals`), which the JAX package serves by its host bisection.

Every backtest is built from a committed artifact's fits
(`create_var_backtest(..., model_fits_override=...,
copula_fit_override=...)`), so no fit runs; the integration inputs are
rebuilt at each width from those fits on a cut of the first days
(`from_returns(returns[:N + days], ...)`, as
`examples/make_dim4_artifacts.py` cuts). The solves run on the CPU at
f64 with the `xla` engine. XLA's CPU ISA is capped at AVX (no FMA), so
prev = x0 w1 (+ x1 w2) and the dynamic bounds round as the program
states them, as the port forms them (see `make_dim4_artifacts.py`).

Writes data/wide_grid_var.npz, per series `{tag}` (`dim2_{est}_n{n}`,
`dim3_{est}_n{n}`, `plugin_garch`):
  * `{tag}_var`            calc_var(0.05) on the cut's days;
  * `{tag}_ii_{field}`     the integration inputs at that width (the
                           fitted state a backtest at that width needs);
  * `{tag}_hash`           the series' hash;
and `plugin_garch_levels`, calc_var_levels(PLUGIN_LEVELS), plus the
configuration (widths, days, weights, obj_var, n_insample). Series:
  * dim 2, the flagship MSM (k = 4) and GARCH artifacts, Student-t, at
    num_points 180, 200 and 400, on the first 16 days;
  * dim 3, `data/dim3.csv` and its MSM and GARCH artifacts, weights
    (0.5, 0.3, 0.2), Student-t, at num_points 180 and 300, on the first
    8 days;
  * the plugin: the flagship GARCH artifact behind an adapter with only
    the four minimal methods, num_points 40, first 16 days.

Deterministic: re-running reproduces every series to the bit (`*_hash`);
only the `*_wall_s` fields change. It takes about 2 minutes on 8 CPU
cores (dim 3 at n = 300 is most of it).

    python examples/make_wide_grid_records.py
"""

import json
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

N_INSAMPLE = 1135
OBJ_VAR = 0.05
WEIGHTS3 = (0.5, 0.3, 0.2)
CASES = {
    # tag: (csv, artifact prefix, data weights, widths, days)
    "dim2": ("flagship.csv", "flagship_artifacts", None, (180, 200, 400), 16),
    "dim3": ("dim3.csv", "dim3_artifacts", WEIGHTS3, (180, 300), 8),
}
PLUGIN_POINTS = 40
PLUGIN_DAYS = 16
PLUGIN_LEVELS = (0.01, 0.05)


def artifact_fits(path):
    """(model fits, copula fit, meta) restored from a committed artifact."""
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


class MinimalGarch:
    """A plugin adapter with JAX's minimal contract only: the GARCH
    family's fit, marginals, integration inputs and uncached integrand,
    and no day_tensors / day_columns (so no cached path)."""

    name = "minimal_garch"

    def __init__(self, **kw):
        from copula_var_tpu.backtest import GarchAdapter

        self._inner = GarchAdapter(**kw)

    def fit(self, in_sample):
        return self._inner.fit(in_sample)

    def marginals_densities(self, in_sample, fits):
        return self._inner.marginals_densities(in_sample, fits)

    def integration_inputs(self, windows, fits, num_points, box=(-5.0, 5.0)):
        return self._inner.integration_inputs(windows, fits, num_points, box)

    def integrals(self, bounds, inputs, spec, weights, box_min=-5.0):
        return self._inner.integrals(bounds, inputs, spec, weights, box_min)


def _inputs(out, tag, bt):
    for field, v in bt.integration_inputs._asdict().items():
        out[f"{tag}_ii_{field}"] = np.asarray(v)


def main():
    from copula_var_tpu import data as data_mod
    from copula_var_tpu.backtest import create_var_backtest, register_adapter

    out = dict(obj_var=OBJ_VAR, n_insample=N_INSAMPLE,
               weights3=np.asarray(WEIGHTS3, np.float64),
               plugin_points=PLUGIN_POINTS, plugin_days=PLUGIN_DAYS,
               plugin_levels=np.asarray(PLUGIN_LEVELS, np.float64))
    for tag, (csv, prefix, weights, widths, days) in CASES.items():
        data = data_mod.from_csv(os.path.join(ROOT, "data", csv),
                                 n_insample=N_INSAMPLE, weights=weights)
        cut = data_mod.from_returns(data.returns[:N_INSAMPLE + days],
                                    data.tickers, N_INSAMPLE,
                                    weights=weights)
        out[f"{tag}_widths"] = np.asarray(widths)
        out[f"{tag}_days"] = days
        for est in ("msm", "garch"):
            fits, cfit, meta = artifact_fits(
                os.path.join(ROOT, "data", f"{prefix}_{est}.npz"))
            kw = dict(k=4) if est == "msm" else {}
            for n in widths:
                name = f"{tag}_{est}_n{n}"
                t0 = time.time()
                bt = create_var_backtest(
                    cut, est, meta["copula"], num_points=n, engine="xla",
                    model_fits_override=fits, copula_fit_override=cfit, **kw)
                var = np.asarray(bt.calc_var(OBJ_VAR))
                wall = time.time() - t0
                assert var.shape == (days,) and np.all(np.isfinite(var)), name
                _inputs(out, name, bt)
                out.update({f"{name}_var": var,
                            f"{name}_hash": series_hash(var),
                            f"{name}_wall_s": round(wall, 1)})
                print(f"{name}: {wall:.1f} s, VaR[:3] {var[:3]}", flush=True)

    # the minimal plugin adapter: JAX's host bisection over `integrals`
    register_adapter(MinimalGarch.name, MinimalGarch)
    data = data_mod.from_csv(os.path.join(ROOT, "data", "flagship.csv"),
                             n_insample=N_INSAMPLE)
    cut = data_mod.from_returns(data.returns[:N_INSAMPLE + PLUGIN_DAYS],
                                data.tickers, N_INSAMPLE)
    fits, cfit, meta = artifact_fits(
        os.path.join(ROOT, "data", "flagship_artifacts_garch.npz"))
    t0 = time.time()
    bt = create_var_backtest(cut, MinimalGarch.name, meta["copula"],
                             num_points=PLUGIN_POINTS, engine="xla",
                             model_fits_override=fits,
                             copula_fit_override=cfit)
    assert bt._cached_integral_fn() is None
    var = np.asarray(bt.calc_var(OBJ_VAR))
    levels = np.asarray(bt.calc_var_levels(PLUGIN_LEVELS))
    wall = time.time() - t0
    assert np.all(np.isfinite(var)) and np.all(np.isfinite(levels))
    _inputs(out, "plugin_garch", bt)
    out.update({"plugin_garch_var": var, "plugin_garch_levels": levels,
                "plugin_garch_hash": series_hash(var),
                "plugin_garch_levels_hash": series_hash(levels),
                "plugin_garch_wall_s": round(wall, 1)})
    print(f"plugin_garch: {wall:.1f} s, VaR[:3] {var[:3]}", flush=True)
    np.savez(os.path.join(ROOT, "data", "wide_grid_var.npz"), **out)
    print("saved data/wide_grid_var.npz", flush=True)


if __name__ == "__main__":
    main()
