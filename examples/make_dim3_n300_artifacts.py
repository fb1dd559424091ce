"""Write the three-asset MSM book at 300 grid points per axis with the JAX
package: the benchmark's `d3-msm4-t-n300` book.

The book of `d3-msm4-t` (`data/dim3.csv`, the fits of
`data/dim3_artifacts_msm.npz`: MSM k = 4, Student-t) over all T = 500
out-of-sample days, with `num_points = 300` on the box (-5, 5). No fit
runs: the backtest is built from the committed fits
(`create_var_backtest(..., model_fits_override=...,
copula_fit_override=...)`), and only the integration inputs are rebuilt
at the new width. No VaR is solved: at T = 500 the dim-3 density on a
300-point grid is T n^3 = 1.35e10 cells. The XLA CPU settings are those
of `examples/make_wide_grid_records.py` (AVX, no FMA), whose
`dim3_msm_n300_ii_*` record these inputs on the first 8 days; the script
checks that the two agree there.

Writes varbench/books/dim3_n300_artifacts_msm.npz (`save_artifacts`).
Deterministic; it takes a few seconds on the CPU.

    python examples/make_dim3_n300_artifacts.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# sets JAX on the CPU, f64 and the record's XLA CPU ISA before JAX runs
from examples.make_wide_grid_records import (  # noqa: E402
    N_INSAMPLE, WEIGHTS3, artifact_fits,
)

import numpy as np  # noqa: E402

NUM_POINTS = 300
RECORD_TAG = "dim3_msm_n300"
OUT = os.path.join(ROOT, "varbench", "books", "dim3_n300_artifacts_msm.npz")


def main():
    from copula_var_tpu import data as data_mod
    from copula_var_tpu.backtest import create_var_backtest
    from copula_var_tpu.utils.artifacts import save_artifacts

    data = data_mod.from_csv(os.path.join(ROOT, "data", "dim3.csv"),
                             n_insample=N_INSAMPLE, weights=WEIGHTS3)
    assert data.dim == 3 and data.out_sample_n == 500
    fits, cfit, meta = artifact_fits(
        os.path.join(ROOT, "data", "dim3_artifacts_msm.npz"))
    bt = create_var_backtest(data, "msm", meta["copula"],
                             num_points=NUM_POINTS, engine="xla",
                             model_fits_override=fits,
                             copula_fit_override=cfit, k=4)
    rec = np.load(os.path.join(ROOT, "data", "wide_grid_var.npz"))
    days = int(rec["dim3_days"])
    for field, v in bt.integration_inputs._asdict().items():
        v, want = np.asarray(v), rec[f"{RECORD_TAG}_ii_{field}"]
        got = v[:days] if v.shape[0] == data.out_sample_n else v
        assert np.array_equal(got, want), field
    save_artifacts(OUT, bt)
    print(f"saved {os.path.relpath(OUT, ROOT)}", flush=True)


if __name__ == "__main__":
    main()
