"""The check that decides `correct`: the VaR series the timed requests
returned, against the plain reference worked again from the book's CSV
and artifacts on the same rows (portfolio, level).

Two numbers are compared, each with its limit from the configuration's
`limits` (its precision's guarantee):

  var_gap_max        the widest |program - reference| over the rows and
                     days where both are finite;
  nan_day_mismatch   the (row, day) cells that are NaN on one side only
                     (an exact comparison: limit 0).

With `work=True` the reference also counts, for each request, the work
its solve needs (`varbench/work/solve.py`), from the bounds of every
sweep it made.
"""

from __future__ import annotations

import numpy as np

from varbench.work import solve as work_mod

NUMBERS = ("var_gap_max", "nan_day_mismatch")


def check(bench, config: dict, mix: dict, kept, device: str, work=False):
    """({name: {"value", "limit"}}, work bound seconds summed over the
    kept requests or None, rows checked)."""
    ref = bench.reference(config)
    book = config["book"]
    model = ref.Book(str(bench.path(book["csv"])), int(book["n_insample"]),
                     str(bench.path(book["artifacts"])), device=device)
    call = bench.call(mix["call"])
    gap, mismatch, rows, bound = 0.0, 0, 0, 0.0
    for _, request, got in kept:
        weights, levels = call.rows(request)
        done = [0]

        def count(bounds, w):
            done[0] += work_mod.row_lookups(model.x, bounds, w,
                                            model.box_min)

        want, _ = ref.solve(model, weights, levels,
                            on_sweep=count if work else None)
        if got.shape != want.shape:
            mismatch += want.size
            continue
        both = np.isfinite(got) & np.isfinite(want)
        if both.any():
            gap = max(gap, float(np.max(np.abs(got[both] - want[both]))))
        mismatch += int(np.sum(np.isnan(got) != np.isnan(want)))
        rows += want.shape[0]
        if work:
            bound += work_mod.bound_seconds(work_mod.solve_work(
                model.T, model.n, model.dim, want.shape[0], done[0]))
    del model
    limits = config["limits"]
    numbers = {"var_gap_max": gap, "nan_day_mismatch": mismatch}
    return ({k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS},
            bound if work else None, rows)
