"""Faults planted under the timed path, and the control, for showing that
the check fails them. None of this runs in a benchmark run: the tests
(`varbench/tests/test_vb_broken.py`) and `varbench/readings.py` use it.

  control         the program's own lower-precision path: the engine that
                  the configuration names under `"control_engine"` (the
                  f32 engine, `"pallas"`, for a float64 book);
  stale_bisection the bisection returns its state unchanged: every root
                  is the midpoint of its stage-2 bracket;
  half_batch      only the first half of a request's rows is solved, and
                  its answers stand in for the rest (cells whose requests
                  have two rows or more);
  altered_answer  one day of one series moved by the bisection's
                  tolerance (1e-6) where the series is produced.

The cells run on one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("stale_bisection", "half_batch", "altered_answer")
VARIANTS = ("program", "control") + FAULTS
ALTERATION = 1e-6


def variants(bench, cell: str, mix_override=None) -> list:
    """The variants a cell can have: half_batch only where its requests
    have two rows or more."""
    from varbench.harness.traffic import Traffic

    c = bench.cell(cell)
    mix = {**bench.mix(c["traffic"]), **(mix_override or {})}
    dim = int(bench.config(c["config"])["assets"])
    rows = len(bench.call(mix["call"]).rows(
        Traffic(mix, dim, 0, "window").next())[1])
    return [v for v in VARIANTS if v != "half_batch" or rows >= 2]


@contextlib.contextmanager
def planted(variant: str):
    """The program with `variant`'s fault in place (none for "program"
    and "control"; the control is an engine, `engine_for`)."""
    from copula_var_tpu_torch import backtest
    from copula_var_tpu_torch.ops import cuda_solver

    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if variant == "stale_bisection":
        routes = cuda_solver._routes

        def stale_routes(ops, plain):
            sweep, _ = routes(ops, plain)

            def stale(ops, lower, upper, *args, **kwargs):
                return (lower + upper) / 2.0
            return sweep, stale
        patch(cuda_solver, "_routes", stale_routes)
    elif variant == "half_batch":
        solve = cuda_solver._full_solve

        def half(ops, obj, weights, *args, **kwargs):
            import torch

            L = obj.shape[0]
            h = max(1, L // 2)
            w = weights[:h] if weights.dim() == 2 else weights
            roots, nan_days = solve(ops, obj[:h], w, *args, **kwargs)
            take = torch.arange(L, device=roots.device) % h
            return roots[take], nan_days[take]
        patch(cuda_solver, "_full_solve", half)
    elif variant == "altered_answer":
        gather = backtest.VaRBacktest._gather

        def altered(self, roots, nan_days):
            out = gather(self, roots, nan_days).clone()
            out[0, min(7, out.shape[1] - 1)] += ALTERATION
            return out
        patch(backtest.VaRBacktest, "_gather", altered)
    elif variant not in ("program", "control"):
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def engine_for(variant: str, config: dict):
    """The engine a variant runs: the configuration's control engine for
    the control, else None (the configuration's own)."""
    return config["control_engine"] if variant == "control" else None
