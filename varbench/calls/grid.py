"""grid: `calc_var_grid(weights (P, dim), levels (L,))` on the book
loaded once in set-up -> (P L, T), rows portfolio-major."""

import numpy as np


def rows(request):
    """(weights (R, dim), levels (R,)) of the rows `serve` returns."""
    w, lv = request["weights"], request["levels"]
    return np.repeat(w, len(lv), axis=0), np.tile(lv, len(w))


def setup(program):
    program.bt = program.open_book()


def serve(program, request):
    with program.span("varbench.request"):
        out = program.bt.calc_var_grid(request["weights"],
                                       request["levels"])
    return out.reshape(-1, out.shape[-1])
