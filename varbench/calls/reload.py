"""reload: a book that changed. Each request reads the CSV with its own
portfolio (`from_csv(csv, n_insample, weights)`), loads the artifacts,
preps (`sweep_operands`) and solves `calc_var(level)` -> (1, T); the
book is released before the next request, so one book is resident."""


def rows(request):
    """(weights (R, dim), levels (R,)) of the rows `serve` returns."""
    return request["weights"][:1], request["levels"][:1]


def setup(program):
    """Nothing: every request loads its own book."""


def serve(program, request):
    bt = program.open_book(weights=request["weights"][0])
    with program.span("varbench.request"):
        out = bt.calc_var(float(request["levels"][0]))[None]
    program.prep_seconds.append(bt.prep_seconds)
    return out
