"""portfolios: `calc_var_portfolios(weights (P, dim), obj_var=levels
(P,))` on the book loaded once in set-up -> (P, T), one row a
portfolio at its own level."""


def rows(request):
    """(weights (R, dim), levels (R,)) of the rows `serve` returns."""
    return request["weights"], request["levels"]


def setup(program):
    program.bt = program.open_book()


def serve(program, request):
    with program.span("varbench.request"):
        return program.bt.calc_var_portfolios(request["weights"],
                                              obj_var=request["levels"])
