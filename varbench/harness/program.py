"""The program under test, `copula_var_tpu_torch`: one book of a
configuration, served under a mix's call. The only module of the harness
that imports the program.

A mix's `"call"` names a file `varbench/calls/<call>.py` (found by name,
`spec.Bench.call`) with

  rows(request) -> (weights (R, dim), levels (R,))  the rows it returns;
  setup(program)                 what set-up loads (a book, or nothing);
  serve(program, request) -> (R, T)  one request's VaR series.

Every book is loaded on the configuration's `"engine"`; the control alone
runs another (`faults.engine_for`).
"""

from __future__ import annotations

import contextlib
import gc


class Program:
    """Books of `config` served on `device` under `mix`'s call. `span(name)`
    is the harness's span around each call into the program; `engine`,
    when given, replaces the configuration's on every book loaded."""

    def __init__(self, bench, config: dict, mix: dict, device: str,
                 engine=None, span=None):
        self.bench = bench
        self.book = config["book"]
        self.call = bench.call(mix["call"])
        self.device = device
        self.engine = engine or config["engine"]
        self.span = span or (lambda name: contextlib.nullcontext())
        self.bt = None
        self.prep_seconds = []  # the program's own, per book loaded

    def open_book(self, weights=None, **options):
        """A solve-ready book: the CSV read with `weights`, the artifacts
        loaded with `options` (`load_artifacts`'s keywords) on the
        engine, and its sweep operands built."""
        from copula_var_tpu_torch.data import from_csv
        from copula_var_tpu_torch.utils.artifacts import load_artifacts

        with self.span("varbench.load_book"):
            data = from_csv(str(self.bench.path(self.book["csv"])),
                            int(self.book["n_insample"]), weights=weights)
            bt = load_artifacts(str(self.bench.path(self.book["artifacts"])),
                                data, device=self.device, **options)
            bt.engine = self.engine
        with self.span("varbench.sweep_operands"):
            bt.sweep_operands()
        return bt

    def setup(self) -> None:
        self.call.setup(self)

    def serve(self, request: dict):
        """The (R, T) VaR series of one request."""
        return self.call.serve(self, request)

    def close(self) -> None:
        """Release the program's state and its cached device memory."""
        self.bt = None
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
