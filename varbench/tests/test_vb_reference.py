"""The plain reference against the repository's committed records, on
the CPU."""

import numpy as np

from varbench.harness.spec import Bench
from varbench.reference import msm_student as ref

BAR = 1e-9  # the records' bar (tests/test_flagship.py)


def _book(name, **kw):
    bench = Bench()
    book = bench.config(name)["book"]
    return bench, ref.Book(str(bench.path(book["csv"])),
                           int(book["n_insample"]),
                           str(bench.path(book["artifacts"])), **kw)


def test_reproduces_the_flagship_record():
    bench, book = _book("d2-msm4-t")
    rec = np.load(bench.root / "data" / "flagship_var.npz")
    out, halvings = ref.solve(book, np.array([[0.5, 0.5]]),
                              np.array([float(rec["obj_var"])]))
    assert out.shape == (1, 500)
    assert halvings > 0
    assert np.max(np.abs(out[0] - rec["msm_var"])) <= BAR


def test_reproduces_the_first_days_of_the_dim3_record():
    # the record's widest stage-2 bracket lies in its first days, so the
    # halving count on 8 days is the whole record's
    days = slice(0, 8)
    data = Bench().root / "data"
    book = ref.Book(str(data / "dim3.csv"), 1135,
                    str(data / "dim3_artifacts_msm.npz"), days=days)
    rec = np.load(data / "dim3_var.npz")
    out, _ = ref.solve(book, rec["weights"][None],
                       np.array([float(rec["obj_var"])]))
    assert np.max(np.abs(out[0] - rec["msm_var"][days])) <= BAR

