"""The flagship's copula-GARCH book, `d2-garch1-t`, and its cells. On the
CPU: the plain reference `garch_student` reproduces the JAX package's
record of the book; the book's grid is the GARCH split; the book reaches
nan_to_num; both cells run through `run_cell` on the book, where the
program passes the check and the control and every planted fault fail
it; and a book cut to its first days serves like the reference on the
same days. On the card, at the cells' own sizes: the same check, and a
served query takes the fused dim-2 route."""

import json
import shutil
import time

import numpy as np
import pytest
import scipy.special
import torch

from varbench.harness import faults
from varbench.harness.main import run_cell
from varbench.harness.program import Program
from varbench.harness.spec import Bench
from varbench.harness.traffic import Traffic
from varbench.reference import garch_student as ref

CONFIG = "d2-garch1-t"
CELLS = {
    "d2-garch1-t.query": {"warmup_requests": 1, "check_requests": 2},
    "d2-garch1-t.reload": {"warmup_requests": 1, "check_requests": 1},
}
BAR = 1e-9  # the records' bar (tests/test_flagship.py)
SEED = (1 << 33) + 202
CUT_DAYS = 8
GARCH_DAY_FIELDS = ("ii_forecast_vols",)


def _book(bench, **kw):
    book = bench.config(CONFIG)["book"]
    return ref.Book(str(bench.path(book["csv"])), int(book["n_insample"]),
                    str(bench.path(book["artifacts"])), **kw)


def _artifacts(bench):
    path = bench.path(bench.config(CONFIG)["book"]["artifacts"])
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"])), {k: z[k] for k in z.files
                                            if k != "meta"}


def test_reproduces_the_garch_record():
    bench = Bench()
    rec = np.load(bench.root / "data" / "flagship_var.npz")
    out, halvings = ref.solve(_book(bench), np.array([[0.5, 0.5]]),
                              np.array([float(rec["obj_var"])]))
    assert out.shape == (1, 500) and halvings > 0
    assert np.max(np.abs(out[0] - rec["garch_var"])) <= BAR
    assert np.array_equal(np.isnan(out[0]), np.isnan(rec["garch_var"]))


def test_the_books_grid_is_the_garch_split():
    """ii_x: n // 8 points on each outer region, n // 5 on each middle
    one, the rest on [-1, 1); ii_dx the backward steps, the first step
    the second's."""
    meta, arrays = _artifacts(Bench())
    n = int(meta["num_points"])
    lo, hi = meta["box"]
    outer, middle = n // 8, n // 5
    x = np.concatenate([
        np.linspace(lo, -2.5, outer, endpoint=False),
        np.linspace(-2.5, -1.0, middle, endpoint=False),
        np.linspace(-1.0, 1.0, n - 2 * outer - 2 * middle, endpoint=False),
        np.linspace(1.0, 2.5, middle, endpoint=False),
        np.linspace(2.5, hi, outer)])
    dx = np.diff(x, prepend=x[0])
    dx[0] = dx[1]
    assert np.array_equal(arrays["ii_x"], x)
    assert np.array_equal(arrays["ii_dx"], dx)


def test_the_book_reaches_nan_to_num():
    """Some of the book's marginal CDF values are exactly 1 in float64,
    where the copula density is not finite: the reference's integrand
    counts those cells 0 and is finite everywhere."""
    bench = Bench()
    meta, arrays = _artifacts(bench)
    u = scipy.special.ndtr(arrays["ii_x"][None, None, :]
                           / arrays["ii_forecast_vols"][:, :, None])
    edge = np.argwhere(u == 1.0)
    assert len(edge) > 0
    V = _book(bench).C
    assert bool(torch.isfinite(V).all())
    for t, d, i in edge[:8]:
        cells = V[t, i, :] if d == 0 else V[t, :, i]
        assert float(cells.abs().sum()) == 0.0


def test_the_reference_refuses_another_book():
    bench = Bench()
    msm = bench.config("d2-msm4-t")["book"]
    with pytest.raises(ValueError, match="GARCH"):
        ref.Book(str(bench.path(msm["csv"])), int(msm["n_insample"]),
                 str(bench.path(msm["artifacts"])))


def _run(bench, cell, variant, device, override=None):
    config = bench.config(CONFIG)
    with faults.planted(variant):
        return run_cell(cell, SEED, 0.5, 0, time.perf_counter(),
                        device=device,
                        engine=faults.engine_for(variant, config),
                        mix_override=override, bench=bench)


def _cases():
    bench = Bench()
    return [(cell, v) for cell, override in CELLS.items()
            for v in faults.variants(bench, cell, override)]


@pytest.mark.parametrize("cell,variant", _cases())
def test_cpu_cells(cell, variant):
    r = _run(Bench(), cell, variant, "cpu", CELLS[cell])
    assert r["failed"] == 0, r
    assert r["correct"] is (variant == "program"), r["checks"]


def cut_garch_bench(tmp_path, days) -> Bench:
    """A checkout under `tmp_path` whose GARCH configuration serves its
    book cut to the first `days` out-of-sample days: the artifacts' day
    field and the prices to the in-sample days and `days` more returns.
    The cells, mixes, calls, metrics and reference are the benchmark's."""
    bench = Bench()
    root = tmp_path / "checkout"
    (root / "varbench").mkdir(parents=True)
    for sub in ("configs", "mixes", "calls", "metrics", "reference"):
        shutil.copytree(bench.dir / sub, root / "varbench" / sub)
    shutil.copy(bench.root / "BENCHMARK.json", root / "BENCHMARK.json")
    config = bench.config(CONFIG)
    book = config["book"]
    n_in = int(book["n_insample"])
    with np.load(bench.path(book["artifacts"]), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    for k in GARCH_DAY_FIELDS:
        arrays[k] = arrays[k][:days]
    books = root / "varbench" / "books"
    books.mkdir()
    np.savez(books / "artifacts.npz", **arrays)
    lines = bench.path(book["csv"]).read_text().splitlines()
    (books / "prices.csv").write_text(
        "\n".join(lines[:1 + n_in + days + 1]) + "\n")
    book["csv"] = "varbench/books/prices.csv"
    book["artifacts"] = "varbench/books/artifacts.npz"
    config["out_of_sample_days"] = days
    entry = next(c for c in bench.spec["configs"] if c["name"] == CONFIG)
    (root / entry["file"]).write_text(json.dumps(config))
    return Bench(root)


def test_a_cut_book_serves_like_the_reference_on_its_days(tmp_path):
    """On the book cut to its first days the port's served query and the
    reference on the whole book's same days agree within the limit, and
    the reference on the cut book is the whole book's on those days."""
    cut = cut_garch_bench(tmp_path, CUT_DAYS)
    config = cut.config(CONFIG)
    mix = cut.mix("query")
    program = Program(cut, config, mix, "cpu")
    program.setup()
    whole = _book(Bench(), days=slice(0, CUT_DAYS))
    part = _book(cut)
    traffic = Traffic(mix, int(config["assets"]), SEED, "window")
    for _ in range(len(mix["levels"])):
        request = traffic.next()
        got = program.serve(request)
        want, halvings = ref.solve(whole, request["weights"],
                                   request["levels"])
        again, _ = ref.solve(part, request["weights"], request["levels"])
        assert got.shape == want.shape == (1, CUT_DAYS) and halvings > 0
        assert np.array_equal(again, want)
        assert not np.isnan(want).any()
        gap = float(np.max(np.abs(got - want)))
        assert gap <= config["limits"]["var_gap_max"], (request, gap)
    program.close()


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", [
    (cell, v) for cell in CELLS for v in faults.variants(Bench(), cell)])
def test_card_cells(cuda_device, cell, variant):
    r = _run(Bench(), cell, variant, cuda_device)
    assert r["failed"] == 0, r
    assert r["correct"] is (variant == "program"), r["checks"]
    if variant == "program":
        assert r["checks"]["var_gap_max"]["value"] <= 1e-12, r["checks"]
    else:
        assert r["checks"]["var_gap_max"]["value"] > BAR or (
            r["checks"]["nan_day_mismatch"]["value"] > 0), r["checks"]


@pytest.mark.cuda
def test_a_served_query_takes_the_fused_route(cuda_device):
    """Each query is one `solve_stages` launch and one K1 launch counting
    its halvings on the device, with no K2 sweep of its own."""
    from copula_var_tpu_torch.utils.profiling import counters, reset_counters

    bench = Bench()
    config = bench.config(CONFIG)
    mix = bench.mix("query")
    program = Program(bench, config, mix, cuda_device)
    program.setup()
    requests = len(mix["levels"])
    try:
        assert program.bt.sweep_operands().P is not None
        reset_counters()
        traffic = Traffic(mix, int(config["assets"]), SEED, "window")
        for _ in range(requests):
            out = program.serve(traffic.next())
            assert out.shape == (1, int(config["out_of_sample_days"]))
        seen = counters()
    finally:
        program.close()
    assert seen.get("launch.solve_stages", 0) == requests, seen
    assert seen.get("launch.bisect_levels", 0) == requests, seen
    assert seen.get("launch.masked_sweep", 0) == 0, seen
    assert "solve.halvings" not in seen, seen


@pytest.mark.cuda
def test_reload_prep_counts_its_passes(cuda_device):
    """The GARCH book's prep on the card makes as many `t_ppf` and
    `betainc` passes as on the CPU (nu = 44.37)."""
    from copula_var_tpu_torch.utils.profiling import counters, reset_counters

    bench = Bench()
    program = Program(bench, bench.config(CONFIG), bench.mix("reload"),
                      cuda_device)
    reset_counters()
    try:
        program.open_book(weights=np.array([0.5, 0.5]))
        seen = counters()
    finally:
        program.close()
    assert seen["t_ppf.passes"] == 10 and seen["betainc.passes"] == 431, seen
    assert seen["prep.table_bytes"] > 0, seen
