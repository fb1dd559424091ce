"""The three-asset book, `d3-msm4-t`. On the CPU: the port, served
through its normal entry points on the first days of the benchmark's own
copy of the book, against the plain reference on the same days. On the
card, at the cell's own size: the program passes the check, the control
and the faults fail it, and a served query takes the table route."""

import time

import numpy as np
import pytest

from varbench.harness import faults
from varbench.harness.main import run_cell
from varbench.harness.program import Program
from varbench.harness.spec import Bench
from varbench.harness.traffic import Traffic

CONFIG = "d3-msm4-t"
CELL = "d3-msm4-t.query"
DAYS = 8  # few enough for the plain dim-3 sweeps on the CPU
REQUESTS = 4  # one cycle of the query mix's ladder
SEED = (1 << 33) + 303
DAY_FIELDS = ("ii_forecasts_by_states", "ii_forecast_combos")


def _cut_book(bench, book, tmp_path, days):
    """The book's CSV and artifacts cut to its first `days` out-of-sample
    days: the artifacts' day fields, and the prices to the in-sample days
    and `days` more returns."""
    n_in = int(book["n_insample"])
    with np.load(bench.path(book["artifacts"]), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    for k in DAY_FIELDS:
        arrays[k] = arrays[k][:days]
    artifacts = tmp_path / "artifacts.npz"
    np.savez(artifacts, **arrays)
    lines = bench.path(book["csv"]).read_text().splitlines()
    csv = tmp_path / "prices.csv"
    csv.write_text("\n".join(lines[:1 + n_in + days + 1]) + "\n")
    return str(csv), str(artifacts)


def test_serves_like_the_reference_on_the_first_days(tmp_path):
    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    bench = Bench()
    config = bench.config(CONFIG)
    book = config["book"]
    n_in = int(book["n_insample"])
    csv, artifacts = _cut_book(bench, book, tmp_path, DAYS)
    bt = load_artifacts(artifacts, from_csv(csv, n_in), device="cpu")
    bt.engine = config["engine"]
    ref = bench.reference(config)
    model = ref.Book(str(bench.path(book["csv"])), n_in,
                     str(bench.path(book["artifacts"])),
                     days=slice(0, DAYS))
    mix = bench.mix("query")
    traffic = Traffic(mix, int(config["assets"]), SEED, "window")
    asked = []
    for _ in range(REQUESTS):
        request = traffic.next()
        weights, levels = request["weights"], request["levels"]
        got = bt.calc_var_portfolios(weights, obj_var=levels)
        want, halvings = ref.solve(model, weights, levels)
        assert got.shape == want.shape == (1, DAYS) and halvings > 0
        assert np.array_equal(np.isnan(got), np.isnan(want))
        both = np.isfinite(got) & np.isfinite(want)
        assert both.any()
        gap = np.max(np.abs(got[both] - want[both]))
        assert gap <= config["limits"]["var_gap_max"], (request, gap)
        asked.extend(levels)
    assert sorted(asked) == sorted(mix["levels"])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", faults.variants(Bench(), CELL))
def test_card_cell(cuda_device, variant):
    bench = Bench()
    config = bench.config(CONFIG)
    with faults.planted(variant):
        r = run_cell(CELL, SEED, 0.5, 0, time.perf_counter(),
                     device=cuda_device,
                     engine=faults.engine_for(variant, config), bench=bench)
    assert r["failed"] == 0, r
    assert r["correct"] is (variant == "program"), r["checks"]


@pytest.mark.cuda
def test_a_served_query_takes_the_table_route(cuda_device):
    from copula_var_tpu_torch.utils.profiling import counters, reset_counters

    bench = Bench()
    config = bench.config(CONFIG)
    mix = bench.mix("query")
    program = Program(bench, config, mix, cuda_device)
    program.setup()
    try:
        assert program.bt.sweep_operands().U is not None
        reset_counters()
        traffic = Traffic(mix, int(config["assets"]), SEED, "window")
        for _ in range(REQUESTS):
            out = program.serve(traffic.next())
            assert out.shape == (1, int(config["out_of_sample_days"]))
        seen = counters()
    finally:
        program.close()
    assert seen.get("launch.masked_contract3", 0) > 0, seen
    assert seen.get("launch.masked_contract3_rebuild", 0) == 0, seen
