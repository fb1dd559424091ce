"""The cell `d3-msm4-t-n300.query-slow`. On the CPU: its runs through
`run_cell` on the book cut to its first day, where the program passes the
check and every planted fault fails it. The control (the f32 engine)
equals the program on such cuts (on 1 day at 1 row and on 2 days at 2
rows its gap is 0): at 300 points an f32 root leaves the f64 one only on
a few of the 500 days, so the control is held on the card, at the cell's
own size. There: the program and the control and every fault, and a
served query takes the rebuild route, the row flags built once a book
and every sweep a `masked_contract3_rebuild` launch, with no table U."""

import time

import pytest

from varbench.harness import faults
from varbench.harness.main import run_cell
from varbench.harness.program import Program
from varbench.harness.spec import Bench
from varbench.harness.traffic import Traffic
from varbench.tests.cutbook import cut_bench

CONFIG = "d3-msm4-t-n300"
CELL = "d3-msm4-t-n300.query-slow"
CPU_DAYS = 1
CPU_MIX = {"warmup_requests": 0, "check_requests": 1}
SEED = (1 << 33) + 300


def _run(bench, variant, device, override=None):
    config = bench.config(CONFIG)
    with faults.planted(variant):
        return run_cell(CELL, SEED, 0.5, 0, time.perf_counter(),
                        device=device,
                        engine=faults.engine_for(variant, config),
                        mix_override=override, bench=bench)


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    return cut_bench(tmp_path_factory.mktemp("n300"), CONFIG, CPU_DAYS)


@pytest.mark.parametrize("variant", [
    v for v in faults.variants(Bench(), CELL, CPU_MIX) if v != "control"])
def test_cpu_cell(cut, variant):
    r = _run(cut, variant, "cpu", CPU_MIX)
    assert r["failed"] == 0, r
    assert r["correct"] is (variant == "program"), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", faults.variants(Bench(), CELL))
def test_card_cell(cuda_device, variant):
    r = _run(Bench(), variant, cuda_device)
    assert r["failed"] == 0, r
    assert r["correct"] is (variant == "program"), r["checks"]


@pytest.mark.cuda
def test_a_served_query_takes_the_rebuild_route(cuda_device):
    from copula_var_tpu_torch.utils.profiling import counters, reset_counters

    bench = Bench()
    config = bench.config(CONFIG)
    mix = bench.mix("query-slow")
    T, n = int(config["out_of_sample_days"]), int(config["num_points"])
    program = Program(bench, config, mix, cuda_device)
    reset_counters()
    program.setup()
    try:
        assert program.bt.sweep_operands().U is None
        built = counters()
        traffic = Traffic(mix, int(config["assets"]), SEED, "window")
        outs = [program.serve(traffic.next()) for _ in range(2)]
        seen = counters()
    finally:
        program.close()
    assert [o.shape for o in outs] == [(1, T)] * 2
    assert built["launch.contract3_row_flags"] == 1, built
    assert built["prep.flag_bytes"] == T * n * n == 45_000_000, built
    assert seen["launch.contract3_row_flags"] == 1, seen
    assert seen["launch.masked_contract3_rebuild"] > 0, seen
    for name in ("launch.masked_contract3", "launch.solve_stages3",
                 "launch.bisect3", "prep.table_bytes"):
        assert seen.get(name, 0) == 0, (name, seen)
