"""The cell `d3-msm4-t.grid8`. On the CPU: its runs through `run_cell`
on the book cut to its first days at one portfolio, where the program
passes the check and the control and every fault fail it. On the card,
at the cell's own size: the same, and a served request takes the fused
dim-3 route, one `solve_stages3` launch and one `bisect3` call."""

import time

import pytest

from varbench.harness import faults
from varbench.harness.main import run_cell
from varbench.harness.program import Program
from varbench.harness.spec import Bench
from varbench.harness.traffic import Traffic
from varbench.tests.cutbook import cut_bench

CONFIG = "d3-msm4-t"
CELL = "d3-msm4-t.grid8"
CPU_DAYS = 4
# two portfolios (8 rows): on 4 days the control's f32 roots part from the
# f64 ones on these, where one portfolio's 4 rows may not show it
CPU_MIX = {"portfolios": 2, "warmup_requests": 0, "check_requests": 1}
SEED = (1 << 33) + 808


def _run(bench, variant, device, override=None):
    config = bench.config(CONFIG)
    with faults.planted(variant):
        return run_cell(CELL, SEED, 0.5, 0, time.perf_counter(),
                        device=device,
                        engine=faults.engine_for(variant, config),
                        mix_override=override, bench=bench)


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    return cut_bench(tmp_path_factory.mktemp("grid8"), CONFIG, CPU_DAYS)


@pytest.mark.parametrize("variant", faults.variants(Bench(), CELL, CPU_MIX))
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
def test_a_served_request_takes_the_fused_route(cuda_device):
    from copula_var_tpu_torch.utils.profiling import counters, reset_counters

    bench = Bench()
    config = bench.config(CONFIG)
    mix = bench.mix("grid8")
    program = Program(bench, config, mix, cuda_device)
    program.setup()
    try:
        assert program.bt.sweep_operands().U is not None
        reset_counters()
        request = Traffic(mix, int(config["assets"]), SEED, "window").next()
        out = program.serve(request)
        seen = counters()
    finally:
        program.close()
    rows = int(mix["portfolios"]) * len(mix["levels"])
    assert out.shape == (rows, int(config["out_of_sample_days"])) == (32, 500)
    assert seen["launch.solve_stages3"] == 1, seen
    assert seen["launch.bisect3"] == 1, seen
    assert seen.get("launch.masked_contract3", 0) == 0, seen
    assert seen.get("launch.masked_contract3_rebuild", 0) == 0, seen
