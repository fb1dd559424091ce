"""The check fails what it must: the control (the program's own float32
engine) and each fault that a cell can have, planted under the timed
path, with every other part of a run as it is; and the program itself
passes. Every cell runs here on the CPU, the grid at 2 of its 32
portfolios; on the card the grid runs at its own size."""

import time

import pytest

from varbench.harness import faults
from varbench.harness.main import run_cell
from varbench.harness.spec import Bench

CPU_CELLS = {
    "d2-msm4-t.query": {"warmup_requests": 1, "check_requests": 2},
    "d2-msm4-t.grid": {"portfolios": 2, "warmup_requests": 1,
                       "check_requests": 1},
    "d2-msm4-t.reload": {"warmup_requests": 1, "check_requests": 1},
}
CARD_CELLS = ("d2-msm4-t.grid",)
SEED = (1 << 33) + 101


def _cases(cells):
    bench = Bench()
    return [(cell, v) for cell in cells
            for v in faults.variants(bench, cell, CPU_CELLS.get(cell))]


def _run(cell, variant, device, override=None):
    bench = Bench()
    config = bench.config(bench.cell(cell)["config"])
    with faults.planted(variant):
        return run_cell(cell, SEED, 0.5, 0, time.perf_counter(),
                        device=device,
                        engine=faults.engine_for(variant, config),
                        mix_override=override, bench=bench)


@pytest.mark.parametrize("cell,variant", _cases(CPU_CELLS))
def test_cpu_cells(cell, variant):
    r = _run(cell, variant, "cpu", CPU_CELLS[cell])
    assert r["correct"] is (variant == "program"), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", _cases(CARD_CELLS))
def test_card_cells(cuda_device, cell, variant):
    r = _run(cell, variant, cuda_device)
    assert r["correct"] is (variant == "program"), r["checks"]
