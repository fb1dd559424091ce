"""The harness finds every configuration, mix, call and metric by name: a
new cell needs new files and entries, and no edit to the harness."""

import json
import shutil
import time

import pytest

from varbench.harness.main import run_cell
from varbench.harness.program import Program
from varbench.harness.spec import Bench

NEW_METRIC = '''
def read(record):
    return float(record["window"]["rows"])
'''

# one portfolio at every level of the ladder, by the program's grid call
NEW_CALL = '''
import numpy as np


def rows(request):
    w, lv = request["weights"][:1], request["levels"]
    return np.repeat(w, len(lv), axis=0), lv


def setup(program):
    program.bt = program.open_book()


def serve(program, request):
    out = program.bt.calc_var_grid(request["weights"][:1],
                                   request["levels"])
    return out.reshape(-1, out.shape[-1])
'''


@pytest.fixture
def extended(tmp_path):
    """A copy of the benchmark with one more config, mix, metric and
    cell, added as files and entries only."""
    bench = Bench()
    root = tmp_path / "checkout"
    (root / "varbench").mkdir(parents=True)
    for sub in ("configs", "mixes", "calls", "metrics", "reference",
                "books"):
        shutil.copytree(bench.dir / sub, root / "varbench" / sub)
    spec = json.loads((bench.root / "BENCHMARK.json").read_text())
    config = bench.config("d2-msm4-t")
    config["name"] = "d2-msm4-t-copy"
    (root / "varbench/configs/d2-msm4-t-copy.json").write_text(
        json.dumps(config))
    f32 = {**config, "name": "d2-msm4-t-f32", "engine": "pallas"}
    (root / "varbench/configs/d2-msm4-t-f32.json").write_text(
        json.dumps(f32))
    mix = bench.mix("query")
    mix.update(portfolios=2, warmup_requests=1, check_requests=2)
    (root / "varbench/mixes/pair.json").write_text(json.dumps(mix))
    ladder = bench.mix("query")
    ladder.update(call="ladder", level_draw="all", warmup_requests=1,
                  check_requests=1)
    (root / "varbench/mixes/ladder.json").write_text(json.dumps(ladder))
    (root / "varbench/calls/ladder.py").write_text(NEW_CALL)
    (root / "varbench/metrics/rows_done.py").write_text(NEW_METRIC)
    spec["configs"].append({**spec["configs"][0], "name": "d2-msm4-t-copy",
                            "file": "varbench/configs/d2-msm4-t-copy.json"})
    spec["configs"].append({**spec["configs"][0], "name": "d2-msm4-t-f32",
                            "file": "varbench/configs/d2-msm4-t-f32.json"})
    cells = [("d2-msm4-t-copy", "pair"), ("d2-msm4-t-copy", "ladder"),
             ("d2-msm4-t-f32", "pair")]
    for config_name, traffic in cells:
        spec["workloads"].append({"name": f"{config_name}.{traffic}",
                                  "config": config_name, "traffic": traffic,
                                  "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({"name": "rows_done", "unit": "rows",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": [f"{c}.{t}" for c, t in cells]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root)


def test_new_files_are_found_by_name(extended):
    assert extended.config("d2-msm4-t-copy")["assets"] == 2
    assert extended.mix("pair")["portfolios"] == 2
    assert extended.call("ladder").rows(
        {"weights": [[0.5, 0.5]], "levels": [0.1, 0.2]})[1] == [0.1, 0.2]
    assert extended.reader("rows_done")({"window": {"rows": 3}}) == 3.0
    # a suffixed name falls back to its first part's reader
    assert extended.reader("device_idle_pct.other") is not None
    names = [m["name"] for m in extended.end_to_end("d2-msm4-t-copy.pair")]
    assert sorted(names) == ["peak_mem_gb", "rows_done", "setup_s"]
    assert extended.per_layer("d2-msm4-t-copy.pair") == []
    with pytest.raises(FileNotFoundError):
        extended.reader("no_such_metric")


@pytest.mark.parametrize("cell,rows", [("d2-msm4-t-copy.pair", 2),
                                       ("d2-msm4-t-copy.ladder", 4)])
def test_a_new_cell_runs_with_no_edit(extended, cell, rows):
    r = run_cell(cell, 7, 0.5, 0, time.perf_counter(), device="cpu",
                 bench=extended)
    assert r["correct"], r["checks"]
    assert r["metrics"]["rows_done"]["value"] == rows * r["attempted"]


def test_a_config_runs_its_engine(extended):
    # the f32 engine is served as the configuration says, and the check
    # holds it to the float64 limits that the copy kept
    program = Program(extended, extended.config("d2-msm4-t-f32"),
                      extended.mix("pair"), "cpu")
    program.setup()
    assert program.bt.engine == "pallas"
    r = run_cell("d2-msm4-t-f32.pair", 7, 0.5, 0, time.perf_counter(),
                 device="cpu", bench=extended)
    assert r["failed"] == 0 and not r["correct"], r["checks"]
    assert r["checks"]["var_gap_max"]["value"] > 1e-9


def test_cells_report_their_metrics():
    bench = Bench()
    for cell in bench.spec["workloads"]:
        e2e = [m["name"] for m in bench.end_to_end(cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.per_layer(cell["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
            assert bench.reader(m["name"]) is not None
