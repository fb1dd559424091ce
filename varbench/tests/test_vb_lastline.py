"""The run's last line, and its refusal without a card."""

import json
import subprocess
import sys
import time

from varbench.harness.main import public, run_cell
from varbench.harness.spec import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_last_line_has_the_contract_keys():
    r = run_cell("d2-msm4-t.query", (1 << 32) + 3, 0.3, 0,
                 time.perf_counter(), device="cpu",
                 mix_override={"warmup_requests": 1, "check_requests": 2})
    line = json.loads(json.dumps(public(r)))
    assert list(line) == KEYS  # the compared numbers come last
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["metrics"]) <= {"query_ms_p95", "peak_mem_gb",
                                    "setup_s"}
    assert set(line["checks"]) == {"var_gap_max", "nan_day_mismatch"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "varbench/run.py", "--workload", "d2-msm4-t.query",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        return  # the card is there: nothing to refuse
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
