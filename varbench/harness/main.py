"""One run of one cell: set-up, warm-up, the window, the check, and the
one result line.

    python3 varbench/run.py --workload <config>.<mix> --seed <n>
        --seconds <s> --trace <0|1>

With `--trace 0` the line carries the cell's end-to-end metrics; with
`--trace 1` a window of the mix's `trace_requests` requests runs under
torch.profiler and the line carries the cell's per-layer metrics, the
device's busy time and the breakdown. Every metric is read from the run's
record by its own reader (`spec.Bench.reader`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from varbench.harness import check as check_mod
from varbench.harness import trace as trace_mod
from varbench.harness import window as window_mod
from varbench.harness.imports import forbidden_loaded
from varbench.harness.program import Program
from varbench.harness.spec import Bench
from varbench.harness.traffic import Traffic, rng


def parse(argv):
    p = argparse.ArgumentParser(prog="varbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"varbench: {msg}", file=sys.stderr, flush=True)


def run_cell(cell_name, seed, seconds, trace, t_start, device="cuda",
             engine=None, bench=None, mix_override=None):
    """The result of one run as a dict (the result line's keys), with the
    record its metrics were read from under "_record". `engine` and
    `mix_override` are for the control and the tests."""
    import torch

    bench = bench or Bench()
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    mix = {**bench.mix(cell["traffic"]), **(mix_override or {})}
    cuda = device == "cuda"
    traced = bool(trace) and cuda
    span = trace_mod.span if traced else None
    dim = int(config["assets"])

    program = Program(bench, config, mix, device, engine, span)
    program.setup()
    warm = Traffic(mix, dim, seed, "warmup")
    for _ in range(int(mix["warmup_requests"])):
        program.serve(warm.next())
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    program.prep_seconds = []

    traffic = Traffic(mix, dim, seed, "window")
    profile = None
    if traced:
        win, profile = trace_mod.profiled(lambda: window_mod.run(
            program.serve, traffic, cuda, None,
            count=int(mix["trace_requests"]), span=span))
    else:
        keep = window_mod.Reservoir(int(mix["check_requests"]),
                                    rng(seed, "sample"))
        win = window_mod.run(program.serve, traffic, cuda, keep,
                             seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    leaked = forbidden_loaded()
    completed = win.attempted - win.failed
    log(f"window {win.elapsed_s:.3f} s, {win.attempted} requests, "
        f"{win.failed} failed, {win.rows} rows")
    if win.latency_s:
        log(f"p95 latency {1e3 * np.percentile(win.latency_s, 95):.6f} ms")
    for err in win.errors:
        log(f"a request failed:\n{err}")
    prep_seconds = list(program.prep_seconds)
    program.close()

    t_check = time.perf_counter()
    numbers, bound_s, rows = check_mod.check(bench, config, mix, win.kept,
                                             device, work=traced)
    log(f"check of {len(win.kept)} requests ({rows} rows) "
        f"{time.perf_counter() - t_check:.3f} s")
    correct = (completed > 0 and win.failed == 0 and rows > 0
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    record = {
        "setup_s": setup_s,
        "window": {"elapsed_s": win.elapsed_s, "requests": completed,
                   "rows": win.rows, "latency_s": win.latency_s},
        "memory_peak_bytes": peak,
        "profile": profile,
        "traced_requests": completed if traced else None,
        "work_bound_s": bound_s,
        "prep_seconds": prep_seconds,
    }
    metrics = {}
    for m in (bench.per_layer(cell_name) if traced
              else bench.end_to_end(cell_name)):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell["chips"]) if cuda else 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": device_info}
    if traced:
        if profile is not None:
            device_info["busy_s"] = profile["busy_s"]
            device_info["window_s"] = profile["window_s"]
            result["breakdown"] = {"device_ops": profile["device_ops_top"],
                                   "idle_gaps": profile["idle_gaps"]}
        else:
            log("the trace recorded no pad kernel: no device figures")
    result["checks"] = numbers
    result["_record"] = record
    result["_leaked"] = sorted(set(leaked) | set(forbidden_loaded()))
    return result


def public(result: dict) -> dict:
    """The result line's keys: the contract's, and the compared numbers
    last."""
    return {k: v for k, v in result.items() if not k.startswith("_")}


def main(argv, t_start) -> int:
    args = parse(argv)
    import torch

    bench = Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      t_start, bench=bench)
    leaked = result["_leaked"]
    if leaked:
        log(f"the run loaded forbidden modules: {', '.join(leaked)}")
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(public(result)), flush=True)
    return 0
