"""The readings that the check's limits are set from: the compared
numbers of the program, of its control and of each planted fault, over
seeds, in one process (the book's load is paid once per variant).

    python3 varbench/readings.py --workload <cell> --seeds <first> <count>
        [--seconds 2] [--variants program,control,...]

Each run is a short window at the cell's own load, checked as a benchmark
run checks it. One JSON line per (variant, seed) on standard output.
Runs on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    from varbench.harness import faults
    from varbench.harness.main import run_cell
    from varbench.harness.spec import Bench

    p = argparse.ArgumentParser(prog="varbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs=2, type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--variants", default=",".join(faults.VARIANTS))
    args = p.parse_args(argv)
    bench = Bench()
    config = bench.config(bench.cell(args.workload)["config"])
    can = faults.variants(bench, args.workload)
    first, count = args.seeds
    for variant in args.variants.split(","):
        if variant not in can:
            continue
        for seed in range(first, first + count):
            t0 = time.perf_counter()
            with faults.planted(variant):
                r = run_cell(args.workload, seed, args.seconds, 0, t0,
                             engine=faults.engine_for(variant, config), bench=bench)
            print(json.dumps({
                "workload": args.workload, "variant": variant, "seed": seed,
                "correct": r["correct"], "attempted": r["attempted"],
                "failed": r["failed"],
                "numbers": {k: v["value"] for k, v in r["checks"].items()},
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
