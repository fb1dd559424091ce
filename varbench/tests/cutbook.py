"""A copy of the benchmark whose configuration serves its book cut to the
first out-of-sample days, so that a cell runs through `run_cell` on the
CPU. Only the book changes: the cell, its mix, calls, metrics and
reference are the benchmark's own files."""

import json
import shutil

import numpy as np

from varbench.harness.spec import Bench

DAY_FIELDS = ("ii_forecasts_by_states", "ii_forecast_combos")


def cut_book(bench, book, out_dir, days):
    """The book's CSV and artifacts cut to its first `days` out-of-sample
    days, written under `out_dir`: the artifacts' day fields, and the
    prices to the in-sample days and `days` more returns. Returns
    (csv path, artifacts path)."""
    n_in = int(book["n_insample"])
    with np.load(bench.path(book["artifacts"]), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    for k in DAY_FIELDS:
        arrays[k] = arrays[k][:days]
    out_dir.mkdir(parents=True, exist_ok=True)
    artifacts = out_dir / "artifacts.npz"
    np.savez(artifacts, **arrays)
    lines = bench.path(book["csv"]).read_text().splitlines()
    csv = out_dir / "prices.csv"
    csv.write_text("\n".join(lines[:1 + n_in + days + 1]) + "\n")
    return csv, artifacts


def cut_bench(tmp_path, config_name, days) -> Bench:
    """A checkout under `tmp_path` whose configuration `config_name`
    serves its book's first `days` days."""
    bench = Bench()
    root = tmp_path / "checkout"
    (root / "varbench").mkdir(parents=True)
    for sub in ("configs", "mixes", "calls", "metrics", "reference"):
        shutil.copytree(bench.dir / sub, root / "varbench" / sub)
    shutil.copy(bench.root / "BENCHMARK.json", root / "BENCHMARK.json")
    config = bench.config(config_name)
    csv, artifacts = cut_book(bench, config["book"],
                              root / "varbench" / "books", days)
    config["book"]["csv"] = str(csv.relative_to(root))
    config["book"]["artifacts"] = str(artifacts.relative_to(root))
    config["out_of_sample_days"] = days
    entry = next(c for c in bench.spec["configs"] if c["name"] == config_name)
    (root / entry["file"]).write_text(json.dumps(config))
    return Bench(root)
