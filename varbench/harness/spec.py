"""The benchmark's definition, and the files it names.

`BENCHMARK.json` at the checkout's root lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in a
file of its own under `varbench/`, found by name:

  configs: the file each configuration entry names (`file`);
  mixes:   `varbench/mixes/<traffic>.json`, the parameters the general
           request generator (`traffic.py`) reads;
  calls:   `varbench/calls/<mix's "call">.py`, what one request does
           (`program.py`);
  metrics: `varbench/metrics/<name>.py`, else the file of the name's
           first part (`device_idle_pct.py` for `device_idle_pct.query`),
           with `read(record) -> float | None`;
  references: `varbench/reference/<config's "reference">.py`.

So a cell, a mix or a metric is added by adding files and entries, with
no edit to the harness.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """Import the Python file `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """`BENCHMARK.json` under `root` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "varbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return json.loads((self.dir / "mixes" / f"{traffic}.json")
                          .read_text())

    def call(self, name: str):
        """The call module that a mix's `"call"` names."""
        return load_module(self.dir / "calls" / f"{name}.py",
                           f"varbench_call_{name}")

    def path(self, relative: str) -> Path:
        """A file of the benchmark, named relative to the checkout."""
        return self.root / relative

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics that `cell` reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics that `cell` reports: those that list it,
        and those with no list that move one of its end-to-end
        metrics."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """`read(record)` of the metric's own file, or of its first
        part's."""
        for stem in (metric, metric.split(".")[0]):
            path = self.dir / "metrics" / f"{stem}.py"
            if path.is_file():
                return load_module(path, f"varbench_metric_{stem}").read
        raise FileNotFoundError(f"no reader for metric {metric!r} under "
                                f"{self.dir / 'metrics'}")

    def reference(self, config: dict):
        """The plain reference module that `config` names."""
        name = config["reference"]
        return load_module(self.dir / "reference" / f"{name}.py",
                           f"varbench_reference_{name}")
