"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration and traffic files, and the readers of its per-layer
metrics.  Nothing here names a cell, a configuration or a metric: a later
change adds one by adding its files and its entries."""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Callable, Dict, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell: ``workload``, ``config`` and ``mix`` dicts, and the
    metrics it reports with ``--trace 0`` (``end_to_end``) and ``--trace
    1`` (``per_layer``)."""

    def __init__(self, workload: str, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench_dir = self.root / BENCH_DIR.name
        bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.mix = load_json(self.bench_dir / "mixes"
                             / f"{self.workload['traffic']}.json")
        self.run_seconds = bench["run_seconds"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.workload["name"] in cells

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def reader(self, metric: str) -> Callable:
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        return load_reader(self.bench_dir / "metrics" / f"{metric}.py")


def load_reader(path: pathlib.Path) -> Callable:
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(spec: Spec, run, metrics) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of the metrics whose reader found
    something to read."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
