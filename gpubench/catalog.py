"""Discovery by name: the cells, configurations, traffic mixes and metric
readers that ``BENCHMARK.json`` names.

- a configuration is the JSON file its ``configs`` entry names;
- a traffic mix is ``traffic/<name>.json`` beside this file;
- a metric, end-to-end or per-layer, is ``metrics/<name>.py``, a module
  with ``read(ctx)`` that returns a number, or ``None`` where the run has
  nothing for it to read.

A cell, a configuration, a mix or a metric is added by adding its file and
its entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: Callable[[object], Optional[float]]


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / HERE.name
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for cell in self.doc["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for entry in self.doc["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, traced: bool) -> List[Metric]:
        """The cell's end-to-end metrics (``traced`` false) or per-layer
        metrics (``traced`` true): every entry that lists the cell, or
        lists none."""
        group = self.doc["per_layer"] if traced else self.doc["end_to_end"]
        return [
            Metric(m["name"], m["unit"], self._reader(m["name"]))
            for m in group
            if cell in m.get("workloads", [cell])
        ]

    def _reader(self, name: str) -> Callable[[object], Optional[float]]:
        return reader(name, self.dir)


def reader(name: str, bench_dir: Path = HERE) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<name>.py``. A metric that reads what another
    reads in other cells (``chr17.*``) takes that one's reader by name."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


__all__ = ["Benchmark", "Metric", "ROOT", "reader"]
