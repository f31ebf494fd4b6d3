"""Everything of a cell, found by the names in ``BENCHMARK.json``.

- ``benchmark/configs/<config>.json``: the configuration as it is run;
  ``benchmark/configs/<config>.py``: its plain reference and how the
  program is built from it;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, whose
  ``kind`` names its driver, ``benchmark/drivers/<kind>.py``;
- ``benchmark/limits/<workload>.json``: the cell's limits for ``correct``;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.

A configuration, a traffic mix, a cell or a metric is added by adding its
files and its entry in ``BENCHMARK.json``; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # benchmark/


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Registry:
    def __init__(self, spec: Dict, root: Path = HERE):
        self.spec = spec
        self.root = root

    @classmethod
    def from_file(cls, path: Path, root: Path = HERE) -> "Registry":
        return cls(json.loads(Path(path).read_text()), root)

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return json.loads((self.root / "configs" / f"{name}.json").read_text())

    def config_module(self, name: str) -> ModuleType:
        return load_module(self.root / "configs" / f"{name}.py", f"benchmark_config_{name}")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def driver(self, kind: str) -> ModuleType:
        return load_module(self.root / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads((self.root / "limits" / f"{workload}.json").read_text())["limits"]

    def _metrics(self, section: str, workload: str) -> List[Dict]:
        return [m for m in self.spec[section]
                if "workloads" not in m or workload in m["workloads"]]

    def end_to_end(self, workload: str) -> List[Dict]:
        return self._metrics("end_to_end", workload)

    def per_layer(self, workload: str) -> List[Dict]:
        return self._metrics("per_layer", workload)

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{metric}.py",
                           "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))

    def read(self, metric: Dict, readings) -> Optional[float]:
        """The metric's value from a run's readings, or None where its
        reader finds nothing to read."""
        value = self.reader(metric["name"]).read(readings)
        return None if value is None else float(value)
