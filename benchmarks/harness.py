"""The benchmark's data: cells, configurations, traffic, limits and metric
readers, each found by its name under a root directory.

- BENCHMARK.json at the root names the cells and the metrics;
- benchmarks/configs/<config>.json holds a configuration as it is run;
- benchmarks/traffic/<traffic>.json holds a traffic mix's parameters; its
  `kind` names the generator that reads it (benchmarks/drive/<kind>.py);
- benchmarks/limits/<cell>.json holds the limit of each number that the
  cell's correctness check compares, with the readings it was set from;
- benchmarks/metrics/<metric>.py holds a per-layer metric's reader,
  `read(records) -> float | None`.

A later change adds a configuration, a cell or a metric by adding files and
entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that may not be loaded on the chip's path: JAX and
# its libraries, and the JAX package (compared whole: the port's name
# begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "monkeynet_tpu")


class Spec:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / "benchmarks"

    def cell(self, name: str) -> Dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        (entry,) = [c for c in self.data["configs"] if c["name"] == cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: Dict) -> Dict:
        return json.loads((self.bench / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: Dict) -> Dict[str, float]:
        path = self.bench / "limits" / f"{cell['name']}.json"
        return {k: v["limit"] for k, v in json.loads(path.read_text())["numbers"].items()}

    def _applies(self, metric: Dict, cell_name: str) -> bool:
        return "workloads" not in metric or cell_name in metric["workloads"]

    def end_to_end(self, cell_name: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell_name)]

    def per_layer(self, cell_name: str) -> List[Dict]:
        """The cell's per-layer metrics: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell_name)}
        return [m for m in self.data["per_layer"]
                if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def reader(self, metric_name: str) -> Callable:
        path = self.bench / "metrics" / f"{metric_name}.py"
        spec = importlib.util.spec_from_file_location(f"_bench_metric_{len(sys.modules)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden on the chip's path."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def read_per_layer(spec: Spec, cell_name: str, records: Dict) -> Dict[str, Dict]:
    """{metric: {'value', 'unit'}} of each per-layer metric whose reader
    finds something to read."""
    out = {}
    for metric in spec.per_layer(cell_name):
        value = spec.reader(metric["name"])(records)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {'value', 'limit', 'ok'}} of each number that has a limit; a
    number that is missing, not finite, or has no limit set, fails. The
    other numbers a check reads are not compared."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = (value is not None and limit is not None and math.isfinite(value)
              and value <= limit)
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                checks: Dict, breakdown: Optional[Dict] = None) -> str:
    """The run's last line of standard output; the compared numbers last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return json.dumps(line)
