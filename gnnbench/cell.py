"""A cell as the benchmark's files describe it, found by name.

``BENCHMARK.json`` (at the root of the checkout) names the cell, its
configuration, its traffic mix and its metrics. The files beside this one
hold the rest, one file per thing:

- ``configs/<config>.json``: the model, its widths and depth, the graph's
  counts, the hyperparameters, the precision, ``source``, ``reduced`` and
  ``assumed``;
- ``traffic/<traffic>.json``: the mix's parameters, ``mode`` naming its
  code, ``traffic/<mode>.py``;
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips and
  why (held against ``BENCHMARK.json``), and the limits of the numbers
  that decide ``correct``;
- ``metrics/<metric>.py``: one reader per metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[str]
    per_layer: List[str]
    chips: int
    root: Path

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def mode(self):
        """The module that runs the traffic's mode."""
        return importlib.import_module(
            f"gnnbench.traffic.{self.traffic['mode']}")

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return load_reader(self.root, metric)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric with ``workloads`` is read in those cells, one
    without in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``'s checkout (``root`` is the
    benchmark's folder; ``BENCHMARK.json`` lies beside it)."""
    bench = _json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = _json(root / "configs" / f"{entry['config']}.json")
    traffic = _json(root / "traffic" / f"{entry['traffic']}.json")
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _reports(m, name, e2e)]
    return Cell(name=name, config=config, traffic=traffic,
                workload=workload, end_to_end=e2e, per_layer=per_layer,
                chips=entry["chips"], root=root)


def load_reader(root: Path, metric: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<metric>.py`` (a metric's name may hold dots,
    so the file is loaded by its path)."""
    path = root / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"gnnbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
