"""Finds what ``BENCHMARK.json`` names, by name, in files of their own:

- a cell: an entry of ``workloads``;
- its configuration: the ``file`` of its entry in ``configs``, whose
  ``reference`` names the plain reference ``perfbench/reference/<name>.py``;
- its traffic: ``perfbench/traffic/<traffic>.json``, whose ``job`` keys
  (if any) override the configuration's job;
- the limits of ``correct``: ``perfbench/limits/<config>.json``;
- a metric's reader: ``perfbench/metrics/<metric name>.py``, a ``read(run)``
  that returns a number or None.

A later cell, configuration or metric is new files and new entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> Dict:
    return _json(here / "traffic" / f"{name}.json")


def limits(config_name: str, here: Path = HERE) -> Dict:
    return _json(here / "limits" / f"{config_name}.json")


def job(cfg: Dict, tr: Dict) -> Dict:
    return dict(cfg["job"], **tr.get("job", {}))


def reference(family: str):
    return importlib.import_module(f"perfbench.reference.{family}")


def reader(metric: str, here: Path = HERE):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false: each entry whose
    ``workloads`` lists the cell, or that has none) or its per-layer ones
    (each whose ``workloads`` lists the cell or, where it has none, whose
    ``moves`` is one of the cell's end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]
