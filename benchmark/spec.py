"""Finds a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` of its entry under ``configs``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a metric: ``benchmark/metrics/<name>.py``, whose ``read(run)`` returns
  the metric's value, or None where the run holds nothing to read.

Nothing here knows a cell, a configuration or a metric by name: a new one
is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List


@dataclass
class Cell:
    entry: dict  # the workload's entry in BENCHMARK.json
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # and with --trace 1


def load(root) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root, name: str) -> Cell:
    bench = load(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(Path(root) / conf["file"]) as f:
        config = json.load(f)
    with open(Path(root) / traffic_file(root, entry["traffic"])) as f:
        traffic = json.load(f)
    return Cell(
        entry=entry, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def traffic_file(root, name: str) -> Path:
    """A traffic mix's file, relative to the root."""
    paths = load(root)["paths"]
    for p in paths:
        f = Path(p) / "traffic" / f"{name}.json"
        if (Path(root) / f).is_file():
            return f
    raise FileNotFoundError(f"no traffic file {name}.json under {paths}")


def module(root, path: str):
    """The Python file ``path`` (relative to the root), loaded."""
    f = Path(root) / path
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_file_{f.stem}", f)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(root, name: str) -> Callable:
    """The metric ``name``'s ``read`` function."""
    paths = load(root)["paths"]
    for p in paths:
        f = Path(p) / "metrics" / f"{name}.py"
        if (Path(root) / f).is_file():
            return module(root, str(f)).read
    raise FileNotFoundError(f"no metric reader {name}.py under {paths}")
