"""BENCHMARK.json and the files it names, found by name.

A configuration is ``configs/<config>.json``; a traffic mix
``traffic/<traffic>.json``, which names the module that sets up and
drives its kind of work, ``work/<work>.py``; a metric's reader, end-to-end or
per-layer, ``metrics/<metric>.py``. Adding one is adding its file and its
entry in BENCHMARK.json: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list        # the metric entries this cell reports
    per_layer: list


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_path(name: str, base: Path = HERE) -> Path:
    return base / "configs" / f"{name}.json"


def traffic_path(name: str, base: Path = HERE) -> Path:
    return base / "traffic" / f"{name}.json"


def metric_path(name: str, base: Path = HERE) -> Path:
    return base / "metrics" / f"{name}.py"


def work_path(name: str, base: Path = HERE) -> Path:
    return base / "work" / f"{name}.py"


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, base: Path = HERE) -> Cell:
    """The workload `name` with its configuration, traffic and metrics."""
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(workload=w,
                config=read_json(config_path(w["config"], base)),
                traffic=read_json(traffic_path(w["traffic"], base)),
                end_to_end=[m for m in manifest["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _reports(m, name)])


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, base: Path = HERE):
    """metrics/<name>.py: ``read(run)``, and optionally ``install(prog,
    probes)`` for the wrappers a per-layer metric needs in a traced run."""
    return _load(metric_path(name, base), "portbench_metric_")


def reader(name: str, base: Path = HERE):
    """The `read(run)` function of metrics/<name>.py."""
    return metric(name, base).read


def work(name: str, base: Path = HERE):
    """work/<name>.py: ``start(ctx)`` -> a work (see harness.py)."""
    return _load(work_path(name, base), "portbench_work_")
