"""The benchmark's manifest and the data files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
end-to-end metrics and the per-layer metrics.  Everything that belongs to
one configuration, traffic mix, cell or per-layer metric sits in a file of
its own, found by its name:

- ``portbench/configs/<config>.json``: the sizes as they are run, the
  port's config module that builds them, the reference family;
- ``portbench/traffic/<traffic>.json``: the parameters of the one traffic
  generator (``traffic.py``);
- ``portbench/workloads/<cell>.json``: the cell's configuration, traffic,
  entry (``portbench/entries/<entry>.py``), batch, ``why`` and the limits
  of its correctness numbers;
- ``portbench/metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str


def portbench_dir(root: str) -> str:
    return os.path.join(root, "portbench")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def data_file(root: str, kind: str, name: str, ext: str = ".json") -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return os.path.join(portbench_dir(root), kind, name + ext)


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric of the manifest is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of the manifest with its data files."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(data_file(root, "workloads", name))
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: the workload file's config and traffic "
                         "differ from BENCHMARK.json's")
    if not wl.get("limits"):
        raise ValueError(f"{name}: the workload file sets no limits")
    return Cell(
        name=name, chips=entry["chips"], workload=wl,
        config=load_json(data_file(root, "configs", wl["config"])),
        traffic=load_json(data_file(root, "traffic", wl["traffic"])),
        end_to_end=[m for m in man["end_to_end"] if reports(m, name)],
        per_layer=[m for m in man["per_layer"] if reports(m, name)],
        root=root)


def unlisted_cell(root: str, config: str, traffic: str, entry: str,
                  batch: int) -> Cell:
    """A cell that neither ``BENCHMARK.json`` nor a workload file names,
    for ``control.py``'s looks: no metrics and no limits."""
    name = f"{config}.{traffic}"
    return Cell(
        name=name, chips=1,
        workload={"config": config, "traffic": traffic, "entry": entry,
                  "batch": batch, "limits": {}},
        config=load_json(data_file(root, "configs", config)),
        traffic=load_json(data_file(root, "traffic", traffic)),
        end_to_end=[], per_layer=[], root=root)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: str, name: str):
    """The module of ``portbench/metrics/<name>.py``."""
    return load_module(data_file(root, "metrics", name, ".py"),
                       "portbench_metric_" + re.sub(r"\W", "_", name))


def entry_module(root: str, entry: str):
    return load_module(data_file(root, "entries", entry, ".py"),
                       "portbench_entry_" + entry)


def reference_module(root: str, family: str):
    return load_module(data_file(root, "reference", family, ".py"),
                       "portbench_reference_" + family)


def work_module(root: str, config: str):
    return load_module(data_file(root, "work", config, ".py"),
                       "portbench_work_" + re.sub(r"\W", "_", config))


def pick(values: Dict[str, float], metrics: List[dict]) -> Dict[str, dict]:
    """``{name: {value, unit}}`` of the metrics that have a value."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in metrics if values.get(m["name"]) is not None}

