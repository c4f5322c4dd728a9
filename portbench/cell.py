"""What a cell is made of, found by name: the cell's entry in
`BENCHMARK.json`, `configs/<config>.json`, `traffic/<traffic>.json` and a
reader `metrics/<metric>.py` for each metric.  A cell reports an
end-to-end metric whose entry lists the cell under `workloads`, or has no
such key; and a per-layer metric whose entry lists the cell, or, without
the key, whose `moves` the cell reports; each where its reader finds
something to read.  Adding a configuration, a traffic mix or a metric is
adding files and entries; no file here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # BENCHMARK.json's metric entries it reports
    per_layer: list


def _lists(metric: dict, workload: str, default: bool) -> bool:
    return workload in metric["workloads"] if "workloads" in metric \
        else default


def load(workload: str, root: str = HERE) -> Cell:
    """The cell `workload` of `<root>/../BENCHMARK.json`."""
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    with open(os.path.join(root, "configs", entry["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _lists(m, workload, True)]
    names = {m["name"] for m in e2e}
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"]
                           if _lists(m, workload, m["moves"] in names)])


def metric_reader(name: str, root: str = HERE):
    """The module `metrics/<name>.py`: UNIT, LAYER, SOURCE, MOVES and
    `read(run) -> float | None`."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
