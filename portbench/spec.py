"""What a cell is, found by name from BENCHMARK.json and portbench's files.

  BENCHMARK.json                 the cells, configurations and metrics
  portbench/configs/             a configuration's file, named in its
                                 entry; its "load" object holds options
                                 the run passes to Classifier.load
  portbench/traffic/<mix>.json   a traffic mix's parameters, read by the
                                 generator that its "generator" key names
                                 (portbench/traffic/<module>.py), or by
                                 portbench/gen.py where it names none
  portbench/metrics/<metric>.py  a metric's reader, read(ctx) -> a number
                                 or None where it finds nothing to read;
                                 a dot in the metric's name is a `_` in the
                                 file's

Adding a configuration, a traffic mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's parameters
    generator: types.ModuleType  # makes the sample, runs and checks a pass
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list


def load() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str) -> Cell:
    """The workload `name` with its configuration, traffic and metrics."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    generator = importlib.import_module(
        "portbench.traffic." + traffic.pop("generator")
        if "generator" in traffic else "portbench.gen")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                generator=generator,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def reader(metric: str):
    """The metric's read(ctx) function."""
    return importlib.import_module(
        "portbench.metrics." + metric.replace(".", "_")).read
