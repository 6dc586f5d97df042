"""Everything of the benchmark is found by name, each in a file of its own:

- ``BENCHMARK.json`` at the checkout's root: the cells and which metrics
  each reports;
- ``portbench/cells/<cell>.json``: a cell's configuration, traffic mix,
  correctness sample and limits;
- ``portbench/configs/<config>.json``: a model configuration as it is run;
- ``portbench/traffic/<mix>.json``: a traffic mix's parameters, read by
  its ``kind``;
- ``portbench/traffic/<kind>.py``: a kind of traffic (traffic/__init__.py);
- ``portbench/metrics/<metric>.py``: one metric's reader. A metric whose
  cells report different end-to-end metrics is split by a suffix: the
  image cell's rate, whose runs spread wider than the video cells', has a
  bound of its own as ``frames_per_s.image``, and the metrics that move it
  are ``idle_share.image`` and so on. Such a name reads with the file of
  its first part.

A later cell, configuration, mix, kind or metric is a new file and a new
entry in BENCHMARK.json; no file that is already there changes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    spec: dict  # cells/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    end_to_end: List[str]  # the metrics a --trace 0 run reports
    per_layer: List[str]  # the metrics a --trace 1 run reports


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = HERE.parent) -> dict:
    return _json(root / "BENCHMARK.json")


def _reported(metrics: List[dict], cell: str) -> List[str]:
    return [m["name"] for m in metrics if "workloads" not in m or cell in m["workloads"]]


def cell(name: str, root: Path = HERE.parent) -> Cell:
    """A cell by its workload name; raises KeyError for one that
    BENCHMARK.json does not list."""
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    here = root / "portbench"
    spec = _json(here / "cells" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"cells/{name}.json and BENCHMARK.json name different configurations or mixes")
    return Cell(name, int(entry["chips"]), spec, _json(here / "configs" / f"{entry['config']}.json"),
                _json(here / "traffic" / f"{entry['traffic']}.json"),
                _reported(bench["end_to_end"], name), _reported(bench["per_layer"], name))


def metric(name: str):
    """The reader module of a metric: ``read(run)`` and its UNIT, BETTER,
    SOURCE (and, per layer, LAYER)."""
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}")


def generator(traffic: dict):
    """The kind module of a traffic mix (``traffic/<kind>.py``), whose
    ``Mix(params, seed)`` makes the mix's requests."""
    return importlib.import_module(f"portbench.traffic.{traffic['kind']}")
