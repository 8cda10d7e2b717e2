"""Find everything a cell needs by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the rest is found from
those names, so a later cell, mix or metric is new files and entries only:

- the configuration: the file its ``configs`` entry gives;
- the traffic mix: ``traffic/<traffic>.json``;
- the limits that decide ``correct``: ``limits/<cell>.json``;
- each metric: ``metrics/<metric>.py``, whose ``read(rec)`` returns the
  number or None; a metric split by cells, ``<metric>.<part>``, is read by
  ``metrics/<metric>.py`` unless a file of its whole name exists;
- each operation's byte and flop model: ``roofline/<op>.py``;
- each matrix generator: ``generators/<name>.py``.

The files under ``traffic/``, ``limits/``, ``metrics/``, ``roofline/`` and
``generators/`` lie beside this module.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_modules: Dict[str, ModuleType] = {}


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` beside this module, loaded once by its path (a
    metric's name may hold dots and dashes, which a module name may not)."""
    path = os.path.join(HERE, kind, name + ".py")
    if path not in _modules:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{len(_modules)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _modules[path] = module
    return _modules[path]


def metric_reader(name: str) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    the part before its first dot."""
    if os.path.isfile(os.path.join(HERE, "metrics", name + ".py")):
        return load_module("metrics", name)
    return load_module("metrics", name.split(".", 1)[0])


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]    # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    w = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], w["config"], "configuration")
    return Cell(
        name=w["name"], chips=int(w["chips"]),
        config=_json(os.path.join(root, entry["file"])),
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "limits", w["name"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, w["name"])],
        per_layer=[m for m in bench["per_layer"] if _applies(m, w["name"])])
