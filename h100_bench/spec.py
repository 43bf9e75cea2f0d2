"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration,
traffic mix and metrics; everything else lives in a file of its own under
this folder, found by that name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the window driver and its parameters;
- ``drivers/<driver>.py``: one module per kind of window, with ``run``;
- ``metrics/<metric>.py``: one reader per per-layer metric, with ``read``;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    pass


def check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{kind} {name!r}: a name is 1 to 64 of A-Z a-z 0-9 "
                        "_ . - and starts with a letter, digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise SpecError(f"unit {unit!r}: 1 to 16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    if not os.path.exists(path):
        raise SpecError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: str = ROOT):
        here = os.path.join(root, os.path.relpath(HERE, ROOT))
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        self.name = check_name("workload", name)
        self.chips = int(w["chips"])
        self.config_name = check_name("config", w["config"])
        self.traffic_name = check_name("traffic", w["traffic"])
        self.config = _json(os.path.join(here, "configs",
                                         self.config_name + ".json"))
        self.traffic = _json(os.path.join(here, "traffic",
                                          self.traffic_name + ".json"))
        self.driver_name = check_name("driver", self.traffic["driver"])
        self.driver_path = os.path.join(here, "drivers",
                                        self.driver_name + ".py")
        self.limits = _json(os.path.join(here, "limits", name + ".json"))
        self.end_to_end = [self._metric(m) for m in bench["end_to_end"]
                           if self._reports(m)]
        self.per_layer = [self._metric(m) for m in bench["per_layer"]
                          if self._reports(m)]
        self._metrics_dir = os.path.join(here, "metrics")

    def _reports(self, m: Dict) -> bool:
        return "workloads" not in m or self.name in m["workloads"]

    @staticmethod
    def _metric(m: Dict) -> Dict:
        check_name("metric", m["name"])
        check_unit(m["unit"])
        return m

    def driver(self) -> ModuleType:
        return load_module(self.driver_path, "driver_" + self.driver_name)

    def reader(self, metric: str) -> ModuleType:
        return load_module(os.path.join(self._metrics_dir, metric + ".py"),
                       "metric_" + metric)
