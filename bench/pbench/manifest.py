"""Finding a cell's files by the names in ``BENCHMARK.json``.

- the configuration: the ``file`` of its ``configs`` entry;
- the cell: ``bench/cells/<workload>.json`` (its kind, engine and load);
- the traffic mix: ``bench/traffic/<traffic>.json``;
- the kind of run: ``bench/kinds/<kind>.py``;
- each metric: ``bench/metrics/<metric>.py``, whose ``read(run)`` returns
  the number or None where it finds nothing to read; where no file has the
  metric's whole name, the file of its name before the first dot (one
  reader for ``device_idle.chat`` and ``device_idle.docs``).

A later cell, mix, configuration or metric is new files and new entries:
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json", bench: Path = BENCH):
        self.data = json.loads(Path(path).read_text())
        self.root = Path(path).parent
        self.bench = bench

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return json.loads((self.bench / "cells" / f"{name}.json").read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those with no list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def kind(self, name: str):
        """The module of ``bench/kinds/<name>.py``."""
        return _load(self.bench / "kinds" / f"{name}.py", f"kinds.{name}")

    def reader(self, name: str):
        """The ``read`` function of ``bench/metrics/<name>.py``, or of the
        file of the name's part before the first dot where there is none."""
        base = name.split(".")[0]
        if not (self.bench / "metrics" / f"{name}.py").is_file():
            name = base
        return _load(self.bench / "metrics" / f"{name}.py", f"metrics.{name}").read


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass looks its module up while it is made
    spec.loader.exec_module(mod)
    return mod
