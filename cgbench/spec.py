"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files this package finds by the names it holds.

Everything that belongs to one configuration, traffic mix, operator,
request entry or per-layer metric sits in a file of its own, found by name:

* ``configs/<config>.json`` (the path is the config's ``file`` entry): the
  operator's sizes, its ``operator`` family and its source;
* ``traffic/<mix>.json``: the parameters the general generator
  (``traffic.py``) reads, and the ``solver`` that serves a request;
* ``operators/<family>.py``: builds the port's operator from a config;
* ``reference/<family>.py``: the plain product, sizes and operator bytes;
* ``solvers/<solver>.py``: one request into the port;
* ``metrics/<metric>.py``: a per-layer metric's reader;
* ``limits/<workload>.json``: the limits of the comparison that decides
  ``correct`` in that cell.

A cell, configuration, mix or metric is added by adding files and entries;
no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Optional

#: the checkout's root: the directory that holds BENCHMARK.json and cgbench/
REPO = Path(__file__).resolve().parents[1]
PACKAGE = "cgbench"


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else REPO
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.spec["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.root / PACKAGE / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        """``cgbench/<kind>/<name>.py``, loaded from its file (a name may
        hold dots or dashes, which an import statement cannot spell)."""
        key = (kind, name)
        if key not in self._modules:
            path = self.root / PACKAGE / kind / f"{name}.py"
            if not path.is_file():
                raise FileNotFoundError(f"{kind} module {name!r}: no file {path}")
            safe = "".join(ch if ch.isalnum() else "_" for ch in name)
            spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{kind}_{safe}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics_of(self, section: str, workload: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` that ``workload``
        reports: those that list it, and those that list no workloads."""
        return [m for m in self.spec[section]
                if "workloads" not in m or workload in m["workloads"]]
