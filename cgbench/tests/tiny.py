"""A copy of the benchmark's files at sizes a CPU test can hold: every
configuration's grid shrunk and every pool cut to two requests.  Code,
traffic parameters, limits and BENCHMARK.json are the real ones."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from cgbench.spec import REPO

GRIDS = {"hpcg27": [8, 8, 8], "stencil7": [12, 10, 8]}


def tiny_root(tmp: Path) -> Path:
    root = Path(tmp) / "tiny"
    shutil.copytree(REPO / "cgbench", root / "cgbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["grid"] = GRIDS[cfg["operator"]]
        path.write_text(json.dumps(cfg))
    for path in (root / "cgbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["pool"] = 2
        path.write_text(json.dumps(mix))
    return root
