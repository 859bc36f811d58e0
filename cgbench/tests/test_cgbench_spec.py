"""BENCHMARK.json against the benchmark's contract, and cells, configs,
traffic mixes and per-layer metrics found from data files alone."""

import json
import re
import time

import pytest

from cgbench.harness import run_cell
from cgbench.spec import REPO, Bench
from cgbench.tests.tiny import tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["cgbench"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(spec, section):
    for e in spec[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_names_unique_and_cells_complete(spec):
    for section in KEYS:
        names = [e["name"] for e in spec[section]]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in spec["configs"]}
    assert {w["config"] for w in spec["workloads"]} == configs
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    bench = Bench()
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4)
        assert len(bench.metrics_of("end_to_end", w["name"])) >= 2
        assert bench.metrics_of("per_layer", w["name"])


def test_every_named_file_is_there(spec):
    bench = Bench()
    for c in spec["configs"]:
        assert c["file"].startswith("cgbench/")
        cfg = bench.config(c["name"])
        assert bench.module("operators", cfg["operator"]).build
        assert bench.module("reference", cfg["operator"]).matvec
    for w in spec["workloads"]:
        assert bench.module("solvers", bench.traffic(w["traffic"])["solver"]).Entry
        assert set(bench.limits(w["name"])) in ({"true_res", "x_gap"}, {"x_gap"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert bench.module("metrics", m["name"]).read


def test_extra_cell_found_from_new_files_only(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as files and entries, run without an edit to any existing file."""
    root = tiny_root(tmp_path)
    cg = root / "cgbench"
    before = {p: p.read_bytes() for p in cg.rglob("*") if p.is_file()}
    (cg / "configs" / "poisson7-tall.json").write_text(json.dumps(
        {"name": "poisson7-tall", "operator": "stencil7", "grid": [4, 6, 20],
         "center": 6.0, "off": -1.0}))
    mix = json.loads((cg / "traffic" / "cg.json").read_text())
    mix["pool"] = 3
    (cg / "traffic" / "cg-pool3.json").write_text(json.dumps(mix))
    (cg / "limits" / "poisson7-tall.cg-pool3.json").write_text(
        json.dumps({"true_res": 1e-4, "x_gap": 1e-3}))
    (cg / "metrics" / "requests_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.requests)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "poisson7-tall", "source": "a test",
                            "file": "cgbench/configs/poisson7-tall.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "poisson7-tall.cg-pool3", "config": "poisson7-tall",
                              "traffic": "cg-pool3", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "a test",
                              "moves": "solve_ms", "workloads": ["poisson7-tall.cg-pool3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root)
    result = run_cell(bench, "poisson7-tall.cg-pool3", 2**31 + 17, 0.2, True, "cpu",
                      time.perf_counter(), log=lambda s: None)
    assert result["correct"]
    assert result["metrics"]["requests_seen"]["value"] == result["attempted"]
    untouched = {p: p.read_bytes() for p in before}
    assert untouched == before
