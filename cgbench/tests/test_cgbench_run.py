"""The result line, the entry point's refusals, and the check that no
module of JAX or the JAX package is loaded."""

import json
import os
import subprocess
import sys
import time

import pytest

from cgbench import harness, run
from cgbench.spec import REPO, Bench
from cgbench.tests.tiny import tiny_root

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Bench(tiny_root(tmp_path_factory.mktemp("run")))


@pytest.mark.parametrize("workload", ["hpcg-104.cg", "poisson7-256.cg",
                                      "hpcg-104.lockstep32", "poisson7-256.cg-f64"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny, workload, trace):
    result = harness.run_cell(tiny, workload, 3_000_000_019, 0.2, trace, "cpu",
                              time.perf_counter(), log=lambda s: None)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    section = "per_layer" if trace else "end_to_end"
    # a CPU run has no device trace: the readers of the trace return nothing
    names = {m["name"] for m in tiny.metrics_of(section, workload)}
    names -= {"step_roofline_share", "device_idle_share", "peak_mem_gib"}
    assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or m["unit"] == "launches"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(result["compared"]) == {"unconverged", *tiny.limits(workload)}
    json.dumps(result)


def test_same_seed_same_requests(tiny):
    from cgbench.traffic import draw_pool

    mix = tiny.traffic("lockstep32")
    a = draw_pool(mix, (5, 5, 4), 2**31 + 5, "cpu")
    b = draw_pool(mix, (5, 5, 4), 2**31 + 5, "cpu")
    c = draw_pool(mix, (5, 5, 4), 2**31 + 6, "cpu")
    assert [x.shape for x in a] == [(32, 100)] * 2
    assert all(bool((x == y).all()) for x, y in zip(a, b))
    assert not all(bool((x == y).all()) for x, y in zip(a, c))
    # the same base right-hand sides, moved: the same values in each
    assert all(bool((x.abs().sort().values == y.abs().sort().values).all())
               for x, y in zip(a, c))


@pytest.mark.parametrize("family, grid", [("hpcg27", [5, 5, 4]), ("stencil7", [4, 6, 6]),
                                          ("hpcg27", [4, 4, 4])])
def test_every_seed_the_same_work(tiny, family, grid):
    """The grid's symmetries commute with the operator, so a request's CG
    takes the same steps whatever the seed."""
    import torch
    from cgbench.traffic import draw_pool, symmetries

    ref, refcg = tiny.module("reference", family), tiny.module("reference", "cg")
    cfg = {"grid": grid, "center": 26.0 if family == "hpcg27" else 6.0, "off": -1.0}
    shape = ref.shape(cfg)
    x = torch.randn(ref.n(cfg), dtype=torch.float64)
    for flips, perm in symmetries(shape):
        def move(v):
            v = v.view(shape)
            v = v.flip(list(flips)) if flips else v
            return v.permute(*perm).reshape(-1)
        torch.testing.assert_close(ref.matvec(cfg, move(x)), move(ref.matvec(cfg, x)),
                                   rtol=0, atol=1e-12)
    mix = {**tiny.traffic("cg-f64"), "pool": 3}
    steps = []
    for seed in (1, 2**31 + 9, 77):
        B = torch.stack(draw_pool(mix, shape, seed, "cpu"))
        _, k = refcg.cg(lambda v: ref.matvec(cfg, v), B, 1e-5 * B.norm(dim=1), 1000)
        steps.append(k.tolist())
    assert steps[0] == steps[1] == steps[2]


def test_no_card_no_result():
    """Without a CUDA card the entry point exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, "-m", "cgbench.run", "--workload", "hpcg-104.cg",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("conjugategradient_tpu_torch", "conjugategradient_tpu_torch.solver",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in harness.forbidden_modules()
                if m.startswith(("conjugategradient_tpu_torch", "jaxtyping", "flaxen"))]
    for name in ("jax", "jaxlib.xla_client", "flax", "conjugategradient_tpu",
                 "conjugategradient_tpu.solver"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run of a cell, in a fresh interpreter, leaves no module of
    JAX or the JAX package in sys.modules."""
    root = tiny_root(tmp_path)
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from cgbench.spec import Bench\n"
        "from cgbench.harness import run_cell, forbidden_modules\n"
        f"r = run_cell(Bench(Path({str(root)!r})), 'hpcg-104.cg', 7, 0.1, False, 'cpu',"
        " time.perf_counter(), log=lambda s: None)\n"
        "assert r['correct']\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'conjugategradient_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax():
    """No file of the benchmark names JAX or the JAX package in an import."""
    import ast

    for path in (REPO / "cgbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_cache_dirs_are_fixed_inside_the_checkout():
    for rel in run.CACHES.values():
        assert not os.path.isabs(rel) and ".." not in rel


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the headline cell on the card, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "cgbench.run", "--workload", "hpcg-104.cg",
                          "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
