"""The byte model against counts made by hand."""

import pytest

from cgbench import bytemodel
from cgbench.spec import Bench

N = 104


@pytest.fixture(scope="module")
def bench():
    return Bench()


def test_hpcg_counts(bench):
    ref = bench.module("reference", "hpcg27")
    cfg = bench.config("hpcg-104")
    assert ref.n(cfg) == N**3 == 1_124_864
    assert ref.nnz(cfg) == (3 * N - 2) ** 3 == 29_791_000
    assert ref.stored_nnz(cfg) == 15_457_932
    assert ref.operator_bytes(cfg, 4) == 15_457_932 * 8 + 4 * N**3


@pytest.mark.parametrize("workload, expected", [
    ("hpcg-104.cg", 155_159_648),
    ("hpcg-104.lockstep32", 992_058_464),
    ("poisson7-256.cg", 402_653_184),
    ("poisson7-256.cg-f64", 805_306_368),
])
def test_step_bytes(bench, workload, expected):
    w = bench.workload(workload)
    cfg = bench.config(w["config"])
    ref = bench.module("reference", cfg["operator"])
    assert bytemodel.step_bytes(ref, cfg, bench.traffic(w["traffic"])) == expected


def test_hpcg_nnz_matches_a_dense_count(bench):
    """(3N - 2)^3 and the stored count agree with the operator itself."""
    import torch

    ref = bench.module("reference", "hpcg27")
    cfg = {"grid": [5, 4, 3], "center": 26.0, "off": -1.0}
    n = ref.n(cfg)
    dense = ref.matvec(cfg, torch.eye(n, dtype=torch.float64))
    assert int((dense != 0).sum()) == ref.nnz(cfg)
    assert int((torch.triu(dense) != 0).sum()) == ref.stored_nnz(cfg)


def test_stencil_nnz_matches_a_dense_count(bench):
    import torch

    ref = bench.module("reference", "stencil7")
    cfg = {"grid": [5, 4, 3], "center": 6.0, "off": -1.0}
    dense = ref.matvec(cfg, torch.eye(ref.n(cfg), dtype=torch.float64))
    assert int((dense != 0).sum()) == ref.nnz(cfg)
