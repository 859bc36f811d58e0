"""The plain references at tiny grids against dense matrices built by hand
and a dense solve."""

import itertools

import pytest
import torch

from cgbench.spec import Bench


@pytest.fixture(scope="module")
def bench():
    return Bench()


def dense_hpcg(grid, center, off):
    nx, ny, nz = grid
    n = nx * ny * nz
    A = torch.zeros(n, n, dtype=torch.float64)
    for z, y, x in itertools.product(range(nz), range(ny), range(nx)):
        r = x + nx * (y + ny * z)
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            if 0 <= x + dx < nx and 0 <= y + dy < ny and 0 <= z + dz < nz:
                c = (x + dx) + nx * ((y + dy) + ny * (z + dz))
                A[r, c] = center if c == r else off
    return A


def dense_stencil7(grid, center, off):
    nx, ny, nz = grid
    n = nx * ny * nz
    A = torch.zeros(n, n, dtype=torch.float64)
    for i, j, k in itertools.product(range(nx), range(ny), range(nz)):
        r = (i * ny + j) * nz + k
        A[r, r] = center
        for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
            a, b, c = i + d[0], j + d[1], k + d[2]
            if 0 <= a < nx and 0 <= b < ny and 0 <= c < nz:
                A[r, (a * ny + b) * nz + c] = off
    return A


@pytest.mark.parametrize("family, dense, grid", [
    ("hpcg27", dense_hpcg, (5, 4, 3)),
    ("hpcg27", dense_hpcg, (3, 3, 3)),
    ("stencil7", dense_stencil7, (5, 4, 3)),
    ("stencil7", dense_stencil7, (2, 6, 4)),
])
def test_operator_against_dense(bench, family, dense, grid):
    ref = bench.module("reference", family)
    center, off = (26.0, -1.0) if family == "hpcg27" else (6.0, -1.0)
    cfg = {"grid": list(grid), "center": center, "off": off}
    A = dense(grid, center, off)
    X = torch.randn(3, A.shape[0], dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(ref.matvec(cfg, X), X @ A.T, rtol=0, atol=1e-12)
    torch.testing.assert_close(ref.matvec(cfg, X[0]), A @ X[0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("family, grid", [("hpcg27", (6, 5, 4)), ("stencil7", (7, 6, 5))])
def test_cg_against_dense_solve(bench, family, grid):
    ref = bench.module("reference", family)
    refcg = bench.module("reference", "cg")
    center, off = (26.0, -1.0) if family == "hpcg27" else (6.0, -1.0)
    cfg = {"grid": list(grid), "center": center, "off": off}
    n = ref.n(cfg)
    A = ref.matvec(cfg, torch.eye(n, dtype=torch.float64))
    B = torch.randn(4, n, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    tol = 1e-12 * torch.linalg.vector_norm(B, dim=1)
    X, k = refcg.cg(lambda v: ref.matvec(cfg, v), B, tol, n + 1)
    exact = torch.linalg.solve(A, B.T).T
    torch.testing.assert_close(X, exact, rtol=1e-9, atol=1e-9)
    assert bool((k > 0).all()) and bool((k <= n + 1).all())


def test_cg_stops_one_update_after_the_tolerance(bench):
    """The step that sees ||r_k|| <= tol still updates, as the port's does;
    a lane already within tolerance takes that one step and stops."""
    ref = bench.module("reference", "stencil7")
    refcg = bench.module("reference", "cg")
    cfg = {"grid": [4, 4, 4], "center": 6.0, "off": -1.0}
    B = torch.randn(2, 64, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    tol = torch.tensor([1e-6, 1e9], dtype=torch.float64) * torch.linalg.vector_norm(B, dim=1)
    X, k = refcg.cg(lambda v: ref.matvec(cfg, v), B, tol, 65)
    assert int(k[1]) == 1
    R = B - ref.matvec(cfg, X)
    assert float(torch.linalg.vector_norm(R[0])) <= float(tol[0])
