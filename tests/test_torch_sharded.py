"""The port's row-sharded blocked-ELL solve (``conjugategradient_tpu_torch
.parallel``) against the JAX package's, on the CPU: the partitioner bit for
bit, the portable float64 CG / PCG / MINRES loops against the JAX sharded
loops (8 virtual devices, tests/conftest.py) and against the port's
one-device solvers, the front end's dispatch, and the port's in-process
shard group (every shard on the CPU here).

Tolerances, with their reasons: float64 CG runs take the same number of
iterations as the JAX sharded loop and the one-device solver, x agrees to
1e-11 of max|x| and ``rho_history`` to 1e-9 relative above 1e-20·ρ₀ (the
sums run in another order: the shards' partial sums, the einsum); MINRES's
Givens recurrence amplifies last-ulp differences, so its iteration counts
may differ by 2 from the one-device solver (the JAX package's own bound,
tests/test_sharded_minres.py) and are held equal to the JAX sharded loop's.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conjugategradient_tpu.parallel import make_row_mesh as jmesh
from conjugategradient_tpu.parallel import partition_csr_rows as jpartition
from conjugategradient_tpu.parallel import sharded_cg_solve as jsolve
from conjugategradient_tpu_torch import CSRMatrix, cg_solve, convert, minres_solve
from conjugategradient_tpu_torch.parallel import (
    InProcessGroup,
    make_row_mesh,
    partition_csr_rows,
    sharded_cg_solve,
)
from conjugategradient_tpu_torch.parallel.local_ops import _local_bell_matvec
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.types.base import DEFAULT_DEVICE

N_DEV = 8
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _csr(coo, dtype=np.float64, diag_shift=0.0):
    rows, cols, vals, shape = coo
    vals = np.asarray(vals, np.float64).copy()
    vals[np.asarray(rows) == np.asarray(cols)] -= diag_shift
    a = sp.csr_matrix((vals.astype(dtype), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


def _setup(a, n_shards=N_DEV, bm=8, bn=8):
    """Partitioned tiles, b = 1..n padded, in both packages' forms."""
    n = a.shape[0]
    blocks, bcols, n_pad = partition_csr_rows(a.data, a.indices, a.indptr, a.shape,
                                              n_shards, bm=bm, bn=bn)
    b = np.zeros(n_pad, a.dtype)
    b[:n] = reference_rhs(n, dtype=a.dtype)
    return blocks, bcols, b, n


def _port(blocks, bcols, b, **kw):
    return sharded_cg_solve(blocks, bcols, b, mesh=make_row_mesh(blocks.shape[0], "cpu"), **kw)


def _single(a):
    return CSRMatrix.from_arrays(a.data, a.indices, a.indptr, a.shape, device="cpu")


def _assert_history(h_port, h_ref, k, rtol=1e-9):
    h_port = np.asarray(h_port)[:k + 1]
    h_ref = np.asarray(h_ref)[:k + 1]
    sel = h_ref > h_ref[0] * 1e-20
    np.testing.assert_allclose(h_port[sel], h_ref[sel], rtol=rtol)


def _assert_x(x_port, x_ref, n):
    x_port, x_ref = np.asarray(x_port)[:n], np.asarray(x_ref)[:n]
    np.testing.assert_allclose(x_port, x_ref, rtol=0, atol=1e-11 * np.abs(x_ref).max())


# ---- the partitioner ------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("tile", [8, 128])
@pytest.mark.parametrize("coo", [poisson2d_coo(10, 12), banded_spd_coo(300)],
                         ids=["poisson2d_10x12", "banded_300"])
def test_partition_csr_rows_bitwise(coo, tile, n_shards):
    a = _csr(coo)
    got = partition_csr_rows(a.data, a.indices, a.indptr, a.shape, n_shards, bm=tile, bn=tile)
    want = jpartition(a.data, a.indices, a.indptr, a.shape, n_shards, bm=tile, bn=tile)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tile_map(blocks, cols):
    """{(shard, row block, column block): tile} over the nonzero tiles."""
    out = {}
    for s, i, k in np.ndindex(*cols.shape):
        if blocks[s, i, k].any():
            key = (s, i, int(cols[s, i, k]))
            assert key not in out
            out[key] = blocks[s, i, k]
    return out


@pytest.mark.parametrize("n_shards", [4, 8])
def test_block_tridiag_split_is_the_partitioned_operator(n_shards):
    """chip_smoke.py splits problems.block_tridiag_tiles by block-rows in
    place of partitioning its CSR (~100 M nonzeros at the full size): at
    n = 4096 the split and partition_csr_rows on the same generator's CSR
    hold the same (row block, column block) -> tile map and give the same
    SpMV (slot order may differ, so the sums to 1e-12)."""
    from conjugategradient_tpu_torch.problems import block_tridiag_tiles
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    n, bn = 4096, 128
    split_blocks, split_cols = _chip_smoke().split_tridiag_tiles(n, n_shards, bn)
    tiles, tcols, nnz = block_tridiag_tiles(n, bn, bn, seed=0)
    dense = BlockedEllMatrix(torch.from_numpy(tiles), torch.from_numpy(tcols), (n, n),
                             nnz).to_dense().numpy()
    a = sp.csr_matrix(dense)
    blocks, bcols, n_pad = partition_csr_rows(a.data, a.indices, a.indptr, a.shape,
                                              n_shards, bm=bn, bn=bn)
    assert n_pad == n and split_blocks.shape[:2] == blocks.shape[:2]
    got, want = _tile_map(split_blocks, split_cols), _tile_map(blocks, bcols)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((n // bn, bn)))
    for s in range(n_shards):
        y_split = _local_bell_matvec(torch.from_numpy(split_blocks[s]).double(),
                                     torch.from_numpy(split_cols[s]), x)
        y_part = _local_bell_matvec(torch.from_numpy(blocks[s]).double(),
                                    torch.from_numpy(bcols[s]), x)
        np.testing.assert_allclose(y_split.numpy(), y_part.numpy(), rtol=1e-12, atol=1e-12)


# ---- the portable float64 loops ----------------------------------------------------

@pytest.mark.parametrize("coo,tol", [(poisson2d_coo(20), 1e-10),
                                     (banded_spd_coo(300, bandwidth=9, seed=4), 1e-9)],
                         ids=["poisson2d_20", "banded_300"])
def test_portable_cg_matches_jax_and_one_device(coo, tol):
    """The port solves the JAX partition's own arrays (carried across by
    convert.sharded_bell_from_arrays)."""
    a = _csr(coo)
    blocks, bcols, b, n = _setup(a)
    jb, jc, _ = jpartition(a.data, a.indices, a.indptr, a.shape, N_DEV, bm=8, bn=8)
    x, info = _port(*convert.sharded_bell_from_arrays(jb, jc, device="cpu"), b, tol=tol,
                    use_fused="never")
    xj, ij = jsolve(blocks, bcols, b, tol=tol, maxiter=b.shape[0] + 1, use_fused="never")
    x1, i1 = cg_solve(_single(a), torch.as_tensor(b[:n]), tol=tol)
    k = int(info.iterations)
    assert bool(info.converged) and k == int(ij.iterations) == int(i1.iterations)
    _assert_x(x, xj, n)
    _assert_x(x, x1, n)
    _assert_history(info.rho_history, ij.rho_history, k)
    _assert_history(info.rho_history, i1.rho_history, k)
    assert not bool(x[n:].any())


def test_portable_jacobi_pcg_matches_jax_and_one_device():
    from conjugategradient_tpu_torch import jacobi_preconditioner

    a = _csr(banded_spd_coo(300, bandwidth=5, seed=13))
    blocks, bcols, b, n = _setup(a)
    inv_diag = np.ones(b.shape[0])
    inv_diag[:n] = 1.0 / a.diagonal()
    x, info = _port(blocks, bcols, b, tol=1e-9, inv_diag=inv_diag)
    xj, ij = jsolve(blocks, bcols, b, tol=1e-9, maxiter=b.shape[0] + 1, inv_diag=inv_diag)
    csr = _single(a)
    x1, i1 = cg_solve(csr, torch.as_tensor(b[:n]), tol=1e-9, M=jacobi_preconditioner(csr))
    k = int(info.iterations)
    assert k == int(ij.iterations) == int(i1.iterations)
    _assert_x(x, xj, n)
    _assert_x(x, x1, n)
    _assert_history(info.rho_history, ij.rho_history, k)
    np.testing.assert_allclose(float(info.rho), float(ij.rho), rtol=1e-6)


def test_portable_restart_matches_jax_and_one_device():
    """Residual replacement every 7 steps (tests/test_sharded.py:567), at
    tol 1e-8 (2e-12 of ||b||): at the JAX test's 1e-10 the replaced
    residual bounces at the float64 floor, and the two packages stop a few
    steps apart (445 against 443)."""
    a = _csr(poisson2d_coo(20))
    blocks, bcols, b, n = _setup(a)
    x, info = _port(blocks, bcols, b, tol=1e-8, recompute_r_every=7)
    xj, ij = jsolve(blocks, bcols, b, tol=1e-8, maxiter=b.shape[0] + 1, recompute_r_every=7)
    x1, i1 = cg_solve(_single(a), torch.as_tensor(b[:n]), tol=1e-8, recompute_r_every=7,
                      fused="never")
    k = int(info.iterations)
    assert k == int(ij.iterations) == int(i1.iterations)
    _assert_x(x, xj, n)
    _assert_x(x, x1, n)
    # past ~1e-15 of rho_0 the replaced residual is summation-order noise;
    # above it the 377 steps and their restarts part by 1.7e-7 at most
    h, hj = np.asarray(info.rho_history)[:k], np.asarray(ij.rho_history)[:k]
    sel = hj > hj[0] * 1e-15
    np.testing.assert_allclose(h[sel], hj[sel], rtol=1e-6)
    _, plain = _port(blocks, bcols, b, tol=1e-8)
    kp = min(k, int(plain.iterations))
    assert not np.allclose(h[:kp], np.asarray(plain.rho_history)[:kp], rtol=1e-12)


@pytest.mark.parametrize("method", ["standard", "minres"])
def test_maxiter_zero_and_converged_flags(method):
    a = _csr(poisson2d_coo(8))
    blocks, bcols, b, n = _setup(a)
    x, info = _port(blocks, bcols, b, maxiter=0, method=method)
    xj, ij = jsolve(blocks, bcols, b, maxiter=0, method=method)
    assert int(info.iterations) == int(ij.iterations) == 0
    assert bool(info.converged) == bool(ij.converged) is False
    assert not bool(x.any())
    np.testing.assert_allclose(np.asarray(info.rho_history), np.asarray(ij.rho_history),
                               rtol=1e-12)


def test_portable_minres_indefinite_matches_jax():
    """2-D Poisson shifted by 3 inside its spectrum, held to the contract
    of tests/test_sharded_minres.py:58 against both the JAX sharded loop
    and the port's one-device solver: iterations within 2, the true
    residual and x to 2e-9 / 1e-8, the phibar history to 1e-8 over its
    first 20 steps and to 1e-2 phibar_0 after (the Givens recurrence parts
    two summation orders deep inside this spectrum: 236 steps here, 238 in
    the JAX loop)."""
    a = _csr(poisson2d_coo(20), diag_shift=3.0)
    blocks, bcols, b, n = _setup(a)
    x, info = _port(blocks, bcols, b, tol=1e-9, maxiter=4 * n, method="minres")
    xj, ij = jsolve(blocks, bcols, b, tol=1e-9, maxiter=4 * n, method="minres")
    xs, i_s = minres_solve(_single(a), torch.as_tensor(b[:n]), tol=1e-9, maxiter=4 * n)
    k = int(info.iterations)
    assert bool(info.converged) and bool(ij.converged)
    r = b[:n] - a @ np.asarray(x[:n])
    assert np.linalg.norm(r) <= 2e-9
    # rho_history holds phibar^2 (the JAX sharded loop's convention); the
    # one-device solver's history holds phibar
    h = np.sqrt(np.asarray(info.rho_history))
    for ref_k, ref_x, ref_h in ((int(ij.iterations), xj, np.sqrt(np.asarray(ij.rho_history))),
                                (int(i_s.iterations), xs, np.asarray(i_s.rnorm_history))):
        assert abs(k - ref_k) <= 2
        np.testing.assert_allclose(np.asarray(x[:n]), np.asarray(ref_x[:n]), atol=1e-8)
        kk = min(k, ref_k)
        assert np.max(np.abs(h[:kk + 1] - ref_h[:kk + 1])) <= 1e-2 * ref_h[0]
        np.testing.assert_allclose(h[:20], ref_h[:20], rtol=1e-8)


def test_portable_minres_monotone_and_padding_inert():
    a = _csr(poisson2d_coo(14), diag_shift=2.5)
    blocks, bcols, b, n = _setup(a)
    x, info = _port(blocks, bcols, b, tol=1e-9, maxiter=4 * n, method="minres")
    k = int(info.iterations)
    h = np.sqrt(np.asarray(info.rho_history)[:k + 1])
    assert bool(info.converged) and np.all(np.diff(h) <= 1e-12 * h[0])
    assert not bool(x[n:].any())


def test_portable_minres_jacobi_matches_jax():
    """A scaled SPD banded system: Jacobi MINRES converges, in fewer steps
    than without, as the JAX sharded loop (tests/test_sharded_minres.py:86)."""
    rows, cols, vals, shape = banded_spd_coo(300, bandwidth=9, seed=4)
    scale = np.exp(np.random.default_rng(6).uniform(-1.5, 1.5, shape[0]))
    vals = np.asarray(vals, float) * scale[np.asarray(rows)] * scale[np.asarray(cols)]
    a = _csr((rows, cols, vals, shape))
    blocks, bcols, b, n = _setup(a)
    inv_diag = np.ones(b.shape[0])
    inv_diag[:n] = 1.0 / a.diagonal()
    _, iu = _port(blocks, bcols, b, tol=1e-8, maxiter=4 * n, method="minres")
    x, info = _port(blocks, bcols, b, tol=1e-8, maxiter=4 * n, method="minres",
                    inv_diag=inv_diag)
    xj, ij = jsolve(blocks, bcols, b, tol=1e-8, maxiter=4 * n, method="minres",
                    inv_diag=inv_diag)
    assert bool(info.converged) and int(info.iterations) == int(ij.iterations)
    assert int(info.iterations) < int(iu.iterations)
    assert np.linalg.norm(b[:n] - a @ np.asarray(x[:n])) <= 1e-6
    np.testing.assert_allclose(np.asarray(x[:n]), np.asarray(xj[:n]), atol=1e-9)


# ---- the front end's dispatch -------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    return _setup(_csr(poisson2d_coo(8)))


@pytest.mark.parametrize("kw,err,match", [
    (dict(use_fused="sometimes"), ValueError, "use_fused must be one of"),
    (dict(method="bogus"), ValueError, "unknown method"),
    (dict(method="minres", recompute_r_every=8), ValueError, "residual-replacement"),
    (dict(use_fused="always", recompute_r_every=5), ValueError, "residual-replacement"),
    (dict(method="pipelined"), NotImplementedError, "ROADMAP.md section 1, item 12"),
    (dict(method="sstep"), NotImplementedError, "ROADMAP.md section 1, item 12"),
    (dict(method="bicgstab"), NotImplementedError, "ROADMAP.md section 1, item 12"),
    (dict(method="gmres"), NotImplementedError, "ROADMAP.md section 1, item 12"),
])
def test_dispatch_errors(small, kw, err, match):
    blocks, bcols, b, _ = small
    with pytest.raises(err, match=match):
        _port(blocks, bcols, b, **kw)
    if err is ValueError and "use_fused" not in match and "unknown" not in match:
        with pytest.raises(ValueError, match=match):  # the JAX package's own
            jsolve(blocks, bcols, b, **kw)


def test_group_must_match_the_shards(small):
    blocks, bcols, b, _ = small
    with pytest.raises(ValueError, match="shards"):
        sharded_cg_solve(blocks, bcols, b, mesh=make_row_mesh(4, "cpu"))


def test_auto_runs_the_portable_loop_on_the_cpu():
    """On CPU tensors "auto" is the portable loop (the fused one needs a
    CUDA operator); "always" runs the fused loop on the plain kernels."""
    from conjugategradient_tpu_torch.ops.cuda import _common

    a = _csr(poisson2d_coo(16), dtype=np.float32)
    blocks, bcols, b, n = _setup(a, n_shards=2, bm=128, bn=128)
    _common.reset_counts()
    _port(blocks, bcols, b, maxiter=3)
    assert _common.LAUNCHES["bell_spmv_dot"] == 0
    _port(blocks, bcols, b, maxiter=3, use_fused="always")
    assert _common.LAUNCHES["bell_spmv_dot"] == 0  # plain versions: not counted


def test_entry_points_default_to_the_card():
    """make_row_mesh and Timer default to types.base.DEFAULT_DEVICE,
    checked without touching CUDA."""
    from conjugategradient_tpu_torch.utils import Timer

    g = make_row_mesh()
    assert isinstance(g, InProcessGroup) and g.n_shards == 1
    assert g.device == torch.device(DEFAULT_DEVICE) == Timer().device
    assert make_row_mesh(3, "cpu").shards == (0, 1, 2)


def test_jax_mesh_and_port_group_agree_on_layout():
    """The JAX mesh of the same size shards rows the same way: shard s owns
    rows [s·m, (s+1)·m)."""
    g = make_row_mesh(4, "cpu")
    assert jmesh(jax.devices()[:4]).devices.size == g.n_shards
    assert [g.row_offset(s, 32) for s in g.shards] == [0, 32, 64, 96]


def test_in_process_gather_and_fixed_order_sum():
    g = make_row_mesh(3, "cpu")
    buf = torch.arange(12.0)
    views = [buf[i * 4:(i + 1) * 4] for i in range(3)]
    assert g.all_gather(views).data_ptr() == buf.data_ptr()  # no copy
    parts = [torch.arange(4.0) + i for i in range(3)]
    assert torch.equal(g.all_gather(parts), torch.cat(parts))
    p = [torch.tensor(1e8, dtype=torch.float32), torch.tensor(1.0), torch.tensor(-1e8)]
    assert float(g.psum(p)) == float((p[0] + p[1]) + p[2])  # left to right: 0.0
    assert g.counts == {"all_gather": 2, "psum": 1}
