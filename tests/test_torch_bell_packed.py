"""The packed view of full blocked-ELL tiles (``BlockedEllMatrix.packed``)
and the route that reads it, in the port against the JAX package (CPU).

On the card, a float32 operator whose tiles are mostly empty takes kernels
4 and 5 on its packed nonzeros; here the same rule sends it to their plain
versions, so these tests run the route the card takes.  Same numpy inputs
on both sides; the JAX Pallas kernels run in interpret mode.  Tolerances,
with their reasons:

* the pack round trip: bitwise (the view holds the tiles' own values);
* SpMV and q: within ``RTOL = 1e-5`` of max|y| (f32 sums over a row in
  another order);
* p_new, pap: those of ``tests/test_torch_bell.py``'s kernel 4 test (p_new
  bitwise at β = 0, else within the rounding of XLA:CPU's FMA; pap rtol
  1e-5);
* fused solves: the f32 rule of ROADMAP — ``rho_history`` within rtol 1e-3
  over the first 20 steps, both converge, iterations within 4 — and the
  true residual ‖b − A x‖ of the port's answer within the tolerance (the
  recurrence residual stops below it; the true one is 0.74 of it here).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conjugategradient_tpu.ops.pallas import ell_spmv as jell
from conjugategradient_tpu.ops.pallas import fused_cg as jfc
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import cg_solve, convert
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import bell_spmv as tk5
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tfc
from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
from conjugategradient_tpu_torch.problems import block_tridiag_tiles, poisson2d_coo
from conjugategradient_tpu_torch.solver import fused_bell_cg_solve, fused_bell_pcg_solve
from conjugategradient_tpu_torch.types import BlockedEllMatrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _file_ops(name, bm, bn):
    path = ROOT / "problems" / name
    jb = JBell.from_csr_host(*tloader.read_csr_host(path), bm=bm, bn=bn, dtype=np.float32)
    return jb, _port(jb)


def _port(jb):
    return convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols),
                                    jb.shape, jb.nnz, device="cpu")


def _random_sparse(rng, n, ncols, per_row, spd=False):
    """Dense numpy matrix with ~per_row scattered nonzeros a row (tiles
    mostly empty); ``spd``: symmetric and diagonally dominant."""
    A = np.zeros((n, ncols), np.float32)
    for i in range(n):
        A[i, rng.choice(ncols, size=per_row, replace=False)] = rng.standard_normal(per_row)
    if spd:
        A = A + A.T
        A[np.arange(n), np.arange(n)] = np.abs(A).sum(axis=1) + 1
    return A


def _jax_bell(A, bm, bn):
    rows, cols = np.nonzero(A)
    return JBell.from_csr(JCSR.from_coo(rows, cols, A[rows, cols], A.shape, dtype=A.dtype),
                          bm=bm, bn=bn)


def _padded(tb, x):
    xp = np.zeros(tb.padded_shape[1], np.float32)
    xp[: len(x)] = x
    return xp


def _unpack(pk, block_cols, shape):
    """Tiles back from the view: each nonzero into the first slot of its
    block-row whose column block it names (the packer puts real tiles
    before padding, and gives each column block one slot)."""
    nrb, kmax, bm, bn = shape
    rows = np.arange(pk.rows)
    row_len = pk.row_len.numpy()
    k_max = int(row_len.max()) if len(row_len) else 0
    r, k = np.nonzero(np.arange(k_max)[None, :] < row_len[:, None])
    e = pk.chunk_off.numpy()[rows[r] // 32] + 32 * k + rows[r] % 32
    col = pk.cols.numpy()[e].astype(np.int64)
    rb, m = np.divmod(rows[r], bm)
    cb, j = np.divmod(col, bn)
    slot = np.argmax(block_cols[rb] == cb[:, None], axis=1)
    assert np.all(block_cols[rb, slot] == cb)
    out = np.zeros(shape, np.float32)
    out[rb, slot, m, j] = pk.vals.numpy()[e]
    unused = np.ones(pk.vals.shape[0], bool)
    unused[e] = False
    return out, pk.vals.numpy()[unused], len(e)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random padding":  # kmax 4 with rows of fewer tiles
        A = _random_sparse(rng, 90, 130, 3)
        A[40:] = 0
        A[40:, :8] = rng.standard_normal((50, 8))
        return _jax_bell(A, 8, 32)
    if name == "stored zero":  # an explicit 0 in the CSR data
        rows, cols, vals, shape = poisson2d_coo(9)
        vals = np.asarray(vals, np.float32).copy()
        vals[[5, 17]] = 0.0
        return JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                              bm=8, bn=16)
    file, bm, bn = name.split(":")
    return JBell.from_csr_host(*tloader.read_csr_host(ROOT / "problems" / file),
                               bm=int(bm), bn=int(bn), dtype=np.float32)


PACK_CASES = ["poisson2d_34.mtx:8:128", "poisson2d_34.mtx:32:32", "elasticity3d_8.mtx:8:128",
              "powerlaw_1138.mtx:128:128", "random padding", "stored zero"]


@pytest.mark.parametrize("name", PACK_CASES)
def test_pack_round_trip_bitwise(name):
    jb = _case(name)
    tb = _port(jb)
    pk = tb.packed()
    blocks = tb.blocks.numpy()
    out, rest, n_read = _unpack(pk, tb.block_cols.numpy(), blocks.shape)
    assert np.array_equal(out.view(np.int32), blocks.view(np.int32))
    assert pk.nnz == n_read == np.count_nonzero(blocks)
    assert not rest.any()  # entries past a row's length are zero
    assert pk.rows == tb.nrb * tb.bm and pk.ncols == tb.padded_shape[1]
    assert pk.vals.dtype == torch.float32 and pk.cols.dtype == torch.int32
    assert pk.nbytes() == 8 * pk.vals.numel() + 4 * pk.rows + 8 * pk.chunk_off.numel()
    if name == "stored zero":
        assert pk.nnz == tb.nnz - 2
    # memory_footprint keeps the JAX package's count: tiles and columns
    assert tb.memory_footprint() == jb.memory_footprint()


SPMV_CASES = ["poisson2d_34.mtx:8:128", "poisson2d_34.mtx:32:32", "random rect"]


@pytest.mark.parametrize("name", SPMV_CASES)
def test_packed_spmv_matches_jax(name):
    rng = np.random.default_rng(7)
    if name == "random rect":
        A = _random_sparse(rng, 13 * 8 - 3, 300, 4)
        jb = _jax_bell(A, 8, 64)
        tb = _port(jb)
    else:
        file, bm, bn = name.split(":")
        jb, tb = _file_ops(file, int(bm), int(bn))
    assert bell_packed_route(tb)
    x = rng.standard_normal(tb.shape[1]).astype(np.float32)
    x2d = _padded(tb, x).reshape(-1, tb.bn)
    want = np.asarray(jell.bell_spmv_pallas(jb.blocks, jb.block_cols, jnp.asarray(x2d),
                                            interpret=True))
    before = dict(_common.LAUNCHES)
    y = tk5.bell_spmv_packed(tb.packed(), torch.from_numpy(x2d.reshape(-1))).numpy()
    ym = tb.matvec(torch.from_numpy(x)).numpy()
    assert {k: v - before[k] for k, v in _common.LAUNCHES.items() if v != before[k]} == {
        "bell_pack": 1}  # CPU tensors: plain versions, and the view built once
    assert y.shape == want.shape == (tb.padded_shape[0],) and ym.shape == (tb.n,)
    scale = np.abs(want).max()
    np.testing.assert_allclose(y, want, rtol=0, atol=RTOL * scale)
    assert np.array_equal(ym, y[: tb.n])


@pytest.mark.parametrize("beta", [0.0, 0.37])
@pytest.mark.parametrize("with_d", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("bn", [32, 128])
def test_packed_fused_dir_matches_jax(bn, with_d, beta):
    rng = np.random.default_rng(bn + int(with_d))
    A = _random_sparse(rng, {32: 8, 128: 3}[bn] * bn - 5, {32: 8, 128: 3}[bn] * bn - 5, 3,
                       spd=True)
    jb = _jax_bell(A, bn, bn)
    tb = _port(jb)
    assert bell_packed_route(tb)
    n = tb.padded_shape[0]
    r = rng.standard_normal(n).astype(np.float32).reshape(-1, bn)
    p = rng.standard_normal(n).astype(np.float32).reshape(-1, bn)
    d = None
    if with_d:
        d = np.ones(n, np.float32)
        d[: A.shape[0]] = 1.0 / np.diag(A)
        d = d.reshape(-1, bn)
    b1 = np.full((1, 1), beta, np.float32)
    jp, jq, jpap = jfc.fused_dir_spmv_dot(
        jb.blocks, jb.block_cols, jnp.asarray(r), jnp.asarray(p), jnp.asarray(b1),
        inv_diag2d=None if d is None else jnp.asarray(d), interpret=True)
    before = dict(tfc.LAUNCHES)
    tp, tq, tpap = tfc.fused_dir_spmv_dot_packed(
        tb.packed(), torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(b1),
        None if d is None else torch.from_numpy(d))
    assert {k: v for k, v in tfc.LAUNCHES.items() if k != "bell_pack"} == {
        k: v for k, v in before.items() if k != "bell_pack"}
    if beta == 0.0:
        assert np.array_equal(tp.numpy(), np.asarray(jp))
    else:  # XLA:CPU's FMA against the port's two roundings (test_torch_bell.py)
        z = r if d is None else d * r
        bound = 2 * np.finfo(np.float32).eps * (np.abs(z) + np.abs(beta * p))
        assert np.all(np.abs(tp.numpy().astype(np.float64) - np.asarray(jp)) <= bound)
    assert tq.shape == (tb.nrb, bn)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=RTOL * np.abs(np.asarray(jq)).max())
    np.testing.assert_allclose(float(tpap), float(jpap[0, 0]), rtol=RTOL)


def test_packed_wrappers_refuse_bad_operands():
    tb = _port(_case("poisson2d_34.mtx:32:32"))
    pk = tb.packed()
    v = torch.zeros(tb.nrb, 32)
    beta = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="x must be"):
        tk5.bell_spmv_packed(pk, torch.zeros(pk.ncols + 1))
    with pytest.raises(TypeError, match="float32"):
        tk5.bell_spmv_packed(tb.astype(torch.float64).packed(), torch.zeros(pk.ncols))
    with pytest.raises(ValueError, match="vectors"):
        tfc.fused_dir_spmv_dot_packed(pk, v[:-1], v[:-1], beta)
    with pytest.raises(ValueError, match="alias"):
        tfc.fused_dir_spmv_dot_packed(pk, v, v, beta, out=(v, v.clone()))
    rect = _port(_jax_bell(_random_sparse(np.random.default_rng(1), 40, 70, 3), 8, 32))
    with pytest.raises(ValueError, match="square"):
        tfc.fused_dir_spmv_dot_packed(rect.packed(), torch.zeros(5, 8), torch.zeros(5, 8), beta)


ROUTE_CASES = {
    # (operator, packed?): poisson-like tiles, the dense block-tridiagonal
    # operator, a float32 operator of a width the dense kernels do not
    # take (dense tiles even), and float64 (the einsum everywhere)
    "poisson 128x128": ("poisson2d_34.mtx:128:128", True),
    "dense tridiagonal": ("tridiag", False),
    "bn=8 float32": ("bn8", True),
    "float64": ("f64", False),
}


@pytest.mark.parametrize("case", ROUTE_CASES, ids=list(ROUTE_CASES))
def test_route_by_tile_fill(case):
    what, packed = ROUTE_CASES[case]
    if what == "tridiag":
        blocks, cols, nnz = block_tridiag_tiles(8 * 32, 32, 32, seed=0)
        tb = BlockedEllMatrix(torch.from_numpy(blocks), torch.from_numpy(cols), (256, 256), nnz)
    elif what == "bn8":
        tb = _port(_jax_bell(_random_sparse(np.random.default_rng(2), 64, 64, 40), 8, 8))
    elif what == "f64":
        tb = _port(_case("poisson2d_34.mtx:128:128")).astype(torch.float64)
    else:
        tb = _port(_case(what))
    assert bell_packed_route(tb) == packed
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(tb.shape[1])).to(tb.dtype)
    before = _common.LAUNCHES["bell_pack"]
    y = tb.matvec(x)
    tb.matvec(x)
    assert _common.LAUNCHES["bell_pack"] == before + int(packed)
    want = tb.to_dense().double() @ x.double()
    np.testing.assert_allclose(y.double().numpy(), want.numpy(), rtol=0,
                               atol=(1e-5 if tb.dtype == torch.float32 else 1e-12)
                               * float(want.abs().max()))


def test_one_build_per_operator_and_rebuild_on_change():
    _, tb = _file_ops("poisson2d_34.mtx", 32, 32)
    b = torch.arange(1, tb.n + 1, dtype=torch.float32) / tb.n
    before = _common.LAUNCHES["bell_pack"]
    fused_bell_cg_solve(tb, b, torch.ones(tb.n), tol=0.0, maxiter=20, recompute_r_every=5)
    assert _common.LAUNCHES["bell_pack"] == before + 1  # x0, 20 steps, 4 restarts
    y1 = tb.matvec(b)
    tb.blocks.mul_(2.0)  # in place: the tiles' version moves
    y2 = tb.matvec(b)
    assert _common.LAUNCHES["bell_pack"] == before + 2
    assert torch.equal(y2, 2 * y1)
    tb.matvec(b)
    assert _common.LAUNCHES["bell_pack"] == before + 2


@pytest.fixture(scope="module")
def poisson34():
    jb, tb = _file_ops("poisson2d_34.mtx", 32, 32)
    n = tb.n
    b = np.random.default_rng(12).standard_normal(n).astype(np.float32)
    inv_d = (1.0 / np.asarray(jb.diagonal())).astype(np.float32)
    return jb, tb, b, inv_d


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_packed_fused_solve_matches_jax(poisson34, precond):
    jb, tb, b, inv_d = poisson34
    assert bell_packed_route(tb)

    def sj(tol, mi):
        if precond == "none":
            return jfused.fused_bell_cg_solve(jb, jnp.asarray(b), tol=tol, maxiter=mi,
                                              interpret=True)
        return jfused.fused_bell_pcg_solve(jb, jnp.asarray(b), jnp.asarray(inv_d), tol=tol,
                                           maxiter=mi, interpret=True)

    def st(tol, mi):
        if precond == "none":
            return fused_bell_cg_solve(tb, torch.from_numpy(b), tol=tol, maxiter=mi)
        return fused_bell_pcg_solve(tb, torch.from_numpy(b), torch.from_numpy(inv_d), tol=tol,
                                    maxiter=mi)

    _, ij = sj(0.0, 20)
    _, it = st(0.0, 20)
    np.testing.assert_allclose(it.rho_history[1:21].double().numpy(),
                               np.asarray(ij.rho_history[1:21], np.float64), rtol=1e-3)
    tol = 1e-5 * float(np.linalg.norm(b))
    xj, ij = sj(tol, 2000)
    xt, it = st(tol, 2000)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 4
    A = tb.to_dense().double()
    true = float(torch.linalg.norm(torch.from_numpy(b).double() - A @ xt.double()))
    assert true <= tol


@pytest.mark.parametrize("path", ["fused", "portable"])
def test_nan_in_b_exits_as_jax(poisson34, path):
    """A NaN in b: the port's packed route ends at the JAX package's
    iteration with its NaN exit (not converged, ‖r‖² NaN).  The dense
    tiles turn 0·NaN into NaN across a whole tile row and the packed view
    does not; the solver's exit does not depend on that."""
    import conjugategradient_tpu as jcg

    jb, tb, b, _ = poisson34
    b = b.copy()
    b[37] = np.nan
    if path == "fused":
        _, ij = jfused.fused_bell_cg_solve(jb, jnp.asarray(b), tol=1e-6, maxiter=50,
                                           interpret=True)
        _, it = fused_bell_cg_solve(tb, torch.from_numpy(b), tol=1e-6, maxiter=50)
    else:
        _, ij = jcg.cg_solve(jb, jnp.asarray(b), tol=1e-6, maxiter=50, fused="never")
        _, it = cg_solve(tb, torch.from_numpy(b), tol=1e-6, maxiter=50, fused="never")
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) == bool(ij.converged) is False
    assert np.isnan(float(it.rnorm_sq)) and np.isnan(float(ij.rnorm_sq))
