"""The bfloat16 forms of kernels 18 and 19 (the fused BiCGStab iteration's
two tile passes, dense and packed), 6 (the row-sharded SpMV + dot) and 11
(the 7-point stencil) against the JAX package, on the CPU: each plain
version on bf16 operands against the Pallas kernel in interpret mode on the
same bf16 operands, the paths that reach them (the fused BiCGStab solve,
the fused sharded CG, the tester's bf16 stencil run) against the JAX ones,
and the fused BiCGStab gate against the JAX gate.

Kernels 18, 19 and 6 widen each bf16 tile value to float32 as they load it
(exact), so their bounds are the float32 tests' (tests/test_torch_fused_bicgstab.py,
tests/test_torch_sharded_fused.py), with their reasons (XLA:CPU contracts
multiply-add pairs into FMAs where the port rounds each product and sum,
and sums run in another order):

* p', p̂, s, ŝ, x_h: 1e-6 of the largest operand; v', t and q: 2e-5 of
  their largest entry; the dots: 1e-4 relative;
* and bit-equal to the float32 plain versions on the widened operator.

Kernel 11 computes in the volume's dtype: each product and sum rounded to
bf16, in both packages.  With center 6 and off -1 (exact in bf16) it is
bit-equal to the Pallas kernel; with coefficients that are not exact in
bf16 (rounded to it by the operator, as the JAX operator rounds them) it
is held within one bf16 ulp (2⁻⁷) of max|y|, room for XLA keeping an
intermediate in float32.

Whole solves: the fused BiCGStab ``rnorm_history`` to 5e-3 over the first
10 steps above the float32 floor (1e-6 of its first entry), then at a tolerance iterations within max(4, 10%) and x to rtol
5e-3 / atol 1e-4 (tests/test_torch_fused_bicgstab.py's); the fused sharded
CG's history to 1e-3 above the float32 floor, iterations within 2 and x to
1e-3 of max|x| (tests/test_torch_sharded_fused.py's); the tester's bf16
stencil run: dim and nnz equal, both converged, iterations within 15%
(bf16 vector arithmetic rounds at other places in XLA) and rel_error under
5e-3 (measured 2.25e-3 against the JAX tester's 2.30e-3).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.ops.pallas import fused_bicgstab as jk
from conjugategradient_tpu.ops.pallas import fused_cg as jk_cg
from conjugategradient_tpu.ops.pallas.stencil import stencil7_pallas
from conjugategradient_tpu.parallel import sharded_cg_solve as jsharded
from conjugategradient_tpu.solver import fused_bicgstab as jfb
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (
    StencilOperator,
    convert,
    fused_bicgstab_solve,
    fused_bicgstab_supported,
    jacobi_preconditioner,
    tester,
)
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as tk
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tk_cg
from conjugategradient_tpu_torch.ops.cuda.stencil import stencil7
from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
from conjugategradient_tpu_torch.parallel import make_row_mesh, partition_csr_rows, sharded_cg_solve
from conjugategradient_tpu_torch.problems import (
    convection_diffusion_2d_coo,
    poisson2d_coo,
    reference_rhs,
)
from conjugategradient_tpu_torch.types import BlockedEllMatrix

BF16 = torch.bfloat16


def _same_bf16(tt, jt):
    """The port's bf16 tensor holds the JAX one's bits."""
    assert tt.dtype == BF16 and jt.dtype == jnp.bfloat16
    assert np.array_equal(tt.float().numpy(), np.asarray(jt.astype(jnp.float32)))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _close_elem(got, want, operands):
    scale = max(float(np.abs(v).max()) for v in operands)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * scale)


def _close_dot(got, want):
    np.testing.assert_allclose(float(got), float(np.asarray(want).reshape(-1)[0]), rtol=1e-4)


def _bf16_pair(jb):
    """The JAX operator and the port's, each package's astype(bfloat16)."""
    tb = convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols), jb.shape,
                                  jb.nnz, device="cpu")
    jb, tb = jb.astype(jnp.bfloat16), tb.astype(BF16)
    _same_bf16(tb.blocks, jb.blocks)
    return jb, tb


def _nonsym_tridiag(n, bn=128, seed=0):
    """bench.py:1367-1403's bicgstab-bell operator at a small n (dense
    nonsymmetric off-diagonal tiles: the dense-tile route) with 2 I on its
    diagonal in place of (2 + the tiles' whole sums) I, so that a solve
    takes 11 steps to 1e-5 and not 3."""
    nrb = n // bn
    rng = np.random.default_rng(seed)
    up = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    lo = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    diag = 2.0 * np.eye(bn, dtype=np.float32)
    blocks = np.zeros((nrb, 3, bn, bn), np.float32)
    cols = np.zeros((nrb, 3), np.int32)
    for i in range(nrb):
        blocks[i, 0], cols[i, 0] = diag, i
        k = 1
        for c, t in ((i - 1, lo), (i + 1, up)):
            if 0 <= c < nrb:
                blocks[i, k], cols[i, k] = t, c
                k += 1
    return JBell(jnp.asarray(blocks), jnp.asarray(cols), (n, n), nrb * 3 * bn * bn)


def _convdiff(nx):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=10.0)
    return JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                          bm=128, bn=128)


@pytest.fixture(scope="module")
def cd32():
    """Convection-diffusion nx = 32 at 128 x 128 in bf16 (8 block-rows;
    sparse tiles: the packed route on the card)."""
    return _bf16_pair(_convdiff(32))


def _vecs(rows, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, 128)).astype(np.float32) for _ in range(k)]


def _s11(v):
    return np.full((1, 1), v, np.float32)


def _kernel_launches():
    """The kernel counters (``bell_pack`` counts builds of a packed view)."""
    return {k: v for k, v in _common.LAUNCHES.items() if k != "bell_pack"}


# ---- kernels 18 and 19 ---------------------------------------------------------------

STEPS = {"first": (0.0, 1.0), "later": (0.4, 0.25)}  # beta, omega (K18); alpha from omega


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("form", ["dense", "packed"])
def test_dir_bf16_matches_pallas(cd32, form, with_d, step):
    """Kernel 18's bf16 form (plain version, dense tiles or the packed
    view's bf16 values) against ``bicgstab_dir_spmv_dot`` on the same bf16
    tiles, on a first step (beta 0) and a later one; bit-equal to the
    float32 plain version on the widened operator; no launch (CPU)."""
    jb, tb = cd32
    assert bell_packed_route(tb)
    r, p, v, rhat, d = _vecs(tb.nrb, 5, 18)
    d = 0.5 + np.abs(d) if with_d else None
    beta, omega = (_s11(s) for s in STEPS[step])
    want = jk.bicgstab_dir_spmv_dot(
        jb.blocks, jb.block_cols, *map(jnp.asarray, (r, p, v, rhat, beta, omega)),
        inv_diag2d=None if d is None else jnp.asarray(d), interpret=True)
    args = (*map(torch.from_numpy, (r, p, v, rhat, beta, omega)),
            None if d is None else torch.from_numpy(d))

    def run(a):
        if form == "packed":
            pk = a.packed()
            assert pk.vals.dtype == a.dtype
            return tk.bicgstab_dir_spmv_dot_packed(pk, *args)
        return tk.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, *args)

    before = _kernel_launches()
    got = run(tb)
    assert _kernel_launches() == before
    _close_elem(got[0], want[0], (r, p, v))
    _close_elem(got[1], want[1], (r, p, v))
    _close(got[2], want[2], 2e-5)
    _close_dot(got[3], want[3])
    ref = run(tb.astype(torch.float32))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("form", ["dense", "packed"])
def test_s_bf16_matches_pallas(cd32, form, with_d):
    """Kernel 19's bf16 form (plain version) against ``bicgstab_s_spmv_dot``
    on the same bf16 tiles; bit-equal to the float32 plain version on the
    widened operator."""
    jb, tb = cd32
    r, vn, x, ph, d = _vecs(tb.nrb, 5, 19)
    d = 0.5 + np.abs(d) if with_d else None
    alpha = _s11(0.6)
    want = jk.bicgstab_s_spmv_dot(
        jb.blocks, jb.block_cols, *map(jnp.asarray, (r, vn, x, ph, alpha)),
        inv_diag2d=None if d is None else jnp.asarray(d), interpret=True)
    args = (*map(torch.from_numpy, (r, vn, x, ph, alpha)),
            None if d is None else torch.from_numpy(d))

    def run(a):
        if form == "packed":
            return tk.bicgstab_s_spmv_dot_packed(a.packed(), *args)
        return tk.bicgstab_s_spmv_dot(a.blocks, a.block_cols, *args)

    before = _kernel_launches()
    got = run(tb)
    assert _kernel_launches() == before
    for i in range(3):  # s, ŝ, x_h
        _close_elem(got[i], want[i], (r, vn, x, ph))
    _close(got[3], want[3], 2e-5)
    for i in range(4, 7):  # s·s, t·s, t·t
        _close_dot(got[i], want[i])
    ref = run(tb.astype(torch.float32))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---- kernel 6 -------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 2])
def test_bell_spmv_dot_bf16_matches_pallas(shard):
    """Kernel 6's bf16 form (plain version) on one shard of bf16 tiles with
    GLOBAL column blocks (ragged nrb = 13), at row offset 0 and at the third
    shard's, against the Pallas kernel on the same bf16 tiles; bit-equal to
    the float32 plain version on the widened tiles."""
    rng = np.random.default_rng(6 + shard)
    nrb, bn, n_shards = 13, 128, 3
    blocks = rng.standard_normal((nrb, 3, bn, bn)).astype(np.float32)
    cols = rng.integers(0, n_shards * nrb, (nrb, 3)).astype(np.int32)
    full = rng.standard_normal((n_shards * nrb, bn)).astype(np.float32)
    off = shard * nrb * bn
    bj = jnp.asarray(blocks).astype(jnp.bfloat16)
    bt = torch.from_numpy(blocks).to(BF16)
    _same_bf16(bt, bj)
    qj, pj = jk_cg.bell_spmv_dot(bj, jnp.asarray(cols), jnp.asarray(full),
                                 jnp.asarray([off], jnp.int32), interpret=True)
    before = dict(_common.LAUNCHES)
    qt, pt = tk_cg.bell_spmv_dot(bt, torch.from_numpy(cols), torch.from_numpy(full), off)
    assert _common.LAUNCHES == before
    _close(qt, qj, 2e-5)
    np.testing.assert_allclose(float(pt), float(pj[0, 0]), rtol=1e-4)
    q32, p32 = tk_cg.bell_spmv_dot(bt.float(), torch.from_numpy(cols), torch.from_numpy(full),
                                   off)
    assert torch.equal(qt, q32) and torch.equal(pt, p32)


# ---- kernel 11 ------------------------------------------------------------------------

@pytest.mark.parametrize("center,off", [(6.0, -1.0), (4.3, -0.55), (0.1, -1 / 3)],
                         ids=["poisson", "inexact", "tiny"])
def test_stencil7_bf16_matches_pallas(center, off):
    """Kernel 11's bf16 form (plain version) on a bf16 (8, 16, 128) volume
    against ``stencil7_pallas`` on the same volume and the operator's bf16
    coefficients (``StencilOperator`` rounds them to bf16 as the JAX
    operator does): bit-equal for center 6 and off -1, within one bf16 ulp
    of max|y| otherwise; the result bf16, no launch (CPU)."""
    shape = (8, 16, 128)
    op = StencilOperator(center, off, shape, BF16, "cpu")
    assert (op.center, op.off) == tuple(
        float(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)) for v in (center, off))
    u = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    uj = jnp.asarray(u).astype(jnp.bfloat16)
    ut = torch.from_numpy(u).to(BF16)
    _same_bf16(ut, uj)
    yj = stencil7_pallas(uj, op.center, op.off, interpret=True)
    before = dict(_common.LAUNCHES)
    yt = stencil7(ut, op.center, op.off)
    assert _common.LAUNCHES == before and yt.dtype == BF16
    assert torch.equal(op.matvec(ut.reshape(-1)), yt.reshape(-1))
    want = np.asarray(yj.astype(jnp.float32))
    got = yt.float().numpy()
    if center == 6.0:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())


# ---- the paths ------------------------------------------------------------------------

@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("route", ["packed", "dense"])
def test_fused_bicgstab_bf16_solve_matches_jax(route, precond):
    """fused_bicgstab_solve on bf16 tiles (float32 b) against the JAX fused
    solve on the same tiles (``bicgstab_solve(fused="always")``'s path; the
    Pallas kernels in interpret mode): convection-diffusion nx = 24 (the
    packed route) and a block-tridiagonal operator with dense tiles at
    n = 512 (the dense route) for 12 capped steps, then each to a
    tolerance."""
    jb, tb = _bf16_pair(_convdiff(24) if route == "packed" else _nonsym_tridiag(512))
    assert bell_packed_route(tb) == (route == "packed")
    n = tb.n
    b = (reference_rhs(n, dtype=np.float32) / n).astype(np.float32)
    jd = td = None
    if precond == "jacobi":
        jd, td = jcg.jacobi_preconditioner(jb).inv_diag, jacobi_preconditioner(tb).inv_diag
    cap = 12
    _, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=0.0, maxiter=cap, inv_diag=jd,
                                     interpret=True)
    _, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=cap, inv_diag=td)
    k = min(cap, 10) + 1
    h, hj = it.rnorm_history.numpy()[:k], np.asarray(ij.rnorm_history)[:k]
    sel = hj > 1e-6 * hj[0]  # above the float32 floor
    assert sel.sum() >= 6
    np.testing.assert_allclose(h[sel], hj[sel], rtol=5e-3)
    tol = 1e-5 * float(np.linalg.norm(b))
    xj, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=tol, maxiter=4 * n, inv_diag=jd,
                                      interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=tol, maxiter=4 * n, inv_diag=td)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert bool(it.converged) and bool(ij.converged) and abs(kt - kj) <= max(4, kj // 10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=5e-3, atol=1e-4)


def _csr32(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


@pytest.mark.parametrize("jacobi", [False, True], ids=["cg", "jacobi"])
def test_sharded_cg_bf16_matches_jax(monkeypatch, jacobi):
    """sharded_cg_solve(method="standard") on bf16 shards with float32 b
    (the fused shard loop, use_fused="always": on CPU tensors the plain
    versions) against the JAX one on the 8 virtual CPU devices: poisson2d(32)
    on 8 shards of 128 x 128 tiles (its values are exact in bf16); the
    shards keep their bf16 dtype."""
    a = _csr32(poisson2d_coo(32))
    n = a.shape[0]
    blocks, bcols, n_pad = partition_csr_rows(a.data, a.indices, a.indptr, a.shape, 8,
                                              bm=128, bn=128)
    b = np.zeros(n_pad, np.float32)
    b[:n] = reference_rhs(n, dtype=np.float32) / n
    inv_diag = np.ones(n_pad, np.float32)
    inv_diag[:n] = 1.0 / a.diagonal()
    bt = torch.from_numpy(blocks).to(BF16)
    bj = jnp.asarray(blocks).astype(jnp.bfloat16)
    _same_bf16(bt, bj)
    seen = []
    orig = tk_cg.bell_spmv_dot

    def spy(blk, *args, **kw):
        seen.append(blk.dtype)
        return orig(blk, *args, **kw)

    monkeypatch.setattr("conjugategradient_tpu_torch.parallel.loops.bell_spmv_dot", spy)
    d = inv_diag if jacobi else None
    x, info = sharded_cg_solve(bt, bcols, b, mesh=make_row_mesh(8, "cpu"), tol=1e-4,
                               inv_diag=d, use_fused="always")
    monkeypatch.undo()
    assert seen and set(seen) == {BF16}
    xj, ij = jsharded(bj, jnp.asarray(bcols), jnp.asarray(b), tol=1e-4, maxiter=n_pad + 1,
                      inv_diag=None if d is None else jnp.asarray(d), use_fused="always",
                      interpret=True)
    assert bool(info.converged) and abs(int(info.iterations) - int(ij.iterations)) <= 2
    k = min(int(info.iterations), int(ij.iterations))
    h, hj = np.asarray(info.rho_history)[:k + 1], np.asarray(ij.rho_history)[:k + 1]
    sel = hj > hj[0] * 1e-10
    np.testing.assert_allclose(h[sel], hj[sel], rtol=1e-3)
    _close(x, xj, 1e-3)


def test_tester_bf16_stencil_matches_the_jax_tester(capsys):
    """The tester's ``stencil:16 --dtype bfloat16 --tol 1e-1`` (the portable
    loop on bf16 vectors: kernel 11's bf16 form on the card) against the
    JAX tester."""
    import tester as jtester

    args = ["stencil:16", "--dtype", "bfloat16", "--tol", "1e-1", "--summary"]
    assert jtester.main(args) == 0
    jlines = capsys.readouterr().out.strip().splitlines()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlines = capsys.readouterr().out.strip().splitlines()
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["4096", "27136"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    ti, ji = ts["iterations"][0], js["iterations"][0]
    assert abs(ti - ji) <= 0.15 * ji
    assert 0 <= float(tlines[0].split()[3]) < 5e-3 and 0 <= float(jlines[0].split()[3]) < 5e-3


# ---- the gate -------------------------------------------------------------------------

@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_fused_bicgstab_gate_matches_jax(monkeypatch, cd32, op_dtype):
    """fused_bicgstab_supported against the JAX gate (interpret=True) on
    float32 and bf16 full blocked-ELL tiles and each vector dtype, with the
    device term aside: the port's operator is made to report a CUDA device,
    as the gate's other terms are pure shape and dtype.  Symmetric storage,
    a rectangular padded system and a CSR operator are refused by both."""
    jb, tb = cd32
    if op_dtype == "float32":
        jb, tb = jb.astype(jnp.float32), tb.astype(torch.float32)
    assert not fused_bicgstab_supported(tb, dtype=torch.float32)  # CPU tensors
    monkeypatch.setattr(BlockedEllMatrix, "device", property(lambda self: torch.device("cuda")))
    for jd, td in ((None, None), (jnp.float32, torch.float32), (jnp.float64, torch.float64),
                   (jnp.bfloat16, BF16)):
        want = jfb.fused_bicgstab_supported(jb, dtype=jd, interpret=True)
        assert fused_bicgstab_supported(tb, dtype=td) == want, (jd, td)
        assert want == (jd in (None, jnp.float32))
    rows, cols, vals, shape = poisson2d_coo(12)
    jc = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
    jrect = JBell.from_csr(jc, bm=8, bn=128)
    rect = BlockedEllMatrix.from_csr_host(np.asarray(jc.data), np.asarray(jc.indices),
                                          np.asarray(jc.indptr), shape, bm=8, bn=128,
                                          device="cpu")
    assert rect.padded_shape[0] != rect.padded_shape[1]
    assert not fused_bicgstab_supported(rect)
    assert not jfb.fused_bicgstab_supported(jrect, interpret=True)
    assert not jfb.fused_bicgstab_supported(jc, interpret=True)
    assert not fused_bicgstab_supported(convert.csr_from_arrays(
        np.asarray(jc.data), np.asarray(jc.indices), np.asarray(jc.indptr), shape,
        device="cpu"))
    jsym = jcg.SymBellMatrix.from_bell(JBell.from_csr(jc, bm=128, bn=128))
    assert not jfb.fused_bicgstab_supported(jsym, interpret=True)
