"""The port's matrix-free 7-point stencil path against the JAX package, on
the CPU, from the same numpy inputs.

* ``stencil7`` (kernel 11) plain version: against ``stencil7_pallas`` in
  interpret mode, float32, within 1e-5 of max|y| (XLA:CPU may fuse a
  multiply-add pair into one FMA where the port rounds twice); against the
  JAX ``stencil7_matvec`` in float64 within 1e-12 relative; against the
  port's ``poisson7_csr`` SpMV within 1e-12 relative.
* ``fused_stencil_dir_dot`` (kernel 12) plain version against the JAX
  kernel in interpret mode: p_new to 1e-6 of max|p|, q to 1e-5 of max|q|,
  pap to 1e-5 relative.
* ``fused_update_dot_3d`` (kernel 13, kernel 2 on a flat view) against the
  JAX kernel in interpret mode, and kernel 2's plain version at lengths that
  are not multiples of 4.
* Fused float32 stencil CG against the JAX fused solve (interpret mode):
  ``rho_history`` within 5e-2 relative over the first 25 steps, with and
  without residual replacement, and a mid-solve state carried across.
* Portable float64 stencil CG against the JAX ``cg_solve``: equal iteration
  counts at tol 1e-10 and ``rho_history`` within 1e-10 relative above the
  roundoff floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.ops import stencil as jstencil
from conjugategradient_tpu.ops.pallas import fused_stencil as jfs
from conjugategradient_tpu.ops.pallas.stencil import stencil7_pallas
from conjugategradient_tpu.solver import fused_stencil as jsolver
from conjugategradient_tpu.types import StencilOperator as JStencil
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.ops import stencil as tstencil
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tfc
from conjugategradient_tpu_torch.ops.cuda import fused_stencil as tfs
from conjugategradient_tpu_torch.ops.cuda.stencil import stencil7
from conjugategradient_tpu_torch.solver import cg_solve, fused_stencil_supported
from conjugategradient_tpu_torch.solver import fused_stencil as tsolver
from conjugategradient_tpu_torch.types import StencilOperator

SPMV_RTOL = 1e-5
F64_RTOL = 1e-12
TRAJ_RTOL = 5e-2  # chip_smoke.py's fused-vs-plain trajectory bound


def _rng(seed):
    return np.random.default_rng(seed)


def _op(grid, dtype=torch.float32, center=6.0, off=-1.0):
    return StencilOperator(center, off, grid, dtype, "cpu")


# ---- the operator ----------------------------------------------------------

@pytest.mark.parametrize("grid", [(5, 6, 7), (2, 2, 2), (16, 8, 128), (33, 17, 1)])
def test_operator_fields_match_jax(grid):
    j = JStencil.poisson(grid, dtype=jnp.float64)
    t = StencilOperator.poisson(grid, dtype=torch.float64, device="cpu")
    assert t.shape == tuple(j.shape) and t.nnz == j.nnz
    np.testing.assert_array_equal(t.diagonal().numpy(), np.asarray(j.diagonal()))
    assert t.diagonal().dtype == torch.float64 and t.device.type == "cpu"


def test_center_and_off_rounded_to_dtype_as_jax():
    j = JStencil(jnp.asarray(0.1, jnp.float32), jnp.asarray(-1 / 3, jnp.float32), (3, 4, 5))
    t = convert.stencil_from_arrays(np.asarray(j.center), np.asarray(j.off), j.grid_shape,
                                    device="cpu")
    assert t.dtype == torch.float32 and t.grid_shape == (3, 4, 5)
    assert t.center == float(j.center) and t.off == float(j.off)
    assert _op((3, 4, 5), torch.float32, 0.1, -1 / 3) == t
    t64 = t.astype(torch.float64)
    assert (t64.center, t64.off) == (t.center, t.off) and t64.dtype == torch.float64
    assert t64.astype(torch.float32) == t
    assert StencilOperator(0.1, -1 / 3, (3, 4, 5), torch.float64, "cpu").center == 0.1


def test_operator_rejects_bad_fields():
    with pytest.raises(TypeError, match="float32 or float64"):
        StencilOperator(6.0, -1.0, (2, 2, 2), torch.float16, "cpu")
    for bad in ((2, 2), (2, 0, 2)):
        with pytest.raises(ValueError, match="grid_shape"):
            StencilOperator(6.0, -1.0, bad, torch.float32, "cpu")


# ---- kernel 11: stencil7 ---------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 8, 128), (4, 16, 256), (3, 8, 128)])
def test_stencil7_plain_matches_pallas_interpret(shape):
    u = _rng(sum(shape)).standard_normal(shape).astype(np.float32)
    yj = np.asarray(stencil7_pallas(jnp.asarray(u), 6.0, -1.0, interpret=True))
    yt = stencil7(torch.from_numpy(u), 6.0, -1.0)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == shape
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=SPMV_RTOL * np.abs(yj).max())


@pytest.mark.parametrize("center,off", [(6.0, -1.0), (4.25, -0.5)])
@pytest.mark.parametrize("grid", [(5, 6, 7), (2, 3, 1)])
def test_stencil7_f64_matches_jax_matvec(grid, center, off):
    j = JStencil(jnp.asarray(center, jnp.float64), jnp.asarray(off, jnp.float64), grid)
    t = _op(grid, torch.float64, center, off)
    x = _rng(3).standard_normal(t.shape[0])
    yj = np.asarray(jstencil.stencil7_matvec(j, jnp.asarray(x)))
    yt = t.matvec(torch.from_numpy(x))
    assert yt.dtype == torch.float64
    np.testing.assert_allclose(yt.numpy(), yj, rtol=F64_RTOL, atol=F64_RTOL * np.abs(yj).max())


@pytest.mark.parametrize("grid", [(5, 6, 7), (4, 4, 9)])
def test_stencil_matches_poisson7_csr(grid):
    t = StencilOperator.poisson(grid, dtype=torch.float64, device="cpu")
    csr = tstencil.poisson7_csr(grid, device="cpu")
    jcsr = jstencil.poisson7_csr(grid)
    assert csr.nnz == t.nnz == int(jcsr.nnz)
    np.testing.assert_array_equal(csr.indptr.numpy(), np.asarray(jcsr.indptr))
    x = torch.from_numpy(_rng(4).standard_normal(t.shape[0]))
    np.testing.assert_allclose(t.matvec(x).numpy(), csr.matvec(x).numpy(), rtol=F64_RTOL)
    np.testing.assert_array_equal(t.diagonal().numpy(), csr.diagonal().numpy())


def test_stencil7_nan_reaches_only_its_neighbours():
    u = torch.ones(4, 5, 6, dtype=torch.float64)
    u[2, 3, 1] = float("nan")
    y = stencil7(u, 6.0, -1.0)
    hit = torch.isnan(y)
    want = torch.zeros_like(hit)
    for di, dj, dk in ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
                       (0, 0, 1)):
        want[2 + di, 3 + dj, 1 + dk] = True
    assert torch.equal(hit, want)


def test_stencil7_contract():
    with pytest.raises(ValueError, match="volume"):
        stencil7(torch.zeros(8), 6.0, -1.0)
    assert _common.PLAIN_ON_CUDA["stencil7"] == 0
    # float32 operator on a float64 vector: the common dtype, as in JAX
    x = torch.from_numpy(_rng(5).standard_normal(24))
    assert _op((2, 3, 4)).matvec(x).dtype == torch.float64


# ---- kernel 12: fused_stencil_dir_dot ---------------------------------------

@pytest.mark.parametrize("shape", [(4, 8, 128), (6, 16, 128)])
def test_fused_stencil_dir_plain_matches_pallas_interpret(shape):
    rng = _rng(shape[0])
    r = rng.standard_normal(shape).astype(np.float32)
    p = rng.standard_normal(shape).astype(np.float32)
    beta = np.full((1, 1), 0.3, np.float32)
    pj, qj, papj = jfs.fused_stencil_dir_dot(jnp.asarray(r), jnp.asarray(p), jnp.asarray(beta),
                                             jnp.asarray(6.0, jnp.float32),
                                             jnp.asarray(-1.0, jnp.float32), interpret=True)
    pt, qt, papt = tfs.fused_stencil_dir_dot(torch.from_numpy(r), torch.from_numpy(p),
                                             torch.from_numpy(beta), 6.0, -1.0)
    pj, qj = np.asarray(pj), np.asarray(qj)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-6 * np.abs(pj).max())
    np.testing.assert_allclose(qt.numpy(), qj, rtol=0, atol=SPMV_RTOL * np.abs(qj).max())
    np.testing.assert_allclose(float(papt), float(papj[0, 0]), rtol=SPMV_RTOL)


def test_fused_stencil_dir_scalar_step_and_noop():
    """With a FusedWork: α = ρ / pap (0 when ρ == 0) into the work scalars,
    and nothing at all once ``live`` is 0."""
    shape = (3, 5, 7)
    rng = _rng(8)
    r = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    out = (torch.zeros(shape), torch.zeros(shape))
    for rho in (2.5, 0.0):
        w = tfc.FusedWork.new("cpu", maxiter=4)
        w.scal[tfc.S_RHO] = rho
        _, _, pap = tfs.fused_stencil_dir_dot(r, p, w.beta, 6.0, -1.0, out=out, work=w)
        want = 0.0 if rho == 0 else rho / float(pap)
        np.testing.assert_allclose(float(w.scal[tfc.S_ALPHA]), want, rtol=1e-6)
    w.ctl[tfc.C_LIVE] = 0
    before = [o.clone() for o in out] + [w.scal.clone()]
    tfs.fused_stencil_dir_dot(r * 2, p, w.beta, 6.0, -1.0, out=out, work=w)
    for a, b in zip(before, [*out, w.scal]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="alias"):
        tfs.fused_stencil_dir_dot(r, p, w.beta, 6.0, -1.0, out=(p, out[1]))
    with pytest.raises(ValueError, match="float32"):
        tfs.fused_stencil_dir_dot(r.double(), p.double(), w.beta, 6.0, -1.0)


# ---- kernel 13: fused_update_dot_3d (kernel 2 on the flat view) ------------

@pytest.mark.parametrize("shape", [(4, 8, 128), (5, 6, 7)])
def test_update_3d_matches_pallas_interpret(shape):
    rng = _rng(9)
    x, p, r, q = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    alpha = np.full((1, 1), 0.61, np.float32)
    xj, rj, nj = jfs.fused_update_dot_3d(*(jnp.asarray(v) for v in (x, p, r, q, alpha)),
                                         interpret=True)
    xt, rt, nt = tfs.fused_update_dot_3d(*(torch.from_numpy(v) for v in (x, p, r, q, alpha)))
    assert tuple(xt.shape) == shape and tuple(rt.shape) == shape
    for t, j in ((xt, xj), (rt, rj)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max())
    np.testing.assert_allclose(float(nt), float(nj[0, 0]), rtol=SPMV_RTOL)


@pytest.mark.parametrize("n", [1, 3, 210, 4097])
def test_update_plain_at_any_length(n):
    """Kernel 2's function at lengths that are not multiples of 4 (its CUDA
    kernel finishes them with a scalar tail): numpy float32 arithmetic."""
    rng = _rng(n)
    x, p, r, q = (rng.standard_normal(n).astype(np.float32) for _ in range(4))
    a = np.float32(0.37)
    xt, rt, nt = tfc.fused_update_dot(*(torch.from_numpy(v) for v in (x, p, r, q)),
                                      torch.full((1, 1), float(a)))
    np.testing.assert_array_equal(xt.numpy(), x + a * p)
    np.testing.assert_array_equal(rt.numpy(), r - a * q)
    rr = (r - a * q).astype(np.float64)
    np.testing.assert_allclose(float(nt), rr @ rr, rtol=SPMV_RTOL)


def test_update_3d_in_place_with_work():
    shape = (5, 6, 7)
    rng = _rng(10)
    x, p, r, q = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for _ in range(4))
    x0, r0 = x.clone(), r.clone()
    w = tfc.FusedWork.new("cpu", maxiter=3)
    w.scal[tfc.S_ALPHA] = 0.5
    w.scal[tfc.S_RHO] = 1.0
    tfs.fused_update_dot_3d(x, p, r, q, w.alpha, out=(x, r), work=w)
    torch.testing.assert_close(x, x0 + 0.5 * p, rtol=0, atol=0)
    torch.testing.assert_close(r, r0 - 0.5 * q, rtol=0, atol=0)
    assert int(w.ctl[tfc.C_K]) == 1
    with pytest.raises(ValueError, match="contiguous"):
        tfs.fused_update_dot_3d(x, p, r, q.transpose(0, 2).contiguous().transpose(0, 2),
                                w.alpha)


# ---- the fused stencil solve -----------------------------------------------

@pytest.mark.parametrize("every", [0, 8], ids=["plain", "restart8"])
def test_fused_stencil_cg_trajectory_matches_jax(every):
    grid = (4, 8, 128)
    n = int(np.prod(grid))
    b = _rng(1).standard_normal(n).astype(np.float32)
    jop = JStencil.poisson(grid, dtype=jnp.float32)
    _, ji = jsolver.fused_stencil_cg_solve(jop, jnp.asarray(b), tol=0.0, maxiter=25,
                                           interpret=True, recompute_r_every=every)
    top = StencilOperator.poisson(grid, device="cpu")
    x, ti = tsolver.fused_stencil_cg_solve(top, torch.from_numpy(b), tol=0.0, maxiter=25,
                                           recompute_r_every=every)
    assert int(ti.iterations) == int(ji.iterations) == 25
    hj, ht = np.asarray(ji.rho_history)[:26], ti.rho_history.numpy()[:26]
    np.testing.assert_allclose(ht, hj, rtol=TRAJ_RTOL)
    assert x.dtype == torch.float32 and x.shape == (n,)


def test_fused_stencil_solve_converges_like_portable():
    grid = (4, 8, 128)
    top = StencilOperator.poisson(grid, device="cpu")
    b = torch.from_numpy(_rng(2).standard_normal(top.shape[0]).astype(np.float32))
    tol = 1e-4 * float(b.norm())
    xf, fi = tsolver.fused_stencil_cg_solve(top, b, tol=tol)
    xp, pi = cg_solve(top, b, tol=tol, fused="never")
    assert bool(fi.converged) and bool(pi.converged)
    assert abs(int(fi.iterations) - int(pi.iterations)) <= 1
    torch.testing.assert_close(xf, xp, rtol=1e-3, atol=1e-4 * float(xp.abs().max()))
    # a warm start at the solution: r0 = b - A x0 through the stencil
    x0 = xf.clone()
    _, wi = tsolver.fused_stencil_cg_solve(top, b, x0, tol=tol)
    assert int(wi.iterations) <= 1 and bool(wi.converged)


def test_fused_stencil_state_carried_from_jax():
    """A JAX fused stencil state carried across (fused_state_from_arrays
    with volumes), stepped by both packages."""
    grid = (4, 8, 128)
    n = int(np.prod(grid))
    b = _rng(5).standard_normal(n).astype(np.float32)
    jop = JStencil.poisson(grid, dtype=jnp.float32)
    top = StencilOperator.poisson(grid, device="cpu")
    js = jsolver._init(jop, jnp.asarray(b), None, 6)
    jstep = lambda s: jsolver._step(jop, s, jnp.asarray(0.0, jnp.float32), True)
    for _ in range(2):
        js = jstep(js)
    ts = convert.fused_state_from_arrays(
        np.asarray(js.x), np.asarray(js.r), np.asarray(js.p), np.asarray(js.beta),
        np.asarray(js.rho), int(js.k), bool(js.done), np.asarray(js.hist), device="cpu")
    assert tuple(ts.x.shape) == grid
    for _ in range(2):
        js = jstep(js)
        tsolver.fused_stencil_cg_step(top, ts)
    assert int(ts.k) == int(js.k) == 4 and bool(ts.done) == bool(js.done)
    for t, j in ((ts.x, js.x), (ts.r, js.r), (ts.p, js.p)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-5 * np.abs(j).max())
    np.testing.assert_allclose(ts.hist.numpy()[:5], np.asarray(js.hist)[:5], rtol=1e-4)
    np.testing.assert_allclose(float(ts.beta), float(js.beta[0, 0]), rtol=1e-4)


# ---- the portable float64 loop and the dispatch ----------------------------

@pytest.mark.parametrize("grid", [(5, 6, 7), (6, 8, 9)])
def test_portable_f64_stencil_cg_matches_jax(grid):
    jop = JStencil.poisson(grid, dtype=jnp.float64)
    top = StencilOperator.poisson(grid, dtype=torch.float64, device="cpu")
    b = np.arange(1, top.shape[0] + 1, dtype=np.float64)
    xj, ji = jcg.cg_solve(jop, jnp.asarray(b), tol=1e-10)
    xt, ti = cg_solve(top, torch.from_numpy(b), tol=1e-10)
    k = int(ji.iterations)
    assert int(ti.iterations) == k and bool(ti.converged)
    hj, ht = np.asarray(ji.rho_history)[:k + 1], ti.rho_history.numpy()[:k + 1]
    keep = hj > 1e-20 * hj[0]
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9)


def test_jacobi_on_a_stencil_runs_the_portable_loop():
    grid = (5, 6, 7)
    jop = JStencil.poisson(grid, dtype=jnp.float64)
    top = StencilOperator.poisson(grid, dtype=torch.float64, device="cpu")
    b = np.arange(1, top.shape[0] + 1, dtype=np.float64)
    _, ji = jcg.cg_solve(jop, jnp.asarray(b), tol=1e-10, M=jcg.jacobi_preconditioner(jop))
    from conjugategradient_tpu_torch import jacobi_preconditioner

    _, ti = cg_solve(top, torch.from_numpy(b), tol=1e-10, M=jacobi_preconditioner(top))
    assert int(ti.iterations) == int(ji.iterations)


def test_fused_stencil_gate_and_always():
    card = StencilOperator.poisson((5, 6, 7), device="cuda")  # holds no tensor
    assert fused_stencil_supported(card) and fused_stencil_supported(card, torch.float32)
    assert not fused_stencil_supported(card, torch.float64)
    assert not fused_stencil_supported(card.astype(torch.float64))
    assert not fused_stencil_supported(StencilOperator.poisson((5, 6, 7), device="cpu"))
    assert not fused_stencil_supported(torch.eye(3))
    cpu = StencilOperator.poisson((5, 6, 7), device="cpu")
    b = torch.ones(cpu.shape[0])
    with pytest.raises(ValueError, match="StencilOperator"):
        cg_solve(cpu, b, fused="always")
    # "auto" on CPU tensors: the portable loop, same answer as "never"
    xa, ia = cg_solve(cpu, b, tol=1e-4)
    xn, inn = cg_solve(cpu, b, tol=1e-4, fused="never")
    assert torch.equal(xa, xn) and int(ia.iterations) == int(inn.iterations)
