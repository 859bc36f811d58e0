"""Two API repairs against the JAX package (CPU, float64):

* ``CGInfo.residual_norms``, the property sqrt(rho_history), on every
  result that carries a ``CGInfo``: the portable and fused ``cg_solve``,
  ``cg_solve_batched`` ((R, maxiter + 1)), ``block_cg_solve``,
  ``sharded_cg_solve``, ``pipelined_cg_solve`` and ``sstep_cg_solve``.
  Each equals its own sqrt(rho_history) bit for bit, is NaN where the JAX
  one is, and is held to the JAX result's ``residual_norms`` to 1e-10
  relative on the entries above 1e-7 of the first (off the float64
  roundoff floor, where the two packages' sums part); block CG's to 1e-10
  relative plus 1e-12 of the first norm (its eigh cutoffs part the two
  packages' rounding; tests/test_torch_blockcg.py holds its squared
  history to 1e-8).  It stays a property: a ``CGInfo`` has no field of
  that name (checkpoints and ``--summary`` gain no key).
* ``cg_step(A, state, tol, M=None, dot_fn=dot)``: a recording ``dot_fn``
  sees the same calls, in the same order, on equal operands, as the JAX
  step's, and the step's carry equals the JAX one to 1e-12 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.parallel import partition_csr_rows as jpartition
from conjugategradient_tpu.parallel import sharded_cg_solve as jsharded
from conjugategradient_tpu.solver import cg as jcg_mod
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.solver.pipelined import pipelined_cg_solve as jpipelined
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.parallel import make_row_mesh, sharded_cg_solve
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import (CGInfo, block_cg_solve, cg_init, cg_solve,
                                                cg_solve_batched, cg_step,
                                                fused_bell_cg_solve, jacobi_preconditioner,
                                                pipelined_cg_solve, sstep_cg_solve)
from conjugategradient_tpu_torch.types import CSRMatrix

RTOL = 1e-10
FLOOR = 1e-7


def _pair(nx=12, dtype=np.float64):
    rows, cols, vals, shape = poisson2d_coo(nx)
    return (JCSR.from_coo(rows, cols, vals, shape, dtype=dtype),
            CSRMatrix.from_coo(rows, cols, vals, shape, dtype=dtype, device="cpu"),
            reference_rhs(shape[0], dtype=dtype))


def _assert_norms(t_info, j_info, atol_rel=0.0):
    tn = t_info.residual_norms.double().numpy()
    jn = np.asarray(j_info.residual_norms, np.float64)
    assert tn.shape == jn.shape
    np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))
    np.testing.assert_array_equal(tn, torch.sqrt(t_info.rho_history).double().numpy())
    ok = ~np.isnan(jn)
    first = jn[..., :1] if jn.ndim == 2 else jn[0]
    sel = ok & (jn > FLOOR * np.broadcast_to(first, jn.shape))
    atol = atol_rel * np.broadcast_to(first, jn.shape)[sel]
    assert np.all(np.abs(tn[sel] - jn[sel]) <= RTOL * np.abs(jn[sel]) + atol)


def test_residual_norms_is_a_property_not_a_field():
    assert "residual_norms" not in {f.name for f in dataclasses.fields(CGInfo)}
    assert isinstance(CGInfo.residual_norms, property)


def test_portable_and_pcg():
    ja, ta, b = _pair()
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=1e-8)
    _, it = cg_solve(ta, torch.from_numpy(b), tol=1e-8)
    _assert_norms(it, ij)
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=1e-8, M=jcg.jacobi_preconditioner(ja))
    _, it = cg_solve(ta, torch.from_numpy(b), tol=1e-8, M=jacobi_preconditioner(ta))
    _, ik = cg_solve(ta, torch.from_numpy(b), tol=1e-8, M=jacobi_preconditioner(ta),
                     recompute_r_every=7)
    _assert_norms(it, ij)
    assert ik.residual_norms.shape == it.residual_norms.shape


def test_fused_plain_versions():
    """The fused loop on the CPU runs its kernels' plain versions; its
    float32 history against the JAX interpret-mode one (the storage-parity
    bar of tests/test_torch_solver.py: 25 steps to 5e-2)."""
    rows, cols, vals, shape = poisson2d_coo(16)
    jcsr = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
    jb = JBell.from_csr(jcsr, bm=8, bn=8)
    tb = convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols), jb.shape,
                                  jb.nnz, device="cpu")
    b = reference_rhs(shape[0], dtype=np.float32)
    _, ij = jfused.fused_bell_cg_solve(jb, jnp.asarray(b), tol=0.0, maxiter=25, interpret=True)
    _, it = fused_bell_cg_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=25)
    tn, jn = it.residual_norms.double().numpy(), np.asarray(ij.residual_norms, np.float64)
    np.testing.assert_array_equal(tn, torch.sqrt(it.rho_history).double().numpy())
    np.testing.assert_allclose(tn, jn, rtol=5e-2)


def test_batched_and_block():
    ja, ta, b = _pair()
    n = b.shape[0]
    B = np.stack([np.roll(b, j) for j in range(3)])
    _, ij = jcg.cg_solve_batched(ja, jnp.asarray(B), tol=1e-6)
    _, it = cg_solve_batched(ta, torch.from_numpy(B), tol=1e-6)
    assert it.residual_norms.shape == (3, n + 2)
    _assert_norms(it, ij)
    _, ij = jcg.block_cg_solve(ja, jnp.asarray(B), tol=1e-6)
    _, it = block_cg_solve(ta, torch.from_numpy(B), tol=1e-6)
    assert it.residual_norms.shape == (3, n + 2)
    # block CG: 1e-10 relative + 1e-12 ||r_0|| (module doc)
    _assert_norms(it, ij, atol_rel=1e-12)


def test_sharded():
    rows, cols, vals, shape = poisson2d_coo(12)
    a = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    jb, jc, n_pad = jpartition(a.data, a.indices, a.indptr, a.shape, 8, bm=8, bn=8)
    b = np.zeros(n_pad)
    b[: shape[0]] = reference_rhs(shape[0])
    tb, tc = convert.sharded_bell_from_arrays(jb, jc, device="cpu")
    _, it = sharded_cg_solve(tb, tc, b, mesh=make_row_mesh(8, "cpu"), tol=1e-8,
                             use_fused="never")
    _, ij = jsharded(jb, jc, b, tol=1e-8, maxiter=n_pad + 1, use_fused="never")
    _assert_norms(it, ij)


def test_pipelined_and_sstep():
    from conjugategradient_tpu.solver.sstep import sstep_cg_solve as jsstep

    ja, ta, b = _pair()
    _, ij = jpipelined(ja, jnp.asarray(b), tol=1e-6)
    _, it = pipelined_cg_solve(ta, torch.from_numpy(b), tol=1e-6)
    _assert_norms(it, ij)
    _, ij = jsstep(ja, jnp.asarray(b), s=2, tol=1e-6)
    _, it = sstep_cg_solve(ta, torch.from_numpy(b), s=2, tol=1e-6)
    _assert_norms(it, ij)


def _recording(store, to_np):
    def dot_fn(x, y):
        store.append((to_np(x), to_np(y)))
        return (x * y).sum()
    return dot_fn


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "pcg"])
def test_cg_step_dot_fn_sees_the_jax_calls(precond):
    ja, ta, b = _pair(10)
    jM = jcg.jacobi_preconditioner(ja) if precond else None
    tM = jacobi_preconditioner(ta) if precond else None
    js = jcg_mod.cg_init(ja, jnp.asarray(b), M=jM, maxiter=8)
    ts = cg_init(ta, torch.from_numpy(b), M=tM, maxiter=8)
    jcalls, tcalls = [], []
    jdot = _recording(jcalls, lambda v: np.asarray(v))
    tdot = _recording(tcalls, lambda v: v.numpy().copy())
    tol_j = jnp.asarray(0.0)
    tol_t = torch.tensor(0.0, dtype=torch.float64)
    for _ in range(3):
        js = jcg_mod.cg_step(ja, js, tol_j, M=jM, dot_fn=jdot)
        ts = cg_step(ta, ts, tol_t, M=tM, dot_fn=tdot)
    assert len(tcalls) == len(jcalls) == 3 * (3 if precond else 2)
    for (tx, ty), (jx, jy) in zip(tcalls, jcalls):
        np.testing.assert_allclose(tx, jx, rtol=1e-12, atol=1e-12 * np.abs(jx).max())
        np.testing.assert_allclose(ty, jy, rtol=1e-12, atol=1e-12 * np.abs(jy).max())
    for f in ("x", "r", "p", "rho", "rnorm_sq", "hist"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-12)
    assert int(ts.k) == int(js.k) == 3


def test_cg_step_default_dot_is_unchanged():
    """The default ``dot_fn`` is ``ops.blas.dot``: passing it explicitly
    gives the same bits as leaving it out."""
    from conjugategradient_tpu_torch.ops.blas import dot

    _, ta, b = _pair(10)
    M = jacobi_preconditioner(ta)
    s0 = cg_init(ta, torch.from_numpy(b), M=M, maxiter=6)
    tol = torch.tensor(0.0, dtype=torch.float64)
    s1, s2 = s0, s0
    for _ in range(4):
        s1 = cg_step(ta, s1, tol, M=M)
        s2 = cg_step(ta, s2, tol, M=M, dot_fn=dot)
    for f in ("x", "r", "p", "rho", "rnorm_sq", "hist"):
        torch.testing.assert_close(getattr(s1, f), getattr(s2, f), rtol=0, atol=0, equal_nan=True)
