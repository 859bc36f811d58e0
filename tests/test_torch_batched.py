"""The port's lockstep multi-RHS CG (``solver/batched.py``) against the JAX
package's, on the same numpy inputs (CPU), mirroring ``tests/test_batched.py``.

Tolerances, with their reasons: float64 solves take the same steps in both
packages with sums in another order, so per-lane ``iterations`` and
``converged`` are equal, ``rho_history`` agrees to 1e-10 relative outside
the converged tail (entries above 1e-14·ρ₀, where the two sum orders have
not yet parted by more; with an absolute 1e-16·ρ₀ for the true residuals
of restarts) and X to 1e-10 of max|X|.  Where the JAX test
compares the batched solve with solo solves, the port's is compared with
the port's solo solves the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver.precond import block_jacobi_preconditioner as jbj
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu.types import SellMatrix as JSell
from conjugategradient_tpu.types import SymDIAMatrix as JSymDIA
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, DIAMatrix, SellMatrix,
                                         SymDIAMatrix, cg_solve, cg_solve_batched,
                                         jacobi_preconditioner)
from conjugategradient_tpu_torch.ops import dia_spmv_multi
from conjugategradient_tpu_torch.problems import poisson2d_coo
from conjugategradient_tpu_torch.solver import batched as tb
from conjugategradient_tpu_torch.solver.precond import block_jacobi_preconditioner

CPU = "cpu"
HIST_FLOOR = 1e-14


def _problem(nx=10):
    rows, cols, vals, shape = poisson2d_coo(nx)
    a = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    return JCSR.from_scipy(a), CSRMatrix.from_scipy(a, device=CPU), shape[0]


def _rhs(R, n, seed):
    return np.random.default_rng(seed).standard_normal((R, n))


def _both(jA, tA, B, **kw):
    """The JAX and the port's batched solve on the same inputs; ``M`` as a
    pair (jax, port)."""
    jM, tM = kw.pop("M", (None, None))
    tol = kw.pop("tol")
    Xj, ij = jcg.cg_solve_batched(jA, jnp.asarray(B), tol=jnp.asarray(tol), M=jM, **kw)
    Xt, it = cg_solve_batched(tA, torch.from_numpy(B), tol=torch.as_tensor(tol), M=tM, **kw)
    return (np.asarray(Xj), ij), (Xt, it)


def _check(jres, tres):
    (Xj, ij), (Xt, it) = jres, tres
    np.testing.assert_array_equal(it.iterations.numpy(), np.asarray(ij.iterations))
    np.testing.assert_array_equal(it.converged.numpy(), np.asarray(ij.converged))
    hj, ht = np.asarray(ij.rho_history), it.rho_history.numpy()
    assert ht.shape == hj.shape and Xt.shape == Xj.shape
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    keep = np.isfinite(hj) & (hj > HIST_FLOOR * hj[:, :1])
    # a restart's true ‖b − Ax‖² carries an absolute error of ~1e-16·ρ₀
    # (tests/test_torch_dia.py's floor under residual replacement)
    bound = 1e-10 * np.abs(hj) + 1e-16 * hj[:, :1]
    assert np.all(np.abs(ht - hj)[keep] <= bound[keep])
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0, atol=1e-10 * np.abs(Xj).max())


def _check_solo(tA, B, X, info, **kw):
    """Each lane against the port's solo portable solve."""
    tols = np.broadcast_to(kw.pop("tol"), (B.shape[0],))
    for i in range(B.shape[0]):
        x_i, info_i = cg_solve(tA, torch.from_numpy(B[i]), tol=float(tols[i]), fused="never",
                               **kw)
        assert int(info.iterations[i]) == int(info_i.iterations), i
        assert bool(info.converged[i]) == bool(info_i.converged)
        np.testing.assert_allclose(X[i].numpy(), x_i.numpy(), rtol=0,
                                   atol=1e-8 * float(x_i.abs().max()))


def test_batched_matches_sequential():
    jA, tA, n = _problem()
    B = _rhs(4, n, 0)
    jres, tres = _both(jA, tA, B, tol=1e-10)
    _check(jres, tres)
    X, info = tres
    assert X.shape == (4, n) and bool(info.converged.all())
    _check_solo(tA, B, X, info, tol=1e-10)
    R = torch.from_numpy(B) - torch.stack([tA.matvec(X[i]) for i in range(4)])
    assert float(R.abs().max()) < 1e-8


def test_batched_with_preconditioner():
    jA, tA, n = _problem(8)
    B = _rhs(3, n, 1)
    M = (jcg.jacobi_preconditioner(jA), jacobi_preconditioner(tA))
    jres, tres = _both(jA, tA, B, tol=1e-9, M=M)
    _check(jres, tres)
    X = tres[0]
    R = torch.from_numpy(B) - torch.stack([tA.matvec(X[i]) for i in range(3)])
    assert float(R.abs().max()) < 1e-7


def test_batched_shape_validation():
    _, tA, n = _problem(5)
    with pytest.raises(ValueError, match="nrhs"):
        cg_solve_batched(tA, torch.ones(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="tol must be scalar"):
        cg_solve_batched(tA, torch.ones(2, n, dtype=torch.float64), tol=torch.ones(2, 2))
    with pytest.raises(TypeError, match="lockstep-capable"):
        tb.batched_cg_init(tA, torch.ones(2, n, dtype=torch.float64))


def _bell(jA, tA, bm=8, bn=128):
    return JBell.from_csr(jA, bm=bm, bn=bn), BlockedEllMatrix.from_csr(tA, bm=bm, bn=bn)


def test_batched_bell_dedicated_loop_matches_sequential():
    jA, tA, n = _problem(16)  # n = 256: two 128-wide column blocks
    jbell, tbell = _bell(jA, tA)
    B = _rhs(4, n, 2)
    jres, tres = _both(jbell, tbell, B, tol=1e-10)
    _check(jres, tres)
    X, info = tres
    assert info.rho_history.shape[0] == 4
    _check_solo(tbell, B, X, info, tol=1e-10)


def test_batched_bell_heterogeneous_convergence():
    """Lanes ending at different iterations: the late lane does not move
    the early lane's frozen state."""
    jA, tA, n = _problem(16)
    jbell, tbell = _bell(jA, tA)
    B = np.stack([np.zeros(n), np.random.default_rng(3).standard_normal(n)])
    jres, tres = _both(jbell, tbell, B, tol=1e-10)
    _check(jres, tres)
    X, info = tres
    assert int(info.iterations[0]) < int(info.iterations[1])
    assert bool((X[0] == 0).all())
    assert float(torch.linalg.norm(torch.from_numpy(B[1]) - tbell.matvec(X[1]))) < 1e-8


def test_dia_spmv_multi_parity():
    jA, tA, n = _problem(9)
    dia = DIAMatrix.from_csr(tA)
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 6)))
    Y = dia_spmv_multi(dia, X)
    Yj = np.asarray(jcg.ops.dia_spmv_multi(JDIA.from_csr(jA), jnp.asarray(X.numpy())))
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=1e-12, atol=1e-12)
    for j in range(6):
        assert torch.equal(Y[:, j], dia.matvec(X[:, j].contiguous()))


def test_batched_dia_dedicated_loop_matches_sequential():
    jA, tA, n = _problem(12)
    B = _rhs(4, n, 5)
    jres, tres = _both(JDIA.from_csr(jA), DIAMatrix.from_csr(tA), B, tol=1e-10)
    _check(jres, tres)
    _check_solo(DIAMatrix.from_csr(tA), B, *tres, tol=1e-10)


def test_batched_per_lane_tol():
    """(nrhs,) tolerances: each lane stops at its own, in the lockstep loop
    (DIA) and in the per-lane solo solves (CSR)."""
    jA, tA, n = _problem(12)
    rng = np.random.default_rng(6)
    B = np.stack([rng.standard_normal(n), 10.0 * rng.standard_normal(n)])
    tols = np.array([1e-8, 1e-4])
    for jop, top in ((JDIA.from_csr(jA), DIAMatrix.from_csr(tA)), (jA, tA)):
        jres, tres = _both(jop, top, B, tol=tols)
        _check(jres, tres)
        _check_solo(top, B, *tres, tol=tols)
    with pytest.raises(ValueError, match="per-lane tol has length 3"):
        cg_solve_batched(DIAMatrix.from_csr(tA), torch.from_numpy(B),
                         tol=torch.tensor([1e-8, 1e-8, 1e-8], dtype=torch.float64))


def test_batched_bell_jacobi_lockstep_matches_solo():
    jA, tA, n = _problem(16)
    jbell, tbell = _bell(jA, tA)
    M = (jcg.jacobi_preconditioner(jbell), jacobi_preconditioner(tbell))
    B = _rhs(3, n, 7)
    jres, tres = _both(jbell, tbell, B, tol=1e-10, M=M)
    _check(jres, tres)
    _check_solo(tbell, B, *tres, tol=1e-10, M=M[1])


def test_batched_sell_blockjacobi_lockstep_matches_solo():
    """A per-vector M (block-Jacobi) rides the lockstep loop column by
    column on a SELL operator."""
    jA, tA, n = _problem(12)
    M = (jbj(jA, block_size=4), block_jacobi_preconditioner(tA, block_size=4))
    B = _rhs(3, n, 8)
    jres, tres = _both(JSell.from_csr(jA), SellMatrix.from_csr(tA), B, tol=1e-10, M=M)
    _check(jres, tres)
    _check_solo(SellMatrix.from_csr(tA), B, *tres, tol=1e-10, M=M[1])


def test_batched_lockstep_restart_matches_solo_restart():
    """recompute_r_every in the lockstep loop: per-lane parity with the
    JAX loop and with solo restart solves, frozen lanes untouched."""
    jA, tA, n = _problem(14)
    jbell, tbell = _bell(jA, tA, bm=8, bn=8)
    B = _rhs(3, n, 9)
    jres, tres = _both(jbell, tbell, B, tol=1e-9, maxiter=n + 1, recompute_r_every=5)
    _check(jres, tres)
    _check_solo(tbell, B, *tres, tol=1e-9, recompute_r_every=5)


@pytest.mark.parametrize("layout", ["dia", "symdia"])
def test_dia_and_symdia_always_take_the_lockstep_loop(layout, monkeypatch):
    """In place of the JAX package's two TPU-gate tests: the port has no
    gate, so DIA and symmetric DIA, also at offsets >= 1024, always run the
    lockstep loop on their multi-RHS SpMV (never the per-lane solo solve),
    and match the JAX package, which takes the same loop off a TPU."""
    n, k = 2500, 1100
    rng = np.random.default_rng(10)
    d0 = 4.0 + rng.random(n)
    up = 0.1 * rng.standard_normal(n)
    up[n - k:] = 0.0
    if layout == "dia":
        lo = np.zeros(n)
        lo[k:] = up[: n - k]
        diags, offsets = np.stack([lo, d0, up]), (-k, 0, k)
        jop, top = (JDIA(jnp.asarray(diags), offsets, (n, n), n + 2 * (n - k)),
                    DIAMatrix(torch.from_numpy(diags), offsets, (n, n), n + 2 * (n - k)))
    else:
        diags, offsets = np.stack([d0, up]), (0, k)
        jop, top = (JSymDIA(jnp.asarray(diags), offsets, (n, n), n + 2 * (n - k)),
                    SymDIAMatrix(torch.from_numpy(diags), offsets, (n, n), n + 2 * (n - k)))
    monkeypatch.setattr(tb, "cg_solve", lambda *a, **kw: pytest.fail("per-lane solo solve"))
    calls = []
    real = tb._MULTI[type(top)]
    monkeypatch.setitem(tb._MULTI, type(top), lambda a, X: calls.append(X.shape) or real(a, X))
    B = _rhs(3, n, 11)
    jres, tres = _both(jop, top, B, tol=1e-10)
    _check(jres, tres)
    assert calls and all(s == (n, 3) for s in calls)


@pytest.mark.parametrize("solver", ["cg", "block", "minres", "bicgstab", "gmres"])
def test_layout_subclass_takes_the_lockstep_loop(solver, monkeypatch):
    """An operator whose type derives from a lockstep layout runs that
    layout's multi-RHS SpMV in every batched solver, as ``isinstance``
    admits it at the gate, with the bits of the layout itself."""
    from conjugategradient_tpu_torch import (bicgstab_solve_batched, block_cg_solve,
                                             gmres_solve_batched, minres_solve_batched)

    class DerivedDIA(DIAMatrix):
        pass

    _, tA, n = _problem(8)
    base = DIAMatrix.from_csr(tA)
    derived = DerivedDIA(base.diags, base.offsets, base.shape, base.nnz)
    run = {"cg": cg_solve_batched, "block": block_cg_solve, "minres": minres_solve_batched,
           "bicgstab": bicgstab_solve_batched, "gmres": gmres_solve_batched}[solver]
    B = torch.from_numpy(_rhs(3, n, 12))
    Xb, ib = run(base, B, tol=1e-10)
    calls = []
    real = tb._MULTI[DIAMatrix]
    monkeypatch.setitem(tb._MULTI, DIAMatrix, lambda a, X: calls.append(X.shape) or real(a, X))
    Xd, idd = run(derived, B, tol=1e-10)
    assert calls and all(s == (n, 3) for s in calls)
    assert torch.equal(Xd, Xb)
    assert torch.equal(idd.iterations, ib.iterations)
