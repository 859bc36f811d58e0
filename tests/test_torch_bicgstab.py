"""The port's portable BiCGStab loop against the JAX package's (CPU), and
the operator-level repairs that came with it: ``cg_solve(n=)``, the
top-level exports, the operator methods of ``tests/test_types.py`` and
``tests/test_torch_interop.py``, and ``MatrixFreeOperator``'s device.

Tolerances, with their reasons: float64 solves take the same steps in both
packages, with dots summed in another order, so the iteration counts and
flags are equal and ``rnorm_history`` agrees to 1e-10 of ‖r₀‖ (the
roundoff of a few dozen f64 steps; the entries near convergence are
themselves ~1e-10 of ‖r₀‖, so a relative bound on them would test noise),
x to 1e-10.  Float32 solves show trajectory parity: the history to 1e-3
relative over the first 12 steps (one of them a spike of 4.5x, where the
f32 sums' order shows most), the same convergence flag, iterations
within 10%.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
import conjugategradient_tpu_torch as tcg
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (
    BlockedEllMatrix,
    CSRMatrix,
    DIAMatrix,
    MatrixFreeOperator,
    SellMatrix,
    SymBellMatrix,
    as_linear_operator,
    bicgstab_solve,
    cg_solve,
    jacobi_preconditioner,
)
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.ops.blas import norm
from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo, poisson2d_coo
from conjugategradient_tpu_torch.types import DEFAULT_DEVICE, DenseOperator

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent


def _convdiff(nx=20, peclet=20.0):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=peclet)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


@pytest.fixture(scope="module")
def convdiff():
    return _convdiff(16)


def _pair(a, dtype=np.float64):
    """The same scipy matrix as a JAX CSRMatrix and a port CSRMatrix."""
    return JCSR.from_scipy(a, dtype=dtype), CSRMatrix.from_scipy(a, dtype=dtype, device=CPU)


def _check_f64(ij, it, xj, xt):
    k = int(ij.iterations)
    assert int(it.iterations) == k
    assert bool(it.converged) == bool(ij.converged)
    assert bool(it.breakdown) == bool(ij.breakdown)
    hj, ht = np.asarray(ij.rnorm_history), it.rnorm_history.numpy()
    assert np.isnan(ht[k + 1:]).all() and np.isfinite(ht[: k + 1]).all()
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=0, atol=1e-10 * hj[0])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(it.rnorm_true), float(ij.rnorm_true), rtol=1e-6,
                               atol=1e-12 * hj[0])


# ---- the portable loop against the JAX package ------------------------------------------

@pytest.mark.parametrize("nx,peclet", [(16, 20.0), (24, 20.0), (34, 20.0)])
def test_convdiff_f64_matches_jax(nx, peclet):
    a = _convdiff(nx, peclet)
    ja, ta = _pair(a)
    b = np.random.default_rng(nx).standard_normal(a.shape[0])
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b), tol=1e-10, maxiter=2000)
    xt, it = bicgstab_solve(ta, torch.from_numpy(b), tol=1e-10, maxiter=2000)
    assert bool(it.converged) and not bool(it.breakdown)
    _check_f64(ij, it, xj, xt)
    assert float(it.rnorm_true) <= 5e-10
    assert it.residual_norms is it.rnorm_history


def test_spd_case_matches_cg():
    rows, cols, vals, shape = poisson2d_coo(12)
    op = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(shape[0]))
    x_cg, _ = cg_solve(op, b, tol=1e-12)
    x_bi, info = bicgstab_solve(op, b, tol=1e-12, maxiter=2000)
    assert bool(info.converged)
    np.testing.assert_allclose(x_bi.numpy(), x_cg.numpy(), rtol=0, atol=1e-9)
    jop = JCSR.from_coo(rows, cols, vals, shape)
    xj, ij = jcg.bicgstab_solve(jop, jnp.asarray(b.numpy()), tol=1e-12, maxiter=2000)
    _check_f64(ij, info, xj, x_bi)


def test_jacobi_matches_jax():
    a = _convdiff(16, peclet=8.0)
    d = sp.diags(np.exp(np.linspace(0.0, 3.0, a.shape[0])))
    As = (d @ a @ d).tocsr()
    ja, ta = _pair(As)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    _, plain = bicgstab_solve(ta, torch.from_numpy(b), tol=1e-8, maxiter=4000)
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b), tol=1e-8, maxiter=4000,
                                M=jcg.jacobi_preconditioner(ja))
    xt, it = bicgstab_solve(ta, torch.from_numpy(b), tol=1e-8, maxiter=4000,
                            M=jacobi_preconditioner(ta))
    assert bool(it.converged) and int(it.iterations) < int(plain.iterations)
    k = int(ij.iterations)
    assert int(it.iterations) == k and bool(ij.converged)
    hj, ht = np.asarray(ij.rnorm_history), it.rnorm_history.numpy()
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=0, atol=1e-10 * hj[0])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())


def test_half_step_exact_exit():
    a = np.array([[2.0]])
    xj, ij = jcg.bicgstab_solve(jnp.asarray(a), jnp.array([4.0]), tol=1e-12)
    xt, it = bicgstab_solve(torch.from_numpy(a), torch.tensor([4.0], dtype=torch.float64),
                            tol=1e-12)
    assert bool(it.converged) and int(it.iterations) == 1 == int(ij.iterations)
    assert float(xt[0]) == float(xj[0]) == 2.0
    assert float(it.rnorm) == 0.0


def test_skew_breakdown_is_clean():
    a = np.array([[0.0, 1.0], [-1.0, 0.0]])
    b = np.array([1.0, 0.0])
    xj, ij = jcg.bicgstab_solve(jnp.asarray(a), jnp.asarray(b), tol=1e-12, maxiter=10)
    xt, it = bicgstab_solve(torch.from_numpy(a), torch.from_numpy(b), tol=1e-12, maxiter=10)
    assert bool(it.breakdown) and not bool(it.converged) and int(it.iterations) == 1
    assert bool(ij.breakdown) and int(ij.iterations) == 1
    assert np.isfinite(xt.numpy()).all()
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert float(it.rnorm) == float(ij.rnorm) == 1.0


def test_zero_tol_runs_to_the_cap(convdiff):
    ja, ta = _pair(convdiff)
    b = np.ones(convdiff.shape[0])
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b), tol=0.0, maxiter=7)
    xt, it = bicgstab_solve(ta, torch.from_numpy(b), tol=0.0, maxiter=7)
    assert int(it.iterations) == 7 and not bool(it.converged)
    _check_f64(ij, it, xj, xt)


def test_maxiter_defaults_to_n():
    a = _convdiff(6, peclet=1.0)
    _, ta = _pair(a)
    _, it = bicgstab_solve(ta, torch.ones(a.shape[0], dtype=torch.float64), tol=0.0)
    assert it.rnorm_history.numel() == a.shape[0] + 1


def test_history_and_warm_start(convdiff):
    ja, ta = _pair(convdiff)
    b = np.random.default_rng(4).standard_normal(convdiff.shape[0])
    x, info = bicgstab_solve(ta, torch.from_numpy(b), tol=1e-10, maxiter=2000)
    k = int(info.iterations)
    hist = info.rnorm_history.numpy()
    np.testing.assert_allclose(hist[0], np.linalg.norm(b), rtol=1e-12)
    np.testing.assert_allclose(hist[k], float(info.rnorm), rtol=1e-12)
    _, info2 = bicgstab_solve(ta, torch.from_numpy(b), x0=x, tol=1e-8)
    assert int(info2.iterations) == 0 and bool(info2.converged)
    # a warm start that is not the solution: the same steps as the JAX loop
    x0 = 0.1 * np.random.default_rng(5).standard_normal(convdiff.shape[0])
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b), jnp.asarray(x0), tol=1e-10, maxiter=2000)
    xt, it = bicgstab_solve(ta, torch.from_numpy(b), torch.from_numpy(x0), tol=1e-10,
                            maxiter=2000)
    _check_f64(ij, it, xj, xt)


@pytest.mark.parametrize("layout", ["csr", "bell", "dia", "sell", "callable"])
def test_layouts_and_callable_match_jax(convdiff, layout):
    ja, ta = _pair(convdiff)
    b = np.random.default_rng(5).standard_normal(convdiff.shape[0])
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b), tol=1e-10, maxiter=2000)
    kw = {}
    if layout == "bell":
        op = BlockedEllMatrix.from_csr(ta)
    elif layout == "dia":
        op = DIAMatrix.from_csr_host(convdiff.data, convdiff.indices, convdiff.indptr,
                                     convdiff.shape, device=CPU)
    elif layout == "sell":
        op = SellMatrix.from_csr_host(convdiff.data, convdiff.indices, convdiff.indptr,
                                      convdiff.shape, device=CPU)
    elif layout == "callable":
        op, kw = ta.matvec, {"n": convdiff.shape[0]}
    else:
        op = ta
    xt, it = bicgstab_solve(op, torch.from_numpy(b), tol=1e-10, maxiter=2000, **kw)
    assert bool(it.converged)
    _check_f64(ij, it, xj, xt)


def test_float32_trajectory_parity(convdiff):
    ja, ta = _pair(convdiff, dtype=np.float32)
    b = np.random.default_rng(6).standard_normal(convdiff.shape[0]).astype(np.float32)
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b), tol=1e-4, maxiter=4000)
    xt, it = bicgstab_solve(ta, torch.from_numpy(b), tol=1e-4, maxiter=4000)
    assert bool(it.converged) and bool(ij.converged)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert abs(kt - kj) <= max(2, kj // 10)
    np.testing.assert_allclose(it.rnorm_history.numpy()[:13],
                               np.asarray(ij.rnorm_history)[:13], rtol=1e-2)
    assert float(it.rnorm_true) <= 5e-4
    assert it.rnorm_history.dtype == torch.float32


# float32 BiCGStab's true residual stalls at the residual gap, a multiple of
# eps·max_k ‖r_k‖; chip_smoke.py holds the card's float32 tester lines to
# the same multiple
GAP_ULPS = 64


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_float32_residual_gap_follows_the_recurrence_peak(precond):
    """convdiff_34 as the tester solves it (b = 1..n, tol 1e-5·‖b‖) in
    float32, by the JAX loop and by the port's, the latter also with the
    unknowns renumbered 8 ways (every sum then rounds another way): each
    converged x has ‖b − A x‖ ≤ tol + GAP_ULPS·eps·max_k ‖r_k‖, however far
    the recurrence spiked on the way."""
    data, indices, indptr, shape = tloader.read_csr_host(ROOT / "problems" / "convdiff_34.mtx")
    n = shape[0]
    a64 = sp.csr_matrix((data, indices, indptr), shape=shape)
    b0 = np.arange(1, n + 1, dtype=np.float64)
    tol = 1e-5 * float(np.linalg.norm(b0))
    eps = float(np.finfo(np.float32).eps)
    jacobi = precond == "jacobi"

    def holds(x, hist, k):
        peak = float(np.max(hist[: k + 1]))
        res = float(np.linalg.norm(b0 - a64 @ x))
        assert res <= tol + GAP_ULPS * eps * peak, (res, peak)

    ja = JCSR.from_scipy(a64, dtype=np.float32)
    xj, ij = jcg.bicgstab_solve(ja, jnp.asarray(b0, jnp.float32), tol=tol,
                                M=jcg.jacobi_preconditioner(ja) if jacobi else None)
    assert bool(ij.converged)
    holds(np.asarray(xj, np.float64), np.asarray(ij.rnorm_history), int(ij.iterations))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    converged = 0
    for seed in range(-1, 8):
        perm = np.arange(n) if seed < 0 else np.random.default_rng(seed).permutation(n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        ta = CSRMatrix.from_coo(inv[rows], inv[indices], data, shape, dtype=torch.float32,
                                device=CPU)
        xt, it = bicgstab_solve(ta, torch.from_numpy(b0[perm].astype(np.float32)), tol=tol,
                                M=jacobi_preconditioner(ta) if jacobi else None)
        assert bool(it.converged) != bool(it.breakdown)
        if bool(it.converged):
            converged += 1
            holds(xt.double().numpy()[inv], it.rnorm_history.numpy(), int(it.iterations))
    assert converged >= 7


def test_fused_choice_is_validated(convdiff):
    _, ta = _pair(convdiff)
    b = torch.ones(convdiff.shape[0], dtype=torch.float64)
    with pytest.raises(ValueError, match="fused must be one of"):
        bicgstab_solve(ta, b, tol=1e-6, fused="alwas")
    _, never = bicgstab_solve(ta, b, tol=1e-6, fused="never")
    _, auto = bicgstab_solve(ta, b, tol=1e-6)
    np.testing.assert_array_equal(never.rnorm_history.numpy(), auto.rnorm_history.numpy())


def test_steps_past_the_end_change_nothing(convdiff, monkeypatch):
    """The portable loop masks a step on a finished state: a solve whose
    host reads the flag only every 32 steps gives the same bits."""
    from conjugategradient_tpu_torch.solver import restart

    _, ta = _pair(convdiff)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(convdiff.shape[0]))
    x1, i1 = bicgstab_solve(ta, b, tol=1e-9, maxiter=2000)
    calls = []
    monkeypatch.setattr(restart._DonePoll, "finished", lambda self: calls.append(1) and False)
    x2, i2 = bicgstab_solve(ta, b, tol=1e-9, maxiter=2000)
    assert len(calls) > int(i1.iterations)  # it ran past the end
    assert torch.equal(x1, x2)
    np.testing.assert_array_equal(i1.rnorm_history.numpy(), i2.rnorm_history.numpy())
    assert int(i2.iterations) == int(i1.iterations)


# ---- the repairs ------------------------------------------------------------------------

def test_cg_solve_takes_a_callable_with_n():
    rows, cols, vals, shape = poisson2d_coo(10)
    jop = JCSR.from_coo(rows, cols, vals, shape)
    top = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    b = np.random.default_rng(8).standard_normal(shape[0])
    _, ij = jcg.cg_solve(jop.matvec, jnp.asarray(b), tol=1e-10, n=shape[0])
    xt, it = cg_solve(top.matvec, torch.from_numpy(b), tol=1e-10, n=shape[0])
    k = int(ij.iterations)
    assert int(it.iterations) == k and bool(it.converged)
    hj = np.asarray(ij.rho_history)
    np.testing.assert_allclose(it.rho_history.numpy()[: k + 1], hj[: k + 1], rtol=0,
                               atol=1e-12 * hj[0])
    with pytest.raises(ValueError, match="n="):
        cg_solve(top.matvec, torch.from_numpy(b), tol=1e-10)
    acc = tcg.accuracy(top.matvec, torch.from_numpy(b), xt, n=shape[0])
    np.testing.assert_allclose(float(acc), float(tcg.accuracy(top, torch.from_numpy(b), xt)),
                               rtol=1e-14)
    est = tcg.expected_step_count(top.matvec, 1e-6, n=shape[0], device=CPU)
    assert est == tcg.expected_step_count(top, 1e-6)


def test_top_level_exports_follow_the_jax_package():
    """Every name the JAX package exports at its top level that the port
    has (anywhere in its subpackages) is exported at the port's top level
    too, under the same name."""
    from conjugategradient_tpu_torch import io, solver, types

    have = set(solver.__all__) | set(types.__all__) | set(io.__all__) | {"__version__"}
    for name in jcg.__all__:
        if name in have:
            assert name in tcg.__all__, name
            assert getattr(tcg, name) is not None
    for name in ("bicgstab_solve", "BicgstabInfo", "fused_bicgstab_solve",
                 "fused_bicgstab_supported", "MatrixFreeOperator", "CGState", "cg_init",
                 "cg_step", "read_mtx_csr", "write_mtx"):
        assert name in tcg.__all__ and hasattr(tcg, name), name
    assert tcg.__version__ == jcg.__version__


@pytest.fixture(scope="module")
def poisson_pair():
    rows, cols, vals, shape = poisson2d_coo(20)
    return (JCSR.from_coo(rows, cols, vals, shape),
            CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU))


def test_operator_methods_match_jax(poisson_pair):
    jc, tc = poisson_pair
    # the JAX package's four arrays, and the port's int64 row lengths
    assert tc.memory_footprint() == jc.memory_footprint() + tc.shape[0] * 8
    x = torch.ones(tc.shape[1], dtype=torch.float64)
    assert torch.equal(tc @ x, tc.matvec(x))
    t32 = tc.astype(torch.float32)
    assert t32.dtype == torch.float32 and t32.indices is tc.indices
    jb, tb = JBell.from_csr(jc, bm=8, bn=128), BlockedEllMatrix.from_csr(tc, bm=8, bn=128)
    assert tb.memory_footprint() == jb.memory_footprint()
    js = jcg.SymBellMatrix.from_bell(JBell.from_csr(jc, bm=128, bn=128))
    ts = SymBellMatrix.from_csr(tc, bm=128, bn=128)
    np.testing.assert_array_equal(ts.to_dense().numpy(), np.asarray(js.to_dense()))
    np.testing.assert_array_equal(ts.to_dense().numpy(), tc.to_dense().numpy())
    assert ts.padding_ratio() == js.padding_ratio()
    assert ts.memory_footprint() == js.memory_footprint() + ts.mirror_src.numel() * 4
    assert ts.astype(torch.float32).diag_blocks.dtype == torch.float32
    d = np.random.default_rng(9).standard_normal((5, 5))
    dop = as_linear_operator(torch.from_numpy(d))
    assert isinstance(dop, DenseOperator) and dop.memory_footprint() == 25 * 8
    assert dop.astype(torch.float32).dtype == torch.float32
    assert tcg.StencilOperator.poisson((4, 4, 4), device=CPU).memory_footprint() == 0
    with pytest.raises(NotImplementedError, match="astype"):
        MatrixFreeOperator(lambda v: v, 3, device=CPU).astype(torch.float32)
    v = torch.tensor([3.0, 4.0])
    assert float(norm(v)) == 5.0


def test_csr_ingest_matches_jax(poisson_pair, rng_dense=np.random.default_rng(10)):
    a = rng_dense.standard_normal((6, 6))
    a[np.abs(a) < 0.5] = 0.0
    tm, jm = CSRMatrix.from_dense(a, device=CPU), JCSR.from_dense(a)
    np.testing.assert_array_equal(tm.to_dense().numpy(), np.asarray(jm.to_dense()))
    # scipy with unsorted duplicates: canonicalized on a copy
    s = sp.csr_matrix((np.array([1.0, 2.0, 3.0]), np.array([1, 0, 1]), np.array([0, 3, 3])),
                      shape=(2, 2))
    tm, jm = CSRMatrix.from_scipy(s, device=CPU), JCSR.from_scipy(s)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    assert s.nnz == 3  # the caller's matrix is untouched
    op = as_linear_operator(s.tocoo(), device=CPU)
    assert isinstance(op, CSRMatrix) and op.to_dense()[0, 1] == 4.0
    with pytest.raises(TypeError, match="scipy"):
        CSRMatrix.from_scipy(np.eye(2))


def test_torch_sparse_ingest_matches_jax():
    rows, cols, vals, shape = poisson2d_coo(6)
    t = torch.sparse_coo_tensor(torch.from_numpy(np.stack([rows, cols]).astype(np.int64)),
                                torch.from_numpy(vals), shape).to_sparse_csr()
    tm, jm = CSRMatrix.from_torch(t, device=CPU), JCSR.from_torch(t)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    back = tm.to_torch()
    assert back.layout == torch.sparse_csr and back.crow_indices().dtype == torch.int64
    np.testing.assert_array_equal(back.to_dense().numpy(), t.to_dense().numpy())
    # an uncoalesced COO sums its duplicates
    dup = torch.sparse_coo_tensor(torch.tensor([[0, 0, 1], [1, 1, 0]]),
                                  torch.tensor([1.0, 2.0, 4.0]), (2, 2))
    np.testing.assert_array_equal(CSRMatrix.from_torch(dup, device=CPU).to_dense().numpy(),
                                  [[0.0, 3.0], [4.0, 0.0]])
    assert CSRMatrix.from_torch(t.to_sparse_csc(), device=CPU).to_dense().equal(tm.to_dense())
    bf = CSRMatrix.from_torch(t.to(torch.bfloat16), device=CPU)
    assert bf.dtype == torch.bfloat16
    assert CSRMatrix.from_torch(t, dtype=torch.float32, device=CPU).dtype == torch.float32
    assert isinstance(as_linear_operator(t, device=CPU), CSRMatrix)
    for bad, err, what in ((torch.eye(3), ValueError, "as_linear_operator"),
                           (np.eye(3), TypeError, "torch.Tensor"),
                           (t.to(torch.complex64), ValueError, "complex")):
        with pytest.raises(err, match=what):
            CSRMatrix.from_torch(bad, device=CPU)


def test_torch_sparse_ingest_defaults_to_the_entry_point_device():
    """A CPU sparse tensor given no ``device`` goes to ``DEFAULT_DEVICE``, as
    ``from_dense``/``from_scipy`` do: without a GPU that raises torch's own
    error and never hands back a CPU operator."""
    rows, cols, vals, shape = poisson2d_coo(4)
    t = torch.sparse_coo_tensor(torch.from_numpy(np.stack([rows, cols]).astype(np.int64)),
                                torch.from_numpy(vals), shape)
    assert DEFAULT_DEVICE == "cuda"
    makes = (lambda: CSRMatrix.from_torch(t), lambda: as_linear_operator(t),
             lambda: as_linear_operator(sp.coo_matrix((vals, (rows, cols)), shape=shape)))
    for make in makes:
        if torch.cuda.is_available():
            assert make().device.type == DEFAULT_DEVICE
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()


def test_matrix_free_operator_defaults_to_the_entry_point_device():
    assert MatrixFreeOperator(lambda v: v, 4).device == torch.device(DEFAULT_DEVICE)
    assert as_linear_operator(lambda v: v, n=4).device == torch.device(DEFAULT_DEVICE)
    assert MatrixFreeOperator(lambda v: v, 4, device=CPU).device == torch.device(CPU)
    # the solvers pass b's device
    b = torch.ones(4, dtype=torch.float64)
    x, info = cg_solve(lambda v: 2 * v, b, tol=1e-12, n=4)
    assert x.device == b.device and bool(info.converged)
