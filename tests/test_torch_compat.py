"""The port's reference object API (``compat.CG``) against the JAX
package's ``CG``, on the same numpy inputs (CPU), mirroring
``tests/test_compat.py``; and ``memory_footprint`` against JAX's.

Tolerances: float64 solves take the same iterations in both packages; x
agrees to 1e-12 relative, the residual history to 1e-10 of ‖r₀‖² (sums in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver.cg import memory_footprint as jmf
from conjugategradient_tpu_torch import CG, CSRMatrix, cg_solve, memory_footprint
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs

CPU = "cpu"


@pytest.fixture(scope="module")
def system():
    rows, cols, vals, shape = poisson2d_coo(12)
    return (CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU),
            jcg.CSRMatrix.from_coo(rows, cols, vals, shape), shape[0])


def _host_csr(A):
    return A.data.numpy(), A.indices.numpy(), A.indptr.numpy()


def _pair_solved(A, jA, n, tol, x0=None, typo=False):
    out = []
    for cls, mat, kw in ((CG, A, {"device": CPU}), (jcg.CG, jA, {})):
        cg = cls(**kw)
        cg.setMatrix(mat)
        cg.setTarget(reference_rhs(n))
        if x0 is not None:
            (cg.setInital if typo else cg.setInitial)(x0)
        cg.solve(tol)
        out.append(cg)
    return out


def _same(t, j):
    assert t.iterations == j.iterations and t.converged == j.converged
    np.testing.assert_allclose(t.extract(), j.extract(), rtol=1e-12)
    ht, hj = t.residual_history, j.residual_history
    assert len(ht) == len(hj) == t.iterations + 1
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-10 * hj[0])


def test_tester_cpp_workflow(system):
    """The reference harness's call sequence (test/Tester.cpp)."""
    A, jA, n = system
    res = []
    for cls, kw in ((CG, {"device": CPU}), (jcg.CG, {})):
        cg = cls.createCG(verbose=False, **kw)
        cg.setMatrix(*_host_csr(A))
        cg.setTarget(reference_rhs(n))
        cg.solve(1e-24)
        res.append(cg)
    t, j = res
    assert t.getDimension() == j.getDimension() == n
    assert t.extract().shape == (n,) and t.extract().dtype == np.float64
    assert t.accuracy() < 1e-20 and j.accuracy() < 1e-20  # both at the roundoff floor
    x_fn, _ = cg_solve(A, torch.from_numpy(reference_rhs(n)), tol=1e-24)
    np.testing.assert_allclose(t.extract(), x_fn.numpy(), rtol=1e-12)
    np.testing.assert_allclose(t.extract(), j.extract(), rtol=1e-10)


def test_missing_inputs_raise(system):
    A, _, n = system
    cg = CG(device=CPU)
    with pytest.raises(RuntimeError, match="No b vector"):
        cg.solve(1e-8)
    cg.setTarget(reference_rhs(n))
    with pytest.raises(RuntimeError, match="No Matrix"):
        cg.solve(1e-8)
    for call in (cg.getDimension, cg.memoryFootprint, lambda: cg.calculateExpectedStepCount(0.1)):
        with pytest.raises(RuntimeError, match="No Matrix"):
            call()
    for call in (cg.accuracy, cg.extract, lambda: cg.residual_history):
        with pytest.raises(RuntimeError, match="solve"):
            call()
    assert cg.iterations == 0 and cg.converged is False


def test_set_initial_and_typo_alias(system):
    A, jA, n = system
    x0 = np.linspace(0, 1, n)
    t1, j1 = _pair_solved(A, jA, n, 1e-10, x0=x0)
    t2, _ = _pair_solved(A, jA, n, 1e-10, x0=x0, typo=True)
    np.testing.assert_array_equal(t1.extract(), t2.extract())
    assert t1.iterations == t2.iterations > 0 and t1.converged
    _same(t1, j1)


def test_extract_to(system):
    A, jA, n = system
    t, j = _pair_solved(A, jA, n, 1e-10)
    buf = np.zeros(n)
    t.extractTo(buf)
    np.testing.assert_array_equal(buf, t.extract())
    lst = [0.0] * n
    t.extractTo(lst)
    np.testing.assert_allclose(lst, t.extract())
    _same(t, j)


def test_memory_footprint_and_history(system):
    A, jA, n = system
    cg, jg = CG(device=CPU), jcg.CG()
    cg.setMatrix(*_host_csr(A))
    jg.setMatrix(*_host_csr(A))
    assert cg.memoryFootprint() == jg.memoryFootprint() == (2 * A.nnz + 4 * n) * 8 + 2 * n * 4
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert memory_footprint(n, A.nnz, dtype) == jmf(n, A.nnz, jdtype)
        assert memory_footprint(n, A.nnz, dtype, index_bytes=8) == jmf(n, A.nnz, jdtype, 8)
    assert CG(torch.float32, device=CPU).createCG(torch.float32, device=CPU) is not None
    c32 = CG.createCG(torch.float32, device=CPU)
    c32.setMatrix(*_host_csr(A))
    assert c32.memoryFootprint() == jmf(n, A.nnz, jnp.float32)
    t, j = _pair_solved(A, jA, n, 1e-10)
    h = t.residual_history
    assert len(h) == t.iterations + 1 and h[-1] < h[0]
    _same(t, j)
    assert t.calculateExpectedStepCount(1e-6) == j.calculateExpectedStepCount(1e-6)


def test_checkpoint_roundtrip(tmp_path, system):
    from conjugategradient_tpu_torch.solver import cg_init, load_state, run_cg, save_state

    A, _, n = system
    b = torch.from_numpy(reference_rhs(n))
    full = run_cg(A, cg_init(A, b, maxiter=n + 1), 1e-10)
    half = run_cg(A, cg_init(A, b, maxiter=n + 1), 1e-10, steps=20)
    assert int(half.k) == 20
    save_state(tmp_path / "state.npz", half)
    resumed = run_cg(A, load_state(tmp_path / "state.npz", device=CPU), 1e-10)
    assert int(resumed.k) == int(full.k)
    np.testing.assert_array_equal(resumed.x.numpy(), full.x.numpy())
    np.testing.assert_array_equal(resumed.hist.numpy(), full.hist.numpy())


def test_solve_warm_starts_from_previous_solution(system):
    A, jA, n = system
    t, j = _pair_solved(A, jA, n, 1e-10)
    first = t.iterations
    for cg in (t, j):
        cg.solve(1e-10)
    assert t.iterations == j.iterations <= 2 < first
    assert t.accuracy() < 1e-18
