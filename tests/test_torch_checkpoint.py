"""Checkpoints (``solver/checkpoint.py``): the port's ``save_state`` /
``load_state`` / ``run_cg`` against themselves and against the JAX
package's, on the same numpy inputs (CPU).

A file written by either package loads in the other (the same field names
and ``__kind__``).  Chunked ``run_cg`` drives the same step as one solve,
so it gives the same bits; a float64 JAX checkpoint resumed by the port
reaches the JAX run's iterations, with the history to 1e-12 of ‖r₀‖²
(sums in another order) and x to 1e-12 of max|x|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conjugategradient_tpu.solver import checkpoint as jck
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.solver.cg import cg_init as jcg_init
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, SymBellMatrix, cg_solve,
                                         fused_bell_cg_solve, jacobi_preconditioner)
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import (FusedCGState, cg_init, fused_cg_init, load_state,
                                                run_cg, save_state)

CPU = "cpu"


@pytest.fixture(scope="module")
def system():
    rows, cols, vals, shape = poisson2d_coo(12)
    return (CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU),
            JCSR.from_coo(rows, cols, vals, shape), shape[0])


def _bits(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("precond", [False, True], ids=["cg", "jacobi-pcg"])
def test_chunked_run_cg_is_one_solve(system, tmp_path, chunk, precond):
    """run_cg in chunks, through a file between each, gives the bits of
    cg_solve."""
    A, _, n = system
    b = torch.from_numpy(reference_rhs(n))
    M = jacobi_preconditioner(A) if precond else None
    x_ref, info = cg_solve(A, b, tol=1e-10, M=M)
    state = cg_init(A, b, M=M, maxiter=n + 1)
    while not bool(state.done) and int(state.k) < n + 1:
        k0 = int(state.k)
        state = run_cg(A, state, 1e-10, steps=chunk, M=M)
        assert int(state.k) <= k0 + chunk
        save_state(tmp_path / "s.npz", state)
        state = load_state(tmp_path / "s.npz", device=CPU)
    assert int(state.k) == int(info.iterations)
    _bits(state.x, x_ref)
    _bits(state.hist, info.rho_history)


def test_jax_checkpoint_resumed_by_the_port(system, tmp_path):
    A, jA, n = system
    b = reference_rhs(n)
    jfull = jck.run_cg(jA, jcg_init(jA, jnp.asarray(b), maxiter=n + 1), 1e-10)
    jhalf = jck.run_cg(jA, jcg_init(jA, jnp.asarray(b), maxiter=n + 1), 1e-10, steps=20)
    jck.save_state(tmp_path / "j.npz", jhalf)
    resumed = run_cg(A, load_state(tmp_path / "j.npz", device=CPU), 1e-10)
    assert int(resumed.k) == int(jfull.k) and bool(resumed.done)
    hj = np.asarray(jfull.hist)
    np.testing.assert_allclose(resumed.hist.numpy(), hj, rtol=0, atol=1e-12 * hj[0])
    np.testing.assert_allclose(resumed.x.numpy(), np.asarray(jfull.x), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jfull.x)).max())


def test_port_checkpoint_resumed_by_jax(system, tmp_path):
    A, jA, n = system
    b = torch.from_numpy(reference_rhs(n))
    full = run_cg(A, cg_init(A, b, maxiter=n + 1), 1e-10)
    half = run_cg(A, cg_init(A, b, maxiter=n + 1), 1e-10, steps=20)
    save_state(tmp_path / "t.npz", half)
    loaded = jck.load_state(tmp_path / "t.npz")
    assert type(loaded).__name__ == "CGState" and int(loaded.k) == 20
    for name in ("x", "r", "p", "rho", "rnorm_sq", "hist"):
        _bits(getattr(loaded, name), getattr(half, name))
    jres = jck.run_cg(jA, loaded, 1e-10)
    assert int(jres.k) == int(full.k)
    h = full.hist.numpy()
    np.testing.assert_allclose(np.asarray(jres.hist), h, rtol=0, atol=1e-12 * h[0])


@pytest.fixture(scope="module")
def bell_pair():
    rows, cols, vals, shape = poisson2d_coo(16)
    csr = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device=CPU)
    full = BlockedEllMatrix.from_csr(csr, bm=32, bn=32)
    jfull = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32), bm=32, bn=32)
    return full, SymBellMatrix.from_bell(full), jfull


@pytest.mark.parametrize("storage", ["full", "symmetric"])
def test_fused_chunks_through_files_are_one_solve(bell_pair, tmp_path, storage):
    """The fused loop (its plain versions here): 4 chunks of 16 steps with
    save/load between, bit-equal to one 64-step solve at tol = -1."""
    a = bell_pair[0] if storage == "full" else bell_pair[1]
    b = torch.arange(1, a.n + 1, dtype=torch.float32)
    x_ref, info = fused_bell_cg_solve(a, b, tol=-1.0, maxiter=64)
    state = fused_cg_init(a, b, maxiter=64, tol=-1.0)
    for i in range(4):
        state = run_cg(a, state, -1.0, steps=16)
        assert int(state.k) == 16 * (i + 1)
        save_state(tmp_path / "f.npz", state)
        state = load_state(tmp_path / "f.npz", device=CPU)
        assert isinstance(state, FusedCGState)
    _bits(state.hist, info.rho_history)
    _bits(state.x.reshape(-1)[: a.n], x_ref)


def test_fused_files_cross_both_ways(bell_pair, tmp_path):
    full, _, jfull = bell_pair
    b = np.arange(1, full.n + 1, dtype=np.float32)
    js = jfused.fused_cg_init(jfull, jnp.asarray(b), maxiter=9)
    jck.save_state(tmp_path / "j.npz", js)
    ts = load_state(tmp_path / "j.npz", device=CPU)
    for name in ("x", "r", "p", "beta", "rho", "hist"):
        _bits(getattr(ts, name), getattr(js, name))
    assert int(ts.k) == 0 and not bool(ts.done) and bool(ts.live)
    run_cg(full, ts, 1e-3, steps=3)
    save_state(tmp_path / "t.npz", ts)
    back = jck.load_state(tmp_path / "t.npz")
    assert type(back).__name__ == "FusedCGState" and int(back.k) == 3
    for name in ("x", "r", "p", "beta", "rho", "hist"):
        _bits(getattr(back, name), getattr(ts, name))


# every JAX carry is ported: ShardedCGState, the last (ROADMAP.md section 1,
# item 12), now loads and resumes (tests/test_torch_sharded_state.py holds
# its files against the JAX package's)
@pytest.mark.parametrize("kind,item", [("ShardedCGState", "item 12")])
def test_unported_carries_name_the_roadmap(tmp_path, kind, item):
    import scipy.sparse as sp

    from conjugategradient_tpu_torch import parallel as tpar

    rows, cols, vals, shape = poisson2d_coo(12)
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sort_indices()
    n = shape[0]
    blocks, bcols, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, 4,
                                                   bm=8, bn=8)
    b = torch.zeros(n_pad, dtype=torch.float64)
    b[:n] = torch.from_numpy(reference_rhs(n))
    g = tpar.make_row_mesh(4, CPU)
    x_ref, info = tpar.sharded_cg_solve(blocks, bcols, b, mesh=g, tol=1e-10, use_fused="never")
    state = tpar.sharded_cg_init(blocks, bcols, b, mesh=g)
    state = tpar.sharded_run_cg(blocks, bcols, state, tol=1e-10, steps=10, mesh=g)
    save_state(tmp_path / "u.npz", state)
    loaded = load_state(tmp_path / "u.npz", device=CPU)
    assert type(loaded).__name__ == kind, f"{kind} (ROADMAP.md section 1, {item})"
    done = tpar.sharded_run_cg(blocks, bcols, loaded, tol=1e-10, mesh=g)
    assert int(done.k) == int(info.iterations) > 10
    _bits(done.x, x_ref)
    _bits(done.hist, info.rho_history)


def test_refusals(system, bell_pair, tmp_path):
    A, _, n = system
    with pytest.raises(TypeError, match="not a checkpointable solver state"):
        save_state(tmp_path / "x.npz", object())
    np.savez(tmp_path / "w.npz", __kind__=np.asarray("WhatState"))
    with pytest.raises(TypeError, match="not a checkpointable solver state: WhatState"):
        load_state(tmp_path / "w.npz", device=CPU)
    full = bell_pair[0]
    b = torch.ones(full.n)
    pcg = fused_cg_init(full, b, maxiter=4, inv_diag=1.0 / full.diagonal())
    with pytest.raises(ValueError, match="unpreconditioned"):
        save_state(tmp_path / "p.npz", pcg)
    with pytest.raises(ValueError, match="unpreconditioned"):
        run_cg(full, pcg, 0.0)
    with pytest.raises(ValueError, match="unpreconditioned"):
        run_cg(full, fused_cg_init(full, b, maxiter=4), 0.0, M=jacobi_preconditioner(full))
    # a file without __kind__ is a CGState (the JAX package's files before the fused path)
    s = cg_init(A, torch.from_numpy(reference_rhs(n)), maxiter=5)
    np.savez(tmp_path / "old.npz", **{k: getattr(s, k).numpy() for k in
                                      ("k", "done", "x", "r", "p", "rho", "rnorm_sq", "hist")})
    assert type(load_state(tmp_path / "old.npz", device=CPU)).__name__ == "CGState"


# the lockstep multi-RHS carry (solver/batched.py)
@pytest.fixture(scope="module")
def dia_pair():
    from conjugategradient_tpu.types import DIAMatrix as JDIA
    from conjugategradient_tpu_torch import DIAMatrix

    rows, cols, vals, shape = poisson2d_coo(12)
    return (DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)),
            JDIA.from_csr(JCSR.from_coo(rows, cols, vals, shape)), shape[0])


def _rhs_block(n, R=3, seed=3):
    return np.random.default_rng(seed).standard_normal((R, n))


@pytest.mark.parametrize("every", [0, 5])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_run_batched_cg_is_one_solve(dia_pair, tmp_path, chunk, every):
    """run_batched_cg in chunks, through a file between each, gives the bits
    of cg_solve_batched (the restart boundaries run on from the carry's
    count, so a chunk may stop inside a restart period)."""
    from conjugategradient_tpu_torch.solver import (BatchedCGState, batched_cg_init,
                                                    batched_state_result, cg_solve_batched,
                                                    run_batched_cg)

    A, _, n = dia_pair
    B = torch.from_numpy(_rhs_block(n))
    tols = torch.tensor([1e-9, 1e-6, 1e-10], dtype=torch.float64)
    X_ref, info = cg_solve_batched(A, B, tol=tols, recompute_r_every=every)
    state = batched_cg_init(A, B, maxiter=n + 1)
    while bool(((~state.done) & (state.k < n + 1)).any()):
        k0 = int(state.k.max())
        state = run_batched_cg(A, state, tols, steps=chunk, B=B, recompute_r_every=every)
        assert int(state.k.max()) <= k0 + chunk
        save_state(tmp_path / "b.npz", state)
        state = load_state(tmp_path / "b.npz", device=CPU)
        assert isinstance(state, BatchedCGState)
    X, binfo = batched_state_result(state)
    _bits(X, X_ref)
    for name in ("iterations", "converged", "rho", "rnorm_sq", "rho_history"):
        _bits(getattr(binfo, name), getattr(info, name))


def test_batched_files_cross_both_ways(dia_pair, tmp_path):
    """A JAX BatchedCGState file resumed by the port, and the port's
    resumed by the JAX package, reach the uninterrupted solve's iterations
    with the history to 1e-12 of ‖r₀‖² (sums in another order)."""
    from conjugategradient_tpu.solver import batched as jb
    from conjugategradient_tpu_torch.solver import batched_cg_init, run_batched_cg

    A, jA, n = dia_pair
    B = _rhs_block(n)
    jfull = jb.run_batched_cg(jA, jb.batched_cg_init(jA, jnp.asarray(B), maxiter=n + 1), 1e-9)
    jhalf = jb.run_batched_cg(jA, jb.batched_cg_init(jA, jnp.asarray(B), maxiter=n + 1), 1e-9,
                              steps=15)
    jck.save_state(tmp_path / "j.npz", jhalf)
    loaded = load_state(tmp_path / "j.npz", device=CPU)
    for name in ("k", "done", "X", "r", "p", "rho", "rnorm", "hist"):
        _bits(getattr(loaded, name), getattr(jhalf, name))
    resumed = run_batched_cg(A, loaded, 1e-9)
    hj = np.asarray(jfull.hist)
    _bits(resumed.k, jfull.k)
    np.testing.assert_allclose(resumed.hist.numpy(), hj, rtol=0, atol=1e-12 * hj[0].max())

    half = run_batched_cg(A, batched_cg_init(A, torch.from_numpy(B), maxiter=n + 1), 1e-9,
                          steps=15)
    save_state(tmp_path / "t.npz", half)
    back = jck.load_state(tmp_path / "t.npz")
    assert type(back).__name__ == "BatchedCGState" and int(np.max(back.k)) == 15
    for name in ("k", "done", "X", "r", "p", "rho", "rnorm", "hist"):
        _bits(getattr(back, name), getattr(half, name))
    jres = jb.run_batched_cg(jA, back, 1e-9)
    _bits(jres.k, jfull.k)
    np.testing.assert_allclose(np.asarray(jres.hist), hj, rtol=0, atol=1e-12 * hj[0].max())
