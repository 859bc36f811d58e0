"""The port's checkpointable sharded state (``conjugategradient_tpu_torch
.parallel.ShardedCGState``, ``sharded_{,dia_,sell_}cg_init`` /
``..._run_cg``, ``sharded_state_result``) and its ``.npz`` files, against
the JAX package's, on the CPU: the JAX side on the 8 virtual devices
tests/conftest.py sets up, the port on ``make_row_mesh(8, "cpu")``, both
fed the same numpy arrays.

Tolerances, with their reasons: a solve advanced in chunks through files is
bit for bit the port's uninterrupted portable solve (``use_fused="never"``:
the same body, the same local product).  Against the JAX package, float64:
equal iteration counts, ``rho_history`` to 1e-10 relative plus 1e-16 of its
first entry (the packages sum the shards' partials in other orders).  A
file written by either package resumes in the other, the history written
before the file bit for bit.  The JAX tests that count compiled programs
(``test_chunked_driving_compiles_once``) have a check of the host reads a
chunk here: the port compiles nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu.parallel as jpar
import conjugategradient_tpu.solver.checkpoint as jck
import conjugategradient_tpu_torch.parallel as tpar
from conjugategradient_tpu_torch.problems import (banded_spd_coo, poisson2d_coo,
                                                  powerlaw_spd_coo, reference_rhs)
from conjugategradient_tpu_torch.solver.checkpoint import load_state, save_state

N_DEV = 8
CPU = "cpu"
RTOL = 1e-10
FLOOR = 1e-16
FIELDS = ("k", "done", "x", "r", "p", "rho", "rnorm", "hist")


def _csr(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


def _rhs(n_pad, n):
    b = np.zeros(n_pad)
    b[:n] = reference_rhs(n)
    return b


def _bits(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8))


def _hist_close(got, want, k):
    got, want = np.asarray(got)[:k + 1], np.asarray(want)[:k + 1]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=FLOOR * abs(want[0]))


def _mesh():
    return tpar.make_row_mesh(N_DEV, CPU)


@pytest.fixture(scope="module")
def bell16():
    a = _csr(poisson2d_coo(16))
    blocks, bcols, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                                   bm=8, bn=8)
    b = _rhs(n_pad, a.shape[0])
    return a, blocks, bcols, n_pad, b


@pytest.fixture(scope="module")
def jax_bell16(bell16):
    a, blocks, bcols, n_pad, b = bell16
    n = a.shape[0]
    return jpar.sharded_cg_solve(jnp.asarray(blocks), jnp.asarray(bcols), jnp.asarray(b),
                                 tol=1e-10, maxiter=n + 1)


def test_sharded_checkpoint_resume_bit_identical(tmp_path, bell16, jax_bell16):
    a, blocks, bcols, n_pad, b = bell16
    n, tol = a.shape[0], 1e-10
    bt = torch.tensor(b)
    x_ref, info_ref = tpar.sharded_cg_solve(blocks, bcols, bt, mesh=_mesh(), tol=tol,
                                            maxiter=n + 1, use_fused="never")
    state = tpar.sharded_cg_init(blocks, bcols, bt, mesh=_mesh(), maxiter=n + 1)
    state = tpar.sharded_run_cg(blocks, bcols, state, tol=tol, steps=9, mesh=_mesh())
    assert int(state.k) == 9
    save_state(tmp_path / "sharded.npz", state)
    state2 = load_state(tmp_path / "sharded.npz", device=CPU)
    assert type(state2).__name__ == "ShardedCGState"
    for name in FIELDS:
        _bits(getattr(state2, name), getattr(state, name))
    state2 = tpar.sharded_run_cg(blocks, bcols, state2, tol=tol, steps=13, mesh=_mesh())
    assert int(state2.k) == 22
    state2 = tpar.sharded_run_cg(blocks, bcols, state2, tol=tol, mesh=_mesh())
    x_ck, info_ck = tpar.sharded_state_result(state2)
    assert int(info_ck.iterations) == int(info_ref.iterations)
    assert bool(info_ck.converged) == bool(info_ref.converged) is True
    _bits(x_ck, x_ref)
    _bits(info_ck.rho_history, info_ref.rho_history)
    # and the JAX sharded solve's count and history
    _, jinfo = jax_bell16
    k = int(jinfo.iterations)
    assert int(info_ck.iterations) == k
    _hist_close(info_ck.rho_history, jinfo.rho_history, k)


def test_sharded_checkpoint_with_jacobi(tmp_path):
    a = _csr(poisson2d_coo(12))
    n = a.shape[0]
    blocks, bcols, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                                   bm=8, bn=8)
    b = torch.tensor(_rhs(n_pad, n))
    inv = np.ones(n_pad)
    inv[:n] = 1.0 / a.diagonal()
    inv = torch.tensor(inv)
    x_ref, info_ref = tpar.sharded_cg_solve(blocks, bcols, b, mesh=_mesh(), tol=1e-10,
                                            maxiter=n + 1, inv_diag=inv, use_fused="never")
    state = tpar.sharded_cg_init(blocks, bcols, b, mesh=_mesh(), maxiter=n + 1, inv_diag=inv)
    chunks = 0
    while not bool(state.done) and int(state.k) < n + 1:
        save_state(tmp_path / "j.npz", state)
        state = load_state(tmp_path / "j.npz", device=CPU)
        state = tpar.sharded_run_cg(blocks, bcols, state, tol=1e-10, steps=11, mesh=_mesh(),
                                    inv_diag=inv)
        chunks += 1
    x_ck, info_ck = tpar.sharded_state_result(state)
    assert chunks > 2 and int(info_ck.iterations) == int(info_ref.iterations)
    _bits(x_ck, x_ref)
    _bits(info_ck.rho_history, info_ref.rho_history)
    jx, jinfo = jpar.sharded_cg_solve(jnp.asarray(blocks), jnp.asarray(bcols),
                                      jnp.asarray(b.numpy()), tol=1e-10, maxiter=n + 1,
                                      inv_diag=jnp.asarray(inv.numpy()))
    assert int(info_ck.iterations) == int(jinfo.iterations)
    _hist_close(info_ck.rho_history, jinfo.rho_history, int(jinfo.iterations))


def test_sharded_run_requires_b_for_restart():
    a = _csr(poisson2d_coo(8))
    n = a.shape[0]
    blocks, bcols, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                                   bm=8, bn=8)
    state = tpar.sharded_cg_init(blocks, bcols, torch.tensor(_rhs(n_pad, n)), mesh=_mesh(),
                                 maxiter=n + 1)
    with pytest.raises(ValueError, match="needs b"):
        tpar.sharded_run_cg(blocks, bcols, state, recompute_r_every=5, mesh=_mesh())


def test_sharded_restart_through_chunks_bit_identical(bell16):
    """Residual replacement every 7 iterations, driven in chunks of 5: the
    restart boundaries run on from the state's k."""
    a, blocks, bcols, n_pad, b = bell16
    n, bt = a.shape[0], torch.tensor(b)
    x_ref, info_ref = tpar.sharded_cg_solve(blocks, bcols, bt, mesh=_mesh(), tol=1e-10,
                                            maxiter=n + 1, use_fused="never",
                                            recompute_r_every=7)
    state = tpar.sharded_cg_init(blocks, bcols, bt, mesh=_mesh(), maxiter=n + 1)
    while bool(state.live):
        state = tpar.sharded_run_cg(blocks, bcols, state, tol=1e-10, steps=5, mesh=_mesh(),
                                    b=bt, recompute_r_every=7)
    x_ck, info_ck = tpar.sharded_state_result(state)
    assert int(info_ck.iterations) == int(info_ref.iterations)
    _bits(x_ck, x_ref)
    _bits(info_ck.rho_history, info_ref.rho_history)


def test_sharded_dia_checkpoint_resume_bit_identical(tmp_path):
    from conjugategradient_tpu_torch import CSRMatrix, DIAMatrix

    rows, cols, vals, shape = banded_spd_coo(280, bandwidth=6, seed=9)
    dia = DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU))
    n = shape[0]
    diags_sh, n_pad = tpar.partition_dia_rows(dia.diags.numpy(), shape, N_DEV)
    b = torch.tensor(_rhs(n_pad, n))
    x_ref, info_ref = tpar.sharded_dia_cg_solve(diags_sh, dia.offsets, b, mesh=_mesh(),
                                                tol=1e-9, maxiter=n + 1)
    state = tpar.sharded_dia_cg_init(diags_sh, dia.offsets, b, mesh=_mesh(), maxiter=n + 1)
    state = tpar.sharded_dia_run_cg(diags_sh, dia.offsets, state, tol=1e-9, steps=7,
                                    mesh=_mesh())
    save_state(tmp_path / "dia.npz", state)
    state = load_state(tmp_path / "dia.npz", device=CPU)
    state = tpar.sharded_dia_run_cg(diags_sh, dia.offsets, state, tol=1e-9, mesh=_mesh())
    x_ck, info_ck = tpar.sharded_state_result(state)
    assert int(info_ck.iterations) == int(info_ref.iterations)
    _bits(x_ck, x_ref)
    _bits(info_ck.rho_history, info_ref.rho_history)
    _, jinfo = jpar.sharded_dia_cg_solve(jnp.asarray(diags_sh), dia.offsets,
                                         jnp.asarray(b.numpy()), tol=1e-9, maxiter=n + 1)
    assert int(info_ck.iterations) == int(jinfo.iterations)
    _hist_close(info_ck.rho_history, jinfo.rho_history, int(jinfo.iterations))


def test_sharded_sell_checkpoint_resume_bit_identical(tmp_path):
    a = _csr(powerlaw_spd_coo(400, avg_degree=4.0, seed=5))
    n = a.shape[0]
    sell_sh = tpar.partition_sell_rows(a.data, a.indices, a.indptr, a.shape, N_DEV)
    b = torch.tensor(_rhs(sell_sh[-1], n))
    x_ref, info_ref = tpar.sharded_sell_cg_solve(sell_sh, b, mesh=_mesh(), tol=1e-9,
                                                 maxiter=n + 1)
    state = tpar.sharded_sell_cg_init(sell_sh, b, mesh=_mesh(), maxiter=n + 1)
    state = tpar.sharded_sell_run_cg(sell_sh, state, tol=1e-9, steps=5, mesh=_mesh())
    save_state(tmp_path / "sell.npz", state)
    state = tpar.sharded_sell_run_cg(sell_sh, load_state(tmp_path / "sell.npz", device=CPU),
                                     tol=1e-9, mesh=_mesh())
    x_ck, info_ck = tpar.sharded_state_result(state)
    assert int(info_ck.iterations) == int(info_ref.iterations)
    _bits(x_ck, x_ref)
    _bits(info_ck.rho_history, info_ref.rho_history)
    _, jinfo = jpar.sharded_sell_cg_solve(sell_sh, jnp.asarray(b.numpy()), tol=1e-9,
                                          maxiter=n + 1)
    assert int(info_ck.iterations) == int(jinfo.iterations)
    # CG on this power-law graph multiplies the two packages' summation
    # order difference ~100-fold a step from step 13 (1e-14 there, 1e-12 at
    # 14, O(1) by 20): the histories are held over the first 12 steps
    _hist_close(info_ck.rho_history, jinfo.rho_history, 12)


def test_sharded_files_cross_both_ways(tmp_path, bell16, jax_bell16):
    """A JAX file resumes in the port and a port file in JAX: the state as
    written, bit for bit, then each package runs the solve to its end in
    the JAX iteration count."""
    a, blocks, bcols, n_pad, b = bell16
    n, tol = a.shape[0], 1e-10
    jb, jc = jnp.asarray(blocks), jnp.asarray(bcols)
    k_ref = int(jax_bell16[1].iterations)
    js = jpar.sharded_cg_init(jb, jc, jnp.asarray(b), maxiter=n + 1)
    js = jpar.sharded_run_cg(jb, jc, js, tol=tol, steps=9)
    jck.save_state(tmp_path / "j.npz", js)
    ts = load_state(tmp_path / "j.npz", device=CPU)
    for name in FIELDS:
        _bits(getattr(ts, name), getattr(js, name))
    ts = tpar.sharded_run_cg(blocks, bcols, ts, tol=tol, mesh=_mesh())
    assert int(ts.k) == k_ref and bool(ts.done)
    _bits(ts.hist[:10], js.hist[:10])

    ts = tpar.sharded_cg_init(blocks, bcols, torch.tensor(b), mesh=_mesh(), maxiter=n + 1)
    ts = tpar.sharded_run_cg(blocks, bcols, ts, tol=tol, steps=9, mesh=_mesh())
    save_state(tmp_path / "t.npz", ts)
    back = jck.load_state(tmp_path / "t.npz")
    assert type(back).__name__ == "ShardedCGState" and int(back.k) == 9
    for name in FIELDS:
        _bits(getattr(back, name), getattr(ts, name))
    back = jpar.sharded_run_cg(jb, jc, back, tol=tol)
    assert int(back.k) == k_ref and bool(back.done)
    _bits(np.asarray(back.hist)[:10], ts.hist[:10])


def _count_host_reads(fn):
    """``fn()`` with every host read of a tensor (bool, int, float, item)
    counted."""
    seen = [0]
    names = ("__bool__", "__int__", "__float__", "item")
    saved = {name: getattr(torch.Tensor, name) for name in names}

    def counting(orig):
        def read(self, *args):
            seen[0] += 1
            return orig(self, *args)

        return read

    try:
        for name in names:
            setattr(torch.Tensor, name, counting(saved[name]))
        out = fn()
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
    return seen[0], out


def test_chunked_driving_reads_k_once_a_chunk(bell16):
    """The port's counterpart of ``test_chunked_driving_compiles_once``:
    driving 24 steps in 4 chunks makes 3 host reads more than in one chunk
    (each call reads k once; the done polls and the live checks are those
    of the same 24 steps), and lands on the same state."""
    a, blocks, bcols, n_pad, b = bell16
    n, bt = a.shape[0], torch.tensor(b)
    start = tpar.sharded_cg_init(blocks, bcols, bt, mesh=_mesh(), maxiter=n + 1)

    def drive(chunks):
        s = start
        for steps in chunks:
            s = tpar.sharded_run_cg(blocks, bcols, s, tol=1e-10, steps=steps, mesh=_mesh())
        return s

    one, s1 = _count_host_reads(lambda: drive([24]))
    four, s4 = _count_host_reads(lambda: drive([5, 7, 1, 11]))
    assert int(s1.k) == int(s4.k) == 24
    assert four - one == 3, (one, four)
    for name in FIELDS:
        _bits(getattr(s4, name), getattr(s1, name))
