"""The port's sharded stencil solve and its sharded preconditioners and
eigensolver (``sharded_stencil_cg_solve``, ``sharded_multigrid_
preconditioner``, ``sharded_amg_preconditioner``,
``sharded_fsai_preconditioner``, ``sharded_lobpcg_eigs``) on the CPU,
against the port's one-card solves and preconditioners (the JAX design's
invariant, ``tests/test_sharded_{multigrid,amg,fsai,lobpcg}.py``) and the
JAX package's sharded functions: the JAX side on the 8 virtual devices
tests/conftest.py sets up, the port on ``make_row_mesh(P, "cpu")``, both
fed the same numpy arrays made from a seed.

Tolerances, with their reasons: float64 throughout.  The sharded stencil
product and the sharded multigrid apply are bit for bit the one-card ones
(kernel 11's plain version on each haloed window, the one-card transfers
on each slab; ``sharded_stencil.py``), and held so; against the JAX sharded
solve, which sums the stencil's neighbours in another order, counts are
equal and ``rho_history`` agrees to 1e-10 relative plus 1e-16 of its first
entry.  The sharded AMG and FSAI applies match the one-card applies to
1e-11 relative (their level products sum in blocked-ELL tile order, the
one-card ones in CSR row order) and the JAX sharded applies, run under
``jax.shard_map``, to 1e-12 relative; their operator arrays are bit-equal
to the JAX functions'.  The PCG solves take the one-card iteration counts.
LOBPCG from the same X0 gives the JAX sharded LOBPCG's eigenvalues to
1e-10 and a dense ``eigh``'s to 1e-8.  A two-process gloo run of the sharded
multigrid apply is bit-equal to the in-process group.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu.parallel as jpar
import conjugategradient_tpu_torch.parallel as tpar
from conjugategradient_tpu_torch import (CSRMatrix, StencilOperator, cg_solve, fsai_preconditioner,
                                         lobpcg_eigs, multigrid_preconditioner,
                                         smoothed_aggregation_preconditioner)
from conjugategradient_tpu_torch.problems import poisson2d_coo, powerlaw_spd_coo

N_DEV = 8
CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64


def _csr(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


def _bits(got, want):
    got, want = got.contiguous(), want.contiguous()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _apply(pre, r, n_shards=N_DEV):
    """A collective ShardedPreconditioner's apply on a whole vector, over
    an in-process group: the slabs in, the joined result out."""
    g = tpar.make_row_mesh(n_shards, CPU)
    m = r.shape[0] // n_shards
    arrays = [torch.as_tensor(a) for a in pre.op_arrays]
    out = pre.make_local_apply(arrays, g)([r[i * m:(i + 1) * m] for i in range(n_shards)])
    return torch.cat(out)


def _partition(a, n_shards=N_DEV):
    return tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, n_shards, bm=8, bn=8)


# ---- the sharded stencil solve ------------------------------------------------------------

def test_sharded_stencil_product_is_the_one_card_slice():
    """Each shard's product is the matching slice of the one-card product,
    bit for bit (kernel 11's plain version on the haloed window)."""
    from conjugategradient_tpu_torch.parallel.sharded_stencil import _local_stencil_matvec

    grid = (16, 6, 10)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(int(np.prod(grid))))
    whole = StencilOperator.poisson(grid, dtype=F64, device=CPU).matvec(u)
    g = tpar.make_row_mesh(N_DEV, CPU)
    m = u.shape[0] // N_DEV
    parts = _local_stencil_matvec(g, [u[i * m:(i + 1) * m] for i in range(N_DEV)], 6.0, -1.0,
                                  (2, 6, 10))
    _bits(torch.cat(parts), whole)
    assert g.counts["ring_halo"] == 1


def test_sharded_stencil_matches_jax_and_the_one_card_solve():
    grid = (16, 6, 10)
    n = int(np.prod(grid))
    b = np.random.default_rng(1).standard_normal(n) / n
    x, info = tpar.sharded_stencil_cg_solve(grid, torch.tensor(b),
                                            mesh=tpar.make_row_mesh(N_DEV, CPU), tol=1e-10)
    jx, jinfo = jpar.sharded_stencil_cg_solve(grid, jnp.asarray(b), tol=1e-10, maxiter=n + 1)
    x1, i1 = cg_solve(StencilOperator.poisson(grid, dtype=F64, device=CPU), torch.tensor(b),
                      tol=1e-10)
    k = int(jinfo.iterations)
    assert int(info.iterations) == k == int(i1.iterations) and bool(info.converged)
    h, jh = info.rho_history.numpy()[:k + 1], np.asarray(jinfo.rho_history)[:k + 1]
    np.testing.assert_allclose(h, jh, rtol=1e-10, atol=1e-16 * jh[0])
    np.testing.assert_allclose(x.numpy(), x1.numpy(), rtol=0, atol=1e-9 * x1.abs().max())


def test_sharded_stencil_refusals():
    g = tpar.make_row_mesh(N_DEV, CPU)
    with pytest.raises(ValueError, match="divisible"):
        tpar.sharded_stencil_cg_solve((12, 4, 4), torch.zeros(192, dtype=F64), mesh=g)
    M = tpar.sharded_multigrid_preconditioner((32, 8, 8), N_DEV, dtype=F64)
    with pytest.raises(ValueError, match="not both"):
        tpar.sharded_stencil_cg_solve((32, 8, 8), torch.zeros(2048, dtype=F64), mesh=g,
                                      inv_diag=torch.ones(2048, dtype=F64), M_local=M)


# ---- the sharded multigrid --------------------------------------------------------------

MG_CASES = [
    ((32, 16, 8), {}),  # small enough that the whole cycle replicates
    ((32, 16, 8), {"agglomerate_below": 1}),  # one truly sharded level
    ((64, 16, 16), {"agglomerate_below": 1}),  # two sharded levels
    ((16, 9, 5), {"center": 6.0, "agglomerate_below": 1}),  # odd y/z
    ((64, 8, 8), {"cycles": 2, "agglomerate_below": 1}),
    ((32, 16, 1), {"center": 4.0, "agglomerate_below": 1}),  # a 2-D grid
    ((32, 16, 8), {"smoother": "chebyshev", "agglomerate_below": 1}),
    ((64, 16, 16), {"smoother": "chebyshev", "nu": 3, "agglomerate_below": 1}),
]


@pytest.mark.parametrize("shape,kw", MG_CASES)
def test_sharded_mg_apply_is_the_one_card_apply(shape, kw):
    """The sharded V-cycle gives the one-card V-cycle's bits, whatever the
    split between sharded and agglomerated levels."""
    n = int(np.prod(shape))
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(n))
    center = kw.get("center", 6.0)
    op = StencilOperator(center, -1.0, shape, F64, CPU)
    one_kw = {k: v for k, v in kw.items() if k not in ("agglomerate_below", "center")}
    want = multigrid_preconditioner(op, **one_kw)(r)
    pre = tpar.sharded_multigrid_preconditioner(shape, N_DEV, dtype=F64, off=-1.0, **kw)
    _bits(_apply(pre, r), want)


def test_sharded_mg_apply_matches_jax_sharded_apply():
    """Against the JAX sharded V-cycle (its stencil sums the neighbours in
    another order): float64 roundoff."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    shape = (64, 16, 16)
    n = int(np.prod(shape))
    r = np.random.default_rng(0).standard_normal(n)
    mesh = jpar.make_row_mesh()
    M = jpar.sharded_multigrid_preconditioner(shape, N_DEV, dtype=jnp.float64,
                                              agglomerate_below=1)
    f = jax.jit(jax.shard_map(M, mesh=mesh, in_specs=(P("rows"),), out_specs=P("rows"),
                              check_vma=False))
    want = np.asarray(f(jax.device_put(jnp.asarray(r), NamedSharding(mesh, P("rows")))))
    pre = tpar.sharded_multigrid_preconditioner(shape, N_DEV, dtype=F64, agglomerate_below=1)
    got = _apply(pre, torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())


def test_sharded_mgpcg_matches_one_card_iterations():
    shape = (32, 16, 16)
    n = int(np.prod(shape))
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    tol = 1e-9 * float(b.norm())
    op = StencilOperator.poisson(shape, dtype=F64, device=CPU)
    x1, i1 = cg_solve(op, b, tol=tol, M=multigrid_preconditioner(op))
    M = tpar.sharded_multigrid_preconditioner(shape, N_DEV, dtype=F64)
    g = tpar.make_row_mesh(N_DEV, CPU)
    xs, is_ = tpar.sharded_stencil_cg_solve(shape, b, mesh=g, tol=tol, M_local=M)
    k = int(i1.iterations)
    assert bool(is_.converged) and int(is_.iterations) == k
    np.testing.assert_allclose(xs.numpy(), x1.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(is_.rho_history[:k + 1].numpy(), i1.rho_history[:k + 1].numpy(),
                               rtol=1e-9)
    # and the plain sharded CG takes more than three times as many
    _, plain = tpar.sharded_stencil_cg_solve(shape, b, mesh=g, tol=tol)
    assert k <= 15 and 3 * k < int(plain.iterations)


def test_sharded_mg_preconditioner_validates():
    with pytest.raises(ValueError, match="divisible"):
        tpar.sharded_multigrid_preconditioner((30, 8, 8), N_DEV)
    pre = tpar.sharded_multigrid_preconditioner((32, 8, 8), N_DEV, dtype=F64)
    with pytest.raises(ValueError, match="built for 8 shards"):
        pre.make_local_apply([], tpar.make_row_mesh(4, CPU))


# ---- the sharded AMG ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poisson50():
    a = _csr(poisson2d_coo(50))
    return a, CSRMatrix.from_scipy(a, device=CPU), _partition(a)


AMG_CASES = [
    (10 ** 9, {}),  # the whole hierarchy replicated (split = 0)
    (600, {}),  # one sharded level
    (1, {}),  # every level sharded, a coarse-only tail
    (1, {"cycles": 2}),
    (1, {"nu": 1}),
    (1, {"smooth_prolongator": False}),  # P0 transfers both sides
    (1, {"smoother": "chebyshev"}),
    (600, {"smoother": "chebyshev", "nu": 3}),
    (10 ** 9, {"cycles": 2}),  # extra cycles' residual on the replicated tail
]


@pytest.mark.parametrize("agg_below,kw", AMG_CASES)
def test_sharded_amg_apply_matches_one_card(poisson50, agg_below, kw):
    a, A, (_, _, n_pad) = poisson50
    n = a.shape[0]
    pre = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, agglomerate_below=agg_below,
                                          dtype=F64, **kw)
    M = smoothed_aggregation_preconditioner(A, dtype=F64, **kw)
    assert pre.level_sizes == M.level_sizes
    r = torch.zeros(n_pad, dtype=F64)
    r[:n] = torch.as_tensor(np.random.default_rng(0).standard_normal(n))
    got = _apply(pre, r)
    want = M(r[:n])
    np.testing.assert_allclose(got[:n].numpy(), want.numpy(), rtol=1e-11,
                               atol=1e-13 * want.abs().max().item())
    assert got[n:].abs().max() == 0  # the padding stays exactly zero


def test_sharded_amg_and_fsai_arrays_are_the_jax_ones(poisson50):
    """The level operators, transfers, inverse diagonals and the FSAI
    factor's row blocks are the JAX functions' arrays, bit for bit."""
    a, A, (_, _, n_pad) = poisson50
    from conjugategradient_tpu import CSRMatrix as JCSR

    JA = JCSR.from_coo(*sp.find(a)[:2], sp.find(a)[2], a.shape)
    for build in ("amg", "fsai"):
        if build == "amg":
            got = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, agglomerate_below=1,
                                                  dtype=F64)
            want = jpar.sharded_amg_preconditioner(JA, N_DEV, n_pad, agglomerate_below=1,
                                                   dtype=jnp.float64)
            assert got.split == want.split and got.level_sizes == want.level_sizes
        else:
            got = tpar.sharded_fsai_preconditioner(A, N_DEV, n_pad, power=2, dtype=F64)
            want = jpar.sharded_fsai_preconditioner(JA, N_DEV, n_pad, power=2,
                                                    dtype=jnp.float64)
            assert got.nnz == want.nnz
        assert len(got.op_arrays) == len(want.op_arrays)
        for g_, w_ in zip(got.op_arrays, want.op_arrays):
            w_ = np.asarray(w_)
            assert g_.numpy().dtype == w_.dtype and np.array_equal(g_.numpy(), w_)


def _jax_sharded_apply(pre, r):
    """A JAX ShardedPreconditioner's apply on a whole vector, under
    ``jax.shard_map`` over the 8 virtual devices (as the JAX package's
    tests/test_sharded_amg.py runs it)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jpar.make_row_mesh()

    def run(*arrs):
        return pre.make_local_apply([a[0] for a in arrs[:-1]])(arrs[-1])

    f = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(P("rows"),) * (len(pre.op_arrays) + 1),
                              out_specs=P("rows"), check_vma=False))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("rows")))  # noqa: E731
    return np.asarray(f(*[put(a) for a in pre.op_arrays], put(r)))


@pytest.mark.parametrize("build,kw", [
    ("amg", {"agglomerate_below": 600, "cycles": 2}),  # a sharded level, the tail, two cycles
    ("amg", {"agglomerate_below": 1, "smoother": "chebyshev"}),  # every level sharded
    ("fsai", {"power": 2}),
])
def test_sharded_amg_and_fsai_applies_match_jax_sharded_applies(poisson50, build, kw):
    """The sharded V-cycle (sweep order, transfers, the tail at the split,
    the extra cycle's residual) and the FSAI apply against the JAX sharded
    applies on the same r: float64 roundoff."""
    a, A, (_, _, n_pad) = poisson50
    from conjugategradient_tpu import CSRMatrix as JCSR

    JA = JCSR.from_coo(*sp.find(a)[:2], sp.find(a)[2], a.shape)
    if build == "amg":
        got_pre = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, dtype=F64, **kw)
        want_pre = jpar.sharded_amg_preconditioner(JA, N_DEV, n_pad, dtype=jnp.float64, **kw)
    else:
        got_pre = tpar.sharded_fsai_preconditioner(A, N_DEV, n_pad, dtype=F64, **kw)
        want_pre = jpar.sharded_fsai_preconditioner(JA, N_DEV, n_pad, dtype=jnp.float64, **kw)
    n = a.shape[0]
    r = np.zeros(n_pad)
    r[:n] = np.random.default_rng(5).standard_normal(n)
    want = _jax_sharded_apply(want_pre, r)
    got = _apply(got_pre, torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13 * np.abs(want).max())
    assert np.abs(got[n:]).max(initial=0.0) == 0.0


def test_sharded_amg_apply_with_near_nullspace():
    coo = poisson2d_coo(40)
    L = _csr(coo)
    s = np.exp(np.random.default_rng(9).uniform(-2, 2, L.shape[0]))
    a = (sp.diags(s) @ L @ sp.diags(s)).tocsr()
    a.sort_indices()
    A = CSRMatrix.from_scipy(a, device=CPU)
    n = a.shape[0]
    _, _, n_pad = _partition(a)
    kw = dict(near_nullspace=1.0 / s, dtype=F64)
    pre = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, agglomerate_below=1, **kw)
    M = smoothed_aggregation_preconditioner(A, **kw)
    assert pre.level_sizes == M.level_sizes
    r = torch.zeros(n_pad, dtype=F64)
    r[:n] = torch.as_tensor(np.random.default_rng(9).standard_normal(n))
    want = M(r[:n])
    np.testing.assert_allclose(_apply(pre, r)[:n].numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12 * want.abs().max().item())


def test_sharded_amg_apply_on_scale_free_graph():
    a = _csr(powerlaw_spd_coo(4000, seed=3))
    A = CSRMatrix.from_scipy(a, device=CPU)
    n = a.shape[0]
    _, _, n_pad = _partition(a)
    pre = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, agglomerate_below=1, dtype=F64)
    M = smoothed_aggregation_preconditioner(A, dtype=F64)
    assert pre.level_sizes == M.level_sizes
    r = torch.zeros(n_pad, dtype=F64)
    r[:n] = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    want = M(r[:n])
    np.testing.assert_allclose(_apply(pre, r)[:n].numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12 * want.abs().max().item())


def test_sharded_amg_pcg_matches_one_card_iterations(poisson50):
    a, A, (blocks, bcols, n_pad) = poisson50
    n = a.shape[0]
    b = torch.zeros(n_pad, dtype=F64)
    b[:n] = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    tol = 1e-9 * float(b.norm())
    x1, i1 = cg_solve(A, b[:n], tol=tol, M=smoothed_aggregation_preconditioner(A, dtype=F64))
    g = tpar.make_row_mesh(N_DEV, CPU)
    pre = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, agglomerate_below=600, dtype=F64)
    x2, i2 = tpar.sharded_cg_solve(blocks, bcols, b, mesh=g, tol=tol, M_local=pre,
                                   use_fused="never")
    k = int(i1.iterations)
    assert bool(i2.converged) and int(i2.iterations) == k
    np.testing.assert_allclose(x2[:n].numpy(), x1.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(i2.rho_history[:k + 1].numpy(), i1.rho_history[:k + 1].numpy(),
                               rtol=1e-7)
    _, plain = tpar.sharded_cg_solve(blocks, bcols, b, mesh=g, tol=tol, use_fused="never")
    assert k <= 20 and 5 * k < int(plain.iterations)


def test_sharded_amg_reuse_resolves_with_the_same_reads():
    """The port's counterpart of ``test_reuse_compiles_once_and_resolves``:
    one preconditioner serves two solves, each correct, and the second
    makes no more host reads than the first (nothing is rebuilt)."""
    from test_torch_sharded_state import _count_host_reads

    a = _csr(poisson2d_coo(34))
    A = CSRMatrix.from_scipy(a, device=CPU)
    blocks, bcols, n_pad = _partition(a)
    n = a.shape[0]
    pre = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, dtype=F64)
    rng = np.random.default_rng(4)
    reads = []
    for _ in range(2):
        b = torch.zeros(n_pad, dtype=F64)
        b[:n] = torch.as_tensor(rng.standard_normal(n))
        count, (x, info) = _count_host_reads(lambda: tpar.sharded_cg_solve(
            blocks, bcols, b, mesh=tpar.make_row_mesh(N_DEV, CPU), tol=1e-9 * np.sqrt(n),
            M_local=pre, use_fused="never"))
        assert bool(info.converged)
        assert np.linalg.norm(b[:n].numpy() - a @ x[:n].numpy()) <= 1e-9 * np.sqrt(n) * 1.05
        reads.append(count / max(int(info.iterations), 1))
    assert reads[1] <= reads[0]


def test_sharded_amg_validation(poisson50):
    a, A, (_, _, n_pad) = poisson50
    for kw, match in ((dict(nu=0), "nu"), (dict(cycles=0), "cycles"), (dict(omega=2.0), "omega"),
                      (dict(level_layout="dia"), "level_layout"),
                      (dict(smoother="sor"), "smoother"), (dict(cheb_lower=1.0), "cheb_lower")):
        with pytest.raises(ValueError, match=match):
            tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, **kw)
    with pytest.raises(ValueError, match="n_padded"):
        tpar.sharded_amg_preconditioner(A, N_DEV, 10)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.sharded_amg_preconditioner(A, 3, n_pad)


# ---- the sharded FSAI -------------------------------------------------------------------------

@pytest.mark.parametrize("power", [1, 2])
def test_sharded_fsai_apply_matches_host_factor(power):
    a = _csr(poisson2d_coo(40))
    A = CSRMatrix.from_scipy(a, device=CPU)
    n = a.shape[0]
    _, _, n_pad = _partition(a)
    pre = tpar.sharded_fsai_preconditioner(A, N_DEV, n_pad, power=power, dtype=F64)
    M = fsai_preconditioner(A, power=power, dtype=F64)
    assert pre.nnz == M.nnz
    r = np.zeros(n_pad)
    r[:n] = np.random.default_rng(0).standard_normal(n)
    got = _apply(pre, torch.tensor(r)).numpy()
    want = M.G_host.T @ (M.G_host @ r[:n])
    np.testing.assert_allclose(got[:n], want, rtol=1e-11, atol=1e-13 * np.abs(want).max())
    assert np.abs(got[n:]).max(initial=0.0) == 0.0


def test_sharded_fsai_apply_scattered_pattern():
    a = _csr(powerlaw_spd_coo(3000, seed=3))
    A = CSRMatrix.from_scipy(a, device=CPU)
    n = a.shape[0]
    _, _, n_pad = _partition(a)
    pre = tpar.sharded_fsai_preconditioner(A, N_DEV, n_pad, dtype=F64)
    M = fsai_preconditioner(A, dtype=F64)
    r = np.zeros(n_pad)
    r[:n] = np.random.default_rng(1).standard_normal(n)
    want = M.G_host.T @ (M.G_host @ r[:n])
    np.testing.assert_allclose(_apply(pre, torch.tensor(r)).numpy()[:n], want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_sharded_fsai_pcg_matches_one_card_iterations():
    a = _csr(poisson2d_coo(40))
    A = CSRMatrix.from_scipy(a, device=CPU)
    n = a.shape[0]
    blocks, bcols, n_pad = _partition(a)
    b = torch.zeros(n_pad, dtype=F64)
    b[:n] = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    tol = 1e-9 * float(b.norm())
    x1, i1 = cg_solve(A, b[:n], tol=tol, M=fsai_preconditioner(A, dtype=F64))
    g = tpar.make_row_mesh(N_DEV, CPU)
    pre = tpar.sharded_fsai_preconditioner(A, N_DEV, n_pad, dtype=F64)
    x2, i2 = tpar.sharded_cg_solve(blocks, bcols, b, mesh=g, tol=tol, M_local=pre,
                                   use_fused="never")
    assert bool(i2.converged) and int(i2.iterations) == int(i1.iterations)
    np.testing.assert_allclose(x2[:n].numpy(), x1.numpy(), rtol=1e-8, atol=1e-10)
    _, plain = tpar.sharded_cg_solve(blocks, bcols, b, mesh=g, tol=tol, use_fused="never")
    assert int(i2.iterations) < int(plain.iterations)
    assert g.counts["all_gather"] > 2 * int(i2.iterations)  # two a preconditioner apply


def test_sharded_fsai_geometry_validation():
    A = CSRMatrix.from_scipy(_csr(poisson2d_coo(8)), device=CPU)
    with pytest.raises(ValueError, match="n_padded"):
        tpar.sharded_fsai_preconditioner(A, N_DEV, 10)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.sharded_fsai_preconditioner(A, 3, 64)


# ---- the sharded LOBPCG -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poisson20():
    a = _csr(poisson2d_coo(20))
    blocks, bcols, n_pad = _partition(a)
    return a, blocks, bcols, a.shape[0], n_pad, np.linalg.eigvalsh(a.toarray())


def test_lobpcg_smallest_and_largest_match_dense(poisson20):
    a, blocks, bcols, n, n_pad, w = poisson20
    g = tpar.make_row_mesh(N_DEV, CPU)
    assert n_pad > n  # the mask keeps the zero-padded rows out of the spectrum
    res = tpar.sharded_lobpcg_eigs(blocks, bcols, k=4, n=n, mesh=g, tol=1e-9, maxiter=400)
    assert np.all(res.converged)
    np.testing.assert_allclose(res.values, w[:4], rtol=1e-8)
    X = res.vectors.numpy()
    assert X.shape == (n_pad, 4) and np.all(X[n:] == 0.0)
    rn = np.linalg.norm(a @ X[:n] - X[:n] * res.values[None, :], axis=0)
    np.testing.assert_allclose(res.residuals, rn, rtol=1e-6, atol=1e-12)
    top = tpar.sharded_lobpcg_eigs(blocks, bcols, k=3, n=n, mesh=g, which="largest", tol=1e-9,
                                   maxiter=400)
    assert np.all(top.converged)
    np.testing.assert_allclose(top.values, w[-3:][::-1], rtol=1e-8)


def test_lobpcg_matches_jax_sharded_and_one_card(poisson20):
    """From the same X0 (drawn from the seed as the JAX function draws it),
    the JAX sharded LOBPCG's eigenvalues to 1e-10, and the one-card
    LOBPCG's (a Householder QR, not CholQR²) to 1e-9."""
    a, blocks, bcols, n, n_pad, w = poisson20
    res = tpar.sharded_lobpcg_eigs(blocks, bcols, k=4, n=n, mesh=tpar.make_row_mesh(N_DEV, CPU),
                                   tol=1e-9, maxiter=400, seed=7)
    jres = jpar.sharded_lobpcg_eigs(jnp.asarray(blocks), jnp.asarray(bcols), k=4, n=n, tol=1e-9,
                                    maxiter=400, seed=7)
    np.testing.assert_allclose(res.values, jres.values, rtol=1e-10)
    assert abs(res.iters - jres.iters) <= 3
    X0 = np.random.default_rng(7).standard_normal((n, 4))
    one = lobpcg_eigs(CSRMatrix.from_scipy(a, device=CPU), k=4, X0=torch.tensor(X0), tol=1e-9,
                      maxiter=400)
    X0p = np.zeros((n_pad, 4))
    X0p[:n] = X0
    sh = tpar.sharded_lobpcg_eigs(blocks, bcols, k=4, n=n, mesh=tpar.make_row_mesh(N_DEV, CPU),
                                  X0=torch.tensor(X0p), tol=1e-9, maxiter=400)
    np.testing.assert_allclose(sh.values, one.values, rtol=1e-9)
    np.testing.assert_allclose(sh.values, w[:4], rtol=1e-8)


def test_lobpcg_preconditioners_cut_iterations(poisson20):
    """A per-shard Jacobi callable on a badly scaled operator, and the
    sharded AMG (a collective ShardedPreconditioner) on Poisson."""
    a, blocks, bcols, n, n_pad, w = poisson20
    g = tpar.make_row_mesh(N_DEV, CPU)
    s = np.exp(np.random.default_rng(9).uniform(-1.5, 1.5, n))
    sa = (sp.diags(s) @ a @ sp.diags(s)).tocsr()
    sa.sort_indices()
    sb, sc, _ = _partition(sa)
    ws = np.linalg.eigvalsh(sa.toarray())
    inv = np.ones(n_pad)
    inv[:n] = 1.0 / sa.diagonal()
    m = n_pad // N_DEV
    inv_local = torch.tensor(inv).reshape(N_DEV, m)
    calls = []

    def m_local(r_local):  # the owned shard's Jacobi, found by its length and order
        i = len(calls) % N_DEV
        calls.append(i)
        return inv_local[i] * r_local

    plain = tpar.sharded_lobpcg_eigs(sb, sc, k=4, n=n, mesh=g, tol=1e-8, maxiter=800)
    pre = tpar.sharded_lobpcg_eigs(sb, sc, k=4, n=n, mesh=g, M_local=m_local, tol=1e-8,
                                   maxiter=800)
    assert np.all(pre.converged)
    np.testing.assert_allclose(pre.values, ws[:4], rtol=1e-6)
    assert pre.iters < plain.iters, (pre.iters, plain.iters)
    A = CSRMatrix.from_scipy(a, device=CPU)
    M = tpar.sharded_amg_preconditioner(A, N_DEV, n_pad, dtype=F64)
    plain = tpar.sharded_lobpcg_eigs(blocks, bcols, k=3, n=n, mesh=g, tol=1e-8, maxiter=600,
                                     seed=2)
    pre = tpar.sharded_lobpcg_eigs(blocks, bcols, k=3, n=n, mesh=g, M_local=M, tol=1e-8,
                                   maxiter=600, seed=2)
    assert np.all(pre.converged)
    np.testing.assert_allclose(pre.values, w[:3], rtol=1e-7)
    assert pre.iters < plain.iters, (pre.iters, plain.iters)


def test_lobpcg_deterministic_and_guards(poisson20):
    a, blocks, bcols, n, n_pad, w = poisson20
    g = tpar.make_row_mesh(N_DEV, CPU)
    r1 = tpar.sharded_lobpcg_eigs(blocks, bcols, k=3, n=n, mesh=g, tol=1e-8, maxiter=200, seed=5)
    r2 = tpar.sharded_lobpcg_eigs(blocks, bcols, k=3, n=n, mesh=g, tol=1e-8, maxiter=200, seed=5)
    assert r1.iters == r2.iters
    np.testing.assert_array_equal(r1.values, r2.values)
    _bits(r1.vectors, r2.vectors)
    for kw, match in ((dict(k=2, which="middle"), "which"), (dict(k=0), "k >= 1"),
                      (dict(k=2, n=5), r"3k <= n"),
                      (dict(k=2, X0=np.zeros((n_pad, 3))), "X0 must have shape"),
                      (dict(k=2, maxiter=0), "maxiter")):
        kw.setdefault("n", n)
        with pytest.raises(ValueError, match=match):
            tpar.sharded_lobpcg_eigs(blocks, bcols, mesh=g, **kw)


# ---- torch.distributed: the sharded multigrid apply over two gloo processes ----------------

WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from conjugategradient_tpu_torch.parallel import (DistributedGroup, make_row_mesh,
                                                      sharded_multigrid_preconditioner)

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    shape = (32, 16, 8)
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(int(np.prod(shape))))
    m = r.shape[0] // 2
    pre = sharded_multigrid_preconditioner(shape, 2, dtype=torch.float64, agglomerate_below=1)
    cases = {"dist": pre.make_local_apply([], DistributedGroup(device="cpu"))(
        [r[rank * m:(rank + 1) * m]])[0]}
    if rank == 0:
        cases["inproc"] = torch.cat(pre.make_local_apply([], make_row_mesh(2, "cpu"))(
            [r[:m], r[m:]]))
    torch.save(cases, f"{out}.{rank}")
    dist.destroy_process_group()
''')


def test_gloo_two_processes_mg_apply_bit_equal_to_in_process(tmp_path):
    """Two processes over gloo, one x-slab each, give the in-process
    group's V-cycle bit for bit (the agglomerated tail computed by each
    process alone, shared by the in-process shards).  The workers run with
    their own 120 s timeout, so they can never hang the suite."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    store, out = tmp_path / "store", tmp_path / "out.pt"
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(store), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    r0, r1 = torch.load(f"{out}.0"), torch.load(f"{out}.1")
    _bits(torch.cat([r0["dist"], r1["dist"]]), r0["inproc"])
