"""The port's row-sharded layouts and methods (``conjugategradient_tpu_torch
.parallel``: the symmetric blocked-ELL, DIA, symmetric DIA and SELL front
ends, and every method of the one solve core on every 1-D layout) against
the JAX package's sharded solves, on the CPU: the JAX side on the 8 virtual
devices tests/conftest.py sets up, the port on ``make_row_mesh(8, "cpu")``,
both fed the same numpy arrays made from a seed.

Tolerances, with their reasons: float64 throughout; each solve takes the
JAX iteration count exactly, ``rho_history`` agrees to 1e-10 relative plus
1e-16 of its first entry, and x to 1e-10 of max|x|.  The two packages sum
the shards' partials and the tile products in other orders, so their
recurrences part at roundoff: up to 2e-20 of the first entry measured,
which is more than 1e-10 relative only once ‖r‖² has fallen below ~1e-10
of its start.  The partitioners are
bit-equal.  A two-process gloo run of the ring halo and of one DIA solve is
bit-equal to the in-process group.
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

import conjugategradient_tpu as jcg
import conjugategradient_tpu.parallel as jpar
import conjugategradient_tpu_torch.parallel as tpar
from conjugategradient_tpu_torch import DIAMatrix, SymDIAMatrix
from conjugategradient_tpu_torch import CSRMatrix as TCSR
from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo, poisson2d_coo
from conjugategradient_tpu_torch.solver.deflated import DeflationBasis

N_DEV = 8
ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-10
#: the recurrences' roundoff floor, relative to the first history entry
FLOOR = 1e-16


def _csr(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


SPD = _csr(poisson2d_coo(10, 12))  # 120 rows: 16 a shard of 8 (bell), 15 (sell)
BAND = _csr(poisson2d_coo(60, 4))  # 240 rows, offsets ±1, ±4: 30 a shard
NONSYM = _csr(convection_diffusion_2d_coo(8, peclet=10.0))  # 64 rows, offsets ±1, ±8


def _rhs(n_pad, n, seed):
    b = np.zeros(n_pad)
    b[:n] = np.random.default_rng(seed).standard_normal(n)
    return b


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# ---- the partitioners --------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("a", [SPD, BAND], ids=["poisson10x12", "poisson60x4"])
def test_partition_symbell_rows_bitwise(a, n_shards):
    args = (a.data, a.indices, a.indptr, a.shape, n_shards)
    got = tpar.partition_symbell_rows(*args, bn=8)
    want = jpar.partition_symbell_rows(*args, bn=8)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        _bitwise(g, w)


def test_partition_symbell_saves_storage():
    """tests/test_sharded.py:812: the symmetric shards hold fewer tile
    elements than the full ones."""
    a = _csr(poisson2d_coo(20))
    diag, off, _, cross, _, _, _ = tpar.partition_symbell_rows(
        a.data, a.indices, a.indptr, a.shape, N_DEV, bn=8)
    blocks, _, _ = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                           bm=8, bn=8)
    assert diag.size + off.size + cross.size < blocks.size


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("a", [SPD, NONSYM], ids=["poisson10x12", "convdiff8"])
def test_partition_sell_rows_bitwise(a, n_shards):
    args = (a.data, a.indices, a.indptr, a.shape, n_shards)
    got = tpar.partition_sell_rows(*args)
    want = jpar.partition_sell_rows(*args)
    assert got[-1] == want[-1]
    assert tuple(map(tuple, got[4])) == tuple(map(tuple, want[4]))
    for g, w in zip(got[:4], want[:4]):
        _bitwise(g, w)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_partition_dia_rows_bitwise(n_shards):
    op = jcg.DIAMatrix.from_csr(jcg.CSRMatrix.from_scipy(BAND))
    diags = np.asarray(op.diags)
    got = tpar.partition_dia_rows(diags, BAND.shape, n_shards)
    want = jpar.partition_dia_rows(diags, BAND.shape, n_shards)
    assert got[1] == want[1]
    _bitwise(got[0], want[0])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_chip_smoke_symbell_split_is_the_partitioner(n_shards):
    """chip_smoke.py builds the symmetric shards of the block-tridiagonal
    operator from its tiles in place of partitioning its CSR (~100 M
    nonzeros at the full size): at n = 2048, bn = 128 the split equals
    partition_symbell_rows on the same operator's CSR, bit for bit."""
    import importlib.util

    from conjugategradient_tpu_torch.problems import block_tridiag_tiles
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    n, bn = 2048, 128
    tiles, tcols, nnz = block_tridiag_tiles(n, bn, bn, seed=0)
    got = chip_smoke.symbell_split(torch.from_numpy(tiles), torch.from_numpy(tcols), n_shards)
    dense = BlockedEllMatrix(torch.from_numpy(tiles), torch.from_numpy(tcols), (n, n),
                             nnz).to_dense().numpy()
    a = sp.csr_matrix(dense)
    want = tpar.partition_symbell_rows(a.data, a.indices, a.indptr, a.shape, n_shards, bn=bn)
    assert want[-1] == n
    for g, w in zip(got, want[:-1]):
        _bitwise(g.numpy(), w)


# ---- the ring halo -----------------------------------------------------------------------

def test_ring_halo_matches_jax():
    from jax.sharding import PartitionSpec as P

    x = np.arange(32.0) * 1.5
    mesh = jpar.make_row_mesh(jax.devices()[:4])
    f = jax.shard_map(lambda v: jpar.ring_halo(v, 3, "rows"), mesh=mesh,
                      in_specs=P("rows"), out_specs=P("rows"))
    want = np.asarray(f(jnp.asarray(x))).reshape(4, -1)
    g = tpar.make_row_mesh(4, "cpu")
    got = tpar.ring_halo([torch.tensor(v) for v in x.reshape(4, -1)], 3, g)
    for gw, ww in zip(got, want):
        assert np.array_equal(gw.numpy(), ww)
    assert g.counts["ring_halo"] == 1


def test_ring_halo_validates_width():
    g = tpar.make_row_mesh(4, "cpu")
    with pytest.raises(ValueError, match="halo width"):
        tpar.ring_halo(list(torch.arange(16.0).reshape(4, 4)), 5, g)
    with pytest.raises(ValueError, match="one tensor"):
        tpar.ring_halo(torch.arange(4.0), 1, g)


# ---- every front end x method against the JAX sharded solve ---------------------------------

def _jmesh():
    return jpar.make_row_mesh()


def _basis_pair(a, n_pad, k=4, seed=21):
    """The same deflation basis in both packages: the JAX one, copied."""
    n = a.shape[0]
    W = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, k)))[0]
    from conjugategradient_tpu.solver.deflated import deflation_basis_from_vectors

    jb = deflation_basis_from_vectors(jcg.CSRMatrix.from_scipy(a), jnp.asarray(W))
    tb = DeflationBasis(W=torch.tensor(np.asarray(jb.W)), AW=torch.tensor(np.asarray(jb.AW)),
                        E_chol=torch.tensor(np.asarray(jb.E_chol)))
    return jb, tb


def _inv_diag(a, n_pad):
    d = np.ones(n_pad)
    d[:a.shape[0]] = 1.0 / a.diagonal()
    return d


def _precond_pair(a, n_pad):
    """M_local both ways: a ShardedPreconditioner over the Jacobi scaling,
    row-sharded."""
    d = _inv_diag(a, n_pad).reshape(N_DEV, -1)
    jm = jpar.ShardedPreconditioner(op_arrays=(d,),
                                    make_local_apply=lambda arrs: (lambda r: arrs[0] * r))
    tm = tpar.ShardedPreconditioner(op_arrays=(d,),
                                    make_local_apply=lambda arrs: (lambda r: arrs[0] * r))
    return jm, tm


def _bell_ops(a):
    blocks, cols, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                                  bm=8, bn=8)
    return (blocks, cols), n_pad


def _symbell_ops(a):
    parts = tpar.partition_symbell_rows(a.data, a.indices, a.indptr, a.shape, N_DEV, bn=8)
    return parts[:-1], parts[-1]


def _dia_ops(a, symmetric=False):
    csr = TCSR.from_scipy(a, device="cpu")
    op = SymDIAMatrix.from_csr(csr) if symmetric else DIAMatrix.from_csr(csr)
    diags, n_pad = tpar.partition_dia_rows(op.diags.numpy(), a.shape, N_DEV)
    return (diags, op.offsets), n_pad


def _sell_ops(a):
    parts = tpar.partition_sell_rows(a.data, a.indices, a.indptr, a.shape, N_DEV)
    return (parts,), parts[-1]


FRONT = {
    "bell": (_bell_ops, "sharded_cg_solve"),
    "symbell": (_symbell_ops, "sharded_symbell_cg_solve"),
    "dia": (_dia_ops, "sharded_dia_cg_solve"),
    "symdia": (lambda a: _dia_ops(a, symmetric=True), "sharded_symdia_cg_solve"),
    "sell": (_sell_ops, "sharded_sell_cg_solve"),
}

# (front end, operator, method keywords, extras): extras "jacobi", "mlocal",
# "basis" add the preconditioner / deflation basis of the operator; "loose"
# stops at 1e-3·‖b‖, not 1e-8·‖b‖: BiCGStab on a symmetric system amplifies
# roundoff, and the JAX package's own sharded solves on the full and the
# symmetric storage of SPD part by 1.6e-4 relative once ‖r‖ < 1e-4·‖b‖
CASES = [
    ("bell", "spd", dict(method="pipelined"), ()),
    ("bell", "spd", dict(method="pipelined"), ("jacobi",)),
    ("bell", "spd", dict(method="pipelined", recompute_r_every=7), ("jacobi",)),
    ("bell", "spd", dict(method="sstep", s=3), ()),
    ("bell", "nonsym", dict(method="bicgstab"), ("jacobi",)),
    ("bell", "nonsym", dict(method="gmres", gmres_restart=12), ()),
    ("bell", "nonsym", dict(method="gmres", gmres_restart=12, gmres_flexible=True), ("mlocal",)),
    ("bell", "spd", dict(method="standard"), ("basis",)),
    ("bell", "spd", dict(method="standard"), ("mlocal",)),
    ("symbell", "spd", dict(method="standard"), ()),
    ("symbell", "spd", dict(method="standard"), ("jacobi",)),
    ("symbell", "spd", dict(method="pipelined"), ()),
    ("symbell", "spd", dict(method="sstep"), ()),
    ("symbell", "spd", dict(method="minres"), ()),
    ("symbell", "spd", dict(method="bicgstab"), ("loose",)),
    ("symbell", "spd", dict(method="gmres", gmres_restart=16), ()),
    ("symbell", "spd", dict(method="standard"), ("basis",)),
    ("dia", "band", dict(method="standard"), ()),
    ("dia", "band", dict(method="standard", recompute_r_every=10), ("jacobi",)),
    ("dia", "band", dict(method="pipelined"), ("jacobi",)),
    ("dia", "band", dict(method="sstep", s=4), ()),
    ("dia", "band", dict(method="minres"), ()),
    ("dia", "nonsym", dict(method="bicgstab"), ()),
    ("dia", "nonsym", dict(method="gmres", gmres_restart=10), ("jacobi",)),
    ("dia", "band", dict(method="standard"), ("basis",)),
    ("symdia", "band", dict(method="standard"), ()),
    ("symdia", "band", dict(method="standard"), ("jacobi",)),
    ("symdia", "band", dict(method="pipelined"), ()),
    ("sell", "spd", dict(method="standard"), ()),
    ("sell", "spd", dict(method="standard"), ("jacobi",)),
    ("sell", "spd", dict(method="pipelined"), ()),
    ("sell", "spd", dict(method="sstep", s=2), ()),
    ("sell", "nonsym", dict(method="bicgstab"), ()),
    ("sell", "nonsym", dict(method="gmres", gmres_restart=8), ()),
]
MATS = {"spd": SPD, "band": BAND, "nonsym": NONSYM}


def _ids(case):
    front, mat, kw, extras = case
    return "-".join([front, mat] + [f"{k}={v}" for k, v in kw.items()] + list(extras))


def _run_pair(front, mat, kw, extras):
    a = MATS[mat]
    build, name = FRONT[front]
    ops, n_pad = build(a)
    b = _rhs(n_pad, a.shape[0], seed=len(name) + len(kw))
    tol = (1e-3 if "loose" in extras else 1e-8) * np.linalg.norm(b)
    maxiter = 4 * a.shape[0]
    jkw, tkw = dict(kw), dict(kw)
    if "jacobi" in extras:
        jkw["inv_diag"] = tkw["inv_diag"] = _inv_diag(a, n_pad)
    if "mlocal" in extras:
        jkw["M_local"], tkw["M_local"] = _precond_pair(a, n_pad)
    if "basis" in extras:
        jkw["basis"], tkw["basis"] = _basis_pair(a, n_pad)
    xj, ij = getattr(jpar, name)(*ops, jnp.asarray(b), tol=tol, maxiter=maxiter, mesh=_jmesh(),
                                 **jkw)
    xt, it = getattr(tpar, name)(*ops, torch.tensor(b), tol=tol, maxiter=maxiter,
                                 mesh=tpar.make_row_mesh(N_DEV, "cpu"), **tkw)
    return a, (np.asarray(xj), ij), (xt.numpy(), it)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_front_end_method_matches_jax(case):
    a, (xj, ij), (xt, it) = _run_pair(*case)
    n = a.shape[0]
    k = int(ij.iterations)
    assert int(it.iterations) == k, (int(it.iterations), k)
    assert bool(it.converged) == bool(ij.converged)
    hj = np.asarray(ij.rho_history)[:k + 1]
    ht = it.rho_history.numpy()[:k + 1]
    assert np.array_equal(np.isnan(hj), np.isnan(ht))
    sel = np.isfinite(hj)
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=RTOL, atol=FLOOR * hj[0])
    np.testing.assert_allclose(xt[:n], xj[:n], rtol=0, atol=RTOL * np.abs(xj[:n]).max())
    np.testing.assert_allclose(float(it.rnorm_sq), float(ij.rnorm_sq), rtol=1e-8,
                               atol=1e-20 * float(hj[0]))


def test_dia_sstep_takes_the_matrix_powers_basis():
    """s·w <= rows_per_shard: one ring halo a block for the basis, not s."""
    (diags, offsets), n_pad = _dia_ops(BAND)
    b = torch.tensor(_rhs(n_pad, BAND.shape[0], seed=3))
    counts = []
    for steps in (4, 12):
        g = tpar.make_row_mesh(N_DEV, "cpu")
        tpar.sharded_dia_cg_solve(diags, offsets, b, mesh=g, method="sstep", s=4,
                                  maxiter=steps)
        counts.append(g.counts["ring_halo"])
    assert counts[1] - counts[0] == 2  # two blocks of 4, one halo each


def test_symdia_refuses_sstep_and_wide_bands():
    (diags, offsets), n_pad = _dia_ops(BAND, symmetric=True)
    b = np.ones(n_pad)
    with pytest.raises(ValueError, match="standard'/'pipelined"):
        tpar.sharded_symdia_cg_solve(diags, offsets, b, mesh=tpar.make_row_mesh(8, "cpu"),
                                     method="sstep")
    with pytest.raises(ValueError, match="bandwidth"):
        tpar.sharded_dia_cg_solve(diags[:, :, :2].copy(), offsets, b[:16],
                                  mesh=tpar.make_row_mesh(8, "cpu"))


def test_basis_refused_where_the_jax_package_refuses_it():
    jb, tb = _basis_pair(SPD, 120)
    parts, _ = _sell_ops(SPD)
    with pytest.raises(TypeError):
        tpar.sharded_sell_cg_solve(*parts, np.ones(120), basis=tb)
    ops, n_pad = _bell_ops(SPD)
    with pytest.raises(ValueError, match="standard per-shard loop"):
        tpar.sharded_cg_solve(*ops, np.ones(n_pad), mesh=tpar.make_row_mesh(8, "cpu"),
                              basis=_basis_pair(SPD, n_pad)[1], method="pipelined")


def test_axis_and_ncols_padded_are_accepted():
    ops, n_pad = _bell_ops(SPD)
    b = torch.tensor(_rhs(n_pad, SPD.shape[0], seed=5))
    g = tpar.make_row_mesh(N_DEV, "cpu")
    x1, i1 = tpar.sharded_cg_solve(*ops, b, mesh=g, tol=1e-8, maxiter=50)
    x2, i2 = tpar.sharded_cg_solve(*ops, b, mesh=g, tol=1e-8, maxiter=50, axis="rows",
                                   ncols_padded=n_pad)
    assert torch.equal(x1, x2) and int(i1.iterations) == int(i2.iterations)


def test_exports_follow_the_jax_order_and_queued_names_raise():
    """Every JAX ``parallel`` name is ported, in the JAX order, with the
    port's three group names after them; none is queued any more."""
    assert tpar.QUEUED == ()
    assert len(jpar.__all__) == 33
    assert tpar.__all__ == list(jpar.__all__) + ["DistributedGroup", "InProcessGroup",
                                                 "ShardGroup"]
    for name in tpar.__all__:
        assert hasattr(tpar, name), name
    with pytest.raises(AttributeError):
        getattr(tpar, "sharded_cg_solve_3d")


# ---- torch.distributed: the ring halo and a DIA solve over gloo ------------------------------

WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from conjugategradient_tpu_torch import CSRMatrix, DIAMatrix
    from conjugategradient_tpu_torch.parallel import (DistributedGroup, make_row_mesh,
                                                      partition_dia_rows, ring_halo,
                                                      sharded_dia_cg_solve)
    from conjugategradient_tpu_torch.problems import poisson2d_coo

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    group = DistributedGroup(device="cpu")
    v = torch.arange(12.0) + 100 * rank
    cases = {"halo": ring_halo(v, 3, group)}
    rows, cols, vals, shape = poisson2d_coo(30, 4)
    op = DIAMatrix.from_csr(CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu"))
    diags, n_pad = partition_dia_rows(op.diags.numpy(), shape, 2)
    b = np.random.default_rng(0).standard_normal(n_pad)
    for key, g in (("dist", group), ("inproc", make_row_mesh(2, "cpu"))):
        if key == "inproc" and rank:
            continue
        for method in ("standard", "sstep"):
            x, info = sharded_dia_cg_solve(diags, op.offsets, b, mesh=g, tol=1e-9,
                                           maxiter=200, method=method, s=2)
            cases[f"{key} {method}"] = (x, info.rho_history, info.iterations)
    torch.save(cases, f"{out}.{rank}")
    dist.destroy_process_group()
''')


def test_gloo_ring_halo_and_dia_solve_bit_equal_to_in_process(tmp_path):
    """Two processes, one shard each, over gloo (a FileStore under
    tmp_path): ring_halo's point-to-point messages give each rank its
    neighbour's edge rows, and the DIA solves (standard, and s-step on the
    matrix-powers basis) give the bits of InProcessGroup(2, "cpu").  The
    workers run with their own 120 s timeout, so they cannot hang the
    suite."""
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
    v0, v1 = torch.arange(12.0), torch.arange(12.0) + 100
    assert torch.equal(r0["halo"], torch.cat([torch.zeros(3), v0, v1[:3]]))
    assert torch.equal(r1["halo"], torch.cat([v0[-3:], v1, torch.zeros(3)]))
    for method in ("standard", "sstep"):
        xd, hd, kd = r0[f"dist {method}"]
        xi, hi, ki = r0[f"inproc {method}"]
        assert int(kd) == int(ki) > 3, method
        assert torch.equal(xd, xi) and torch.equal(r1[f"dist {method}"][0], xd), method
        assert torch.equal(hd.view(torch.uint8), hi.view(torch.uint8)), method
