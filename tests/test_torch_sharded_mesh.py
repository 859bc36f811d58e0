"""The port's 2-D block decomposition and its multi-RHS sharded solves
(``make_mesh_2d``, ``partition_csr_blocks_2d``, ``sharded_cg_solve_2d``,
``sharded_cg_solve_2d_batched``, ``sharded_{,dia_,sell_}cg_solve_batched``)
against the JAX package's, on the CPU: the JAX side on the 8 virtual
devices tests/conftest.py sets up (its 2-D mesh on the first four), the
port on ``make_mesh_2d(2, "cpu")`` and ``make_row_mesh(8, "cpu")``, both fed
the same numpy arrays made from a seed.

Tolerances, with their reasons: float64 throughout.  The partitioner is
bit-equal.  Each solve takes the JAX iteration count exactly (per lane),
and ``rho_history`` agrees to 1e-10 relative plus 1e-16 of its first entry
(the bar of tests/test_torch_sharded_layouts.py: the packages sum the shards' partials and the tile products
in other orders).  Block CG's histories are held to 1e-8 (its (R, R)
pseudo-solves go through ``eigh``, whose rounding differs between the two
libraries), and the scattered power-law SELL operator by counts and true
residuals only (its CG amplifies any summation-order difference a hundredfold
a step; tests/test_torch_sharded_state.py).  The group's counters hold the
JAX collective pattern of the 2-D loop: a transpose exchange and a
block-row sum a product, two dot sums, no all_gather.  A four-process gloo
run of a p = 2 2-D solve is bit-equal to the in-process grid.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu.parallel as jpar
import conjugategradient_tpu_torch.parallel as tpar
from conjugategradient_tpu_torch import (CSRMatrix, DIAMatrix, block_cg_solve,
                                         cg_solve_batched)
from conjugategradient_tpu_torch.problems import (banded_spd_coo, convection_diffusion_2d_coo,
                                                  poisson2d_coo, powerlaw_spd_coo,
                                                  reference_rhs)

N_DEV = 8
CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-10
FLOOR = 1e-16


def _csr(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


def _hist_close(got, want, k, rtol=RTOL):
    got, want = np.asarray(got)[:k + 1], np.asarray(want)[:k + 1]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=FLOOR * abs(want[0]))


def _lanes(n_pad, n, R, seed):
    B = np.zeros((R, n_pad))
    B[:, :n] = np.random.default_rng(seed).standard_normal((R, n))
    return B


# ---- the 2-D partitioner --------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("coo", [poisson2d_coo(10, 12), banded_spd_coo(100, bandwidth=9, seed=3)],
                         ids=["poisson10x12", "banded100"])
def test_partition_csr_blocks_2d_bitwise(coo, p):
    a = _csr(coo)
    args = (a.data, a.indices, a.indptr, a.shape, p)
    got = tpar.partition_csr_blocks_2d(*args, bm=8, bn=8)
    want = jpar.partition_csr_blocks_2d(*args, bm=8, bn=8)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("shape,bm,bn,match", [((2, 3), 128, 128, "square"),
                                               ((2, 2), 8, 16, "square tiles")])
def test_partition_csr_blocks_2d_refusals(shape, bm, bn, match):
    args = (np.ones(1), np.zeros(1, np.int64), np.array([0, 1, 1]), shape, 2)
    with pytest.raises(ValueError, match=match):
        tpar.partition_csr_blocks_2d(*args, bm=bm, bn=bn)
    with pytest.raises(ValueError, match=match):
        jpar.partition_csr_blocks_2d(*args, bm=bm, bn=bn)


# ---- the 2-D solve ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid14():
    a = _csr(poisson2d_coo(14))
    blocks, bcols, n_pad = tpar.partition_csr_blocks_2d(a.data, a.indices, a.indptr, a.shape, 2,
                                                        bm=8, bn=8)
    n = a.shape[0]
    b = np.zeros(n_pad)
    b[:n] = reference_rhs(n)
    inv = np.ones(n_pad)
    inv[:n] = 1.0 / a.diagonal()
    return a, blocks, bcols, b, inv


METHODS_2D = {
    "standard": {},
    "jacobi": {"inv_diag": True},
    "restart": {"recompute_r_every": 10},
    "pipelined": {"method": "pipelined"},
    "sstep": {"method": "sstep", "s": 1},
    "minres": {"method": "minres"},
    "bicgstab": {"method": "bicgstab"},
    "gmres": {"method": "gmres", "gmres_restart": 20},
}


@pytest.mark.parametrize("name", list(METHODS_2D))
def test_2d_matches_jax(grid14, name):
    """Every method of the core on the 2-D grid (BiCGStab and GMRES on a
    nonsymmetric system, to 1e-8 ||b||), against the JAX 2-D solve."""
    a, blocks, bcols, b, inv = grid14
    tol = 1e-10
    if name in ("bicgstab", "gmres"):
        a = _csr(convection_diffusion_2d_coo(14, peclet=10.0))
        blocks, bcols, n_pad = tpar.partition_csr_blocks_2d(a.data, a.indices, a.indptr,
                                                            a.shape, 2, bm=8, bn=8)
        b = np.zeros(n_pad)
        b[:a.shape[0]] = reference_rhs(a.shape[0])
        tol = 1e-8 * np.linalg.norm(b)
    n = a.shape[0]
    kw = dict(METHODS_2D[name])
    if kw.pop("inv_diag", False):
        kw["inv_diag"] = inv
    g = tpar.make_mesh_2d(2, CPU)
    x, info = tpar.sharded_cg_solve_2d(blocks, bcols, torch.tensor(b), mesh=g, tol=tol,
                                       maxiter=n + 1, **kw)
    jkw = {k: (jnp.asarray(v) if k == "inv_diag" else v) for k, v in kw.items()}
    jx, jinfo = jpar.sharded_cg_solve_2d(jnp.asarray(blocks), jnp.asarray(bcols),
                                         jnp.asarray(b), mesh=jpar.make_mesh_2d(2), tol=tol,
                                         maxiter=n + 1, **jkw)
    k = int(jinfo.iterations)
    assert int(info.iterations) == k and bool(info.converged) == bool(jinfo.converged)
    _hist_close(info.rho_history, jinfo.rho_history, k)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-8 * abs(jx).max())
    assert g.counts["all_gather"] == 0


def test_2d_matches_the_1d_solve_and_the_one_card_solve(grid14):
    """The p x p grid takes the 1-D row-sharded solve's count on the same
    system, and the one-card CG's."""
    from conjugategradient_tpu_torch import cg_solve

    a, blocks, bcols, b, inv = grid14
    n = a.shape[0]
    x, info = tpar.sharded_cg_solve_2d(blocks, bcols, torch.tensor(b),
                                       mesh=tpar.make_mesh_2d(2, CPU), tol=1e-10, maxiter=n + 1)
    rb, rc, n_pad = tpar.partition_csr_rows(a.data, a.indices, a.indptr, a.shape, 2, bm=8, bn=8)
    x1, i1 = tpar.sharded_cg_solve(rb, rc, torch.tensor(b[:n_pad]),
                                   mesh=tpar.make_row_mesh(2, CPU), tol=1e-10, maxiter=n + 1)
    A = CSRMatrix.from_scipy(a, device=CPU)
    x0, i0 = cg_solve(A, torch.tensor(b[:n]), tol=1e-10)
    assert int(info.iterations) == int(i1.iterations) == int(i0.iterations)
    np.testing.assert_allclose(x[:n].numpy(), x0.numpy(), rtol=0, atol=1e-9 * x0.abs().max())


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_2d_collectives_per_iteration(grid14, batched):
    """The 2-D loop's JAX collective pattern (tests/test_collective_counts.py:
    250, 330), read off the group's counters: an iteration adds one
    transpose exchange and one block-row sum (the product) and two dot
    sums, and the whole solve no all_gather."""
    a, blocks, bcols, b, inv = grid14

    def counts(steps):
        g = tpar.make_mesh_2d(2, CPU)
        if batched:
            B = np.stack([b, 2.0 * b, np.roll(b, 1)])
            tpar.sharded_cg_solve_2d_batched(blocks, bcols, torch.tensor(B), mesh=g, tol=0.0,
                                             maxiter=steps)
        else:
            tpar.sharded_cg_solve_2d(blocks, bcols, torch.tensor(b), mesh=g, tol=0.0,
                                     maxiter=steps)
        return g.counts

    c4, c5 = counts(4), counts(5)
    step = {kind: c5.get(kind, 0) - c4.get(kind, 0) for kind in c5}
    assert step == {"all_gather": 0, "psum": 2, "transpose": 1, "col_sum": 1, "assemble": 0}
    assert c5["all_gather"] == 0 and c5["assemble"] == 1


def test_2d_refusals(grid14):
    a, blocks, bcols, b, inv = grid14
    with pytest.raises(ValueError, match="2-D group"):
        tpar.sharded_cg_solve_2d(blocks, bcols, torch.tensor(b),
                                 mesh=tpar.make_row_mesh(2, CPU))
    with pytest.raises(ValueError, match="grid"):
        tpar.sharded_cg_solve_2d(blocks, bcols, torch.tensor(b), mesh=tpar.make_mesh_2d(3, CPU))
    with pytest.raises(ValueError, match="deflated"):
        from conjugategradient_tpu_torch.parallel.sharded_cg import _grid_matvec, _sharded_solve

        g = tpar.make_mesh_2d(2, CPU)
        _sharded_solve("bell2d", (blocks, bcols), torch.tensor(b), mesh=g, tol=0.0,
                       maxiter=3, inv_diag=None, make_local_matvec=_grid_matvec(8),
                       basis=object(), supports_basis=False)


# ---- the 2-D multi-RHS solve --------------------------------------------------------------

@pytest.fixture(scope="module")
def grid16_lanes():
    a = _csr(poisson2d_coo(16))
    blocks, bcols, n_pad = tpar.partition_csr_blocks_2d(a.data, a.indices, a.indptr, a.shape, 2,
                                                        bm=8, bn=8)
    return a, blocks, bcols, _lanes(n_pad, a.shape[0], 3, 11)


@pytest.mark.parametrize("method", ["lockstep", "block"])
def test_2d_batched_matches_jax_and_the_one_card_loops(grid16_lanes, method):
    a, blocks, bcols, B = grid16_lanes
    n = a.shape[0]
    X, info = tpar.sharded_cg_solve_2d_batched(blocks, bcols, torch.tensor(B),
                                               mesh=tpar.make_mesh_2d(2, CPU), tol=1e-10,
                                               maxiter=n + 1, method=method)
    JX, jinfo = jpar.sharded_cg_solve_2d_batched(jnp.asarray(blocks), jnp.asarray(bcols),
                                                 jnp.asarray(B), mesh=jpar.make_mesh_2d(2),
                                                 tol=1e-10, maxiter=n + 1, method=method)
    A = CSRMatrix.from_scipy(a, device=CPU)
    one = cg_solve_batched if method == "lockstep" else block_cg_solve
    from conjugategradient_tpu_torch import BlockedEllMatrix

    _, i1 = one(BlockedEllMatrix.from_csr(A, bm=8, bn=8), torch.tensor(B[:, :n]), tol=1e-10,
                maxiter=n + 1)
    for i in range(B.shape[0]):
        k = int(jinfo.iterations[i])
        assert int(info.iterations[i]) == k == int(i1.iterations[i]), i
        _hist_close(info.rho_history[i], jinfo.rho_history[i], k,
                    RTOL if method == "lockstep" else 1e-8)
        np.testing.assert_allclose(X[i].numpy(), np.asarray(JX[i]), rtol=0,
                                   atol=1e-8 * abs(np.asarray(JX[i])).max())


def test_2d_batched_per_lane_tol_and_jacobi():
    a = _csr(poisson2d_coo(12))
    n = a.shape[0]
    blocks, bcols, n_pad = tpar.partition_csr_blocks_2d(a.data, a.indices, a.indptr, a.shape, 2,
                                                        bm=8, bn=8)
    B = _lanes(n_pad, n, 3, 11)
    inv = np.ones(n_pad)
    inv[:n] = 1.0 / a.diagonal()
    tols = np.array([1e-4, 1e-7, 1e-10])
    X, info = tpar.sharded_cg_solve_2d_batched(blocks, bcols, torch.tensor(B),
                                               mesh=tpar.make_mesh_2d(2, CPU),
                                               tol=torch.tensor(tols), maxiter=n + 1,
                                               inv_diag=torch.tensor(inv))
    _, jinfo = jpar.sharded_cg_solve_2d_batched(
        jnp.asarray(blocks), jnp.asarray(bcols), jnp.asarray(B), mesh=jpar.make_mesh_2d(2),
        tol=jnp.asarray(tols), maxiter=n + 1, inv_diag=jnp.asarray(inv))
    assert bool(info.converged.all())
    its = info.iterations.numpy()
    assert its[0] <= its[1] <= its[2]
    assert list(its) == [int(v) for v in np.asarray(jinfo.iterations)]
    for i in range(3):
        r = B[i, :n] - a @ X[i, :n].numpy()
        assert np.linalg.norm(r) <= 5 * tols[i]


# ---- the 1-D multi-RHS solves -------------------------------------------------------------

@pytest.fixture(scope="module")
def layouts():
    """The three layouts' partitions and the one-card operators, float64."""
    pa = _csr(poisson2d_coo(16))
    blocks, bcols, n_pad = tpar.partition_csr_rows(pa.data, pa.indices, pa.indptr, pa.shape,
                                                   N_DEV, bm=8, bn=8)
    bell = ((blocks, bcols), pa, n_pad)
    da = _csr(banded_spd_coo(280, bandwidth=6, seed=21))
    dia = DIAMatrix.from_csr(CSRMatrix.from_scipy(da, device=CPU))
    diags_sh, dn_pad = tpar.partition_dia_rows(dia.diags.numpy(), da.shape, N_DEV)
    dia_case = ((diags_sh, dia.offsets), da, dn_pad)
    sa = _csr(powerlaw_spd_coo(400, avg_degree=4.0, seed=7))
    sell_sh = tpar.partition_sell_rows(sa.data, sa.indices, sa.indptr, sa.shape, N_DEV)
    sell = ((sell_sh,), sa, sell_sh[-1])
    return {"bell": bell, "dia": dia_case, "sell": sell}


FRONT = {"bell": ("sharded_cg_solve_batched", 2), "dia": ("sharded_dia_cg_solve_batched", 2),
         "sell": ("sharded_sell_cg_solve_batched", 1)}


def _both(layout, case, B, **kw):
    """The port's and the JAX package's batched solve of one layout."""
    ops, a, n_pad = case
    name, _ = FRONT[layout]
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = getattr(tpar, name)(*ops, torch.tensor(B), mesh=tpar.make_row_mesh(N_DEV, CPU), **tkw)
    jops = tuple(jnp.asarray(o) if isinstance(o, np.ndarray) else o for o in ops)
    want = getattr(jpar, name)(*jops, jnp.asarray(B), **jkw)
    return got, want


@pytest.mark.parametrize("method", ["lockstep", "block"])
@pytest.mark.parametrize("layout", ["bell", "dia", "sell"])
def test_batched_matches_jax(layouts, layout, method):
    case = layouts[layout]
    ops, a, n_pad = case
    n = a.shape[0]
    R = 2 if layout == "sell" else 3
    B = _lanes(n_pad, n, R, 5)
    kw = dict(tol=1e-9, maxiter=n + 1, method=method)
    if layout == "sell":
        inv = np.ones(n_pad)
        inv[:n] = 1.0 / a.diagonal()
        kw.update(inv_diag=inv, recompute_r_every=11)
        if method == "lockstep":
            kw["tol"] = np.array([1e-9, 1e-4])
    (X, info), (JX, jinfo) = _both(layout, case, B, **kw)
    assert tuple(X.shape) == (R, n_pad) and bool(info.converged.all())
    tols = np.broadcast_to(np.asarray(kw["tol"]), (R,))
    for i in range(R):
        k = int(jinfo.iterations[i])
        assert int(info.iterations[i]) == k, i
        r = B[i, :n] - a @ X[i, :n].numpy()
        assert np.linalg.norm(r) <= 1.05 * tols[i]
        if layout != "sell":
            _hist_close(info.rho_history[i], jinfo.rho_history[i], k,
                        RTOL if method == "lockstep" else 1e-8)


@pytest.mark.parametrize("method", ["lockstep", "block"])
@pytest.mark.parametrize("layout", ["bell", "dia"])
def test_batched_matches_the_one_card_loops(layouts, layout, method):
    """The sharded lanes take the port's one-card lockstep and block CG
    counts on the same operator, lane by lane."""
    ops, a, n_pad = layouts[layout]
    n = a.shape[0]
    B = _lanes(n_pad, n, 3, 6)
    name, _ = FRONT[layout]
    X, info = getattr(tpar, name)(*ops, torch.tensor(B), mesh=tpar.make_row_mesh(N_DEV, CPU),
                                  tol=1e-10, maxiter=n + 1, method=method)
    A = CSRMatrix.from_scipy(a, device=CPU)
    op = DIAMatrix.from_csr(A) if layout == "dia" else A
    one = cg_solve_batched if method == "lockstep" else block_cg_solve
    X1, i1 = one(op, torch.tensor(B[:, :n]), tol=1e-10, maxiter=n + 1)
    for i in range(3):
        assert int(info.iterations[i]) == int(i1.iterations[i]), i
        np.testing.assert_allclose(X[i, :n].numpy(), X1[i].numpy(), rtol=0,
                                   atol=1e-8 * X1[i].abs().max())
    if method == "block":
        _, il = cg_solve_batched(op, torch.tensor(B[:, :n]), tol=1e-10, maxiter=n + 1)
        assert int(info.iterations.max()) < int(il.iterations.max())


def test_batched_restart_matches_solo_restart(layouts):
    """Lane-masked restarts: each lane's count and history are a solo
    sharded solve's with the same restart interval, lanes freezing at
    different iterations."""
    (blocks, bcols), a, n_pad = layouts["bell"]
    n = a.shape[0]
    B = _lanes(n_pad, n, 3, 7)
    B[1] *= 100.0
    g = tpar.make_row_mesh(N_DEV, CPU)
    X, info = tpar.sharded_cg_solve_batched(blocks, bcols, torch.tensor(B), mesh=g, tol=1e-9,
                                            maxiter=n + 1, recompute_r_every=6)
    for i in range(3):
        x_i, info_i = tpar.sharded_cg_solve(blocks, bcols, torch.tensor(B[i]), mesh=g, tol=1e-9,
                                            maxiter=n + 1, recompute_r_every=6)
        k = int(info_i.iterations)
        assert int(info.iterations[i]) == k
        _hist_close(info.rho_history[i], info_i.rho_history, k)
        np.testing.assert_allclose(X[i].numpy(), x_i.numpy(), rtol=0,
                                   atol=1e-9 * x_i.abs().max())
    assert len(set(info.iterations.tolist())) > 1


def test_batched_refusals(layouts):
    (blocks, bcols), a, n_pad = layouts["bell"]
    g = tpar.make_row_mesh(N_DEV, CPU)
    B = torch.zeros(3, n_pad, dtype=torch.float64)
    with pytest.raises(ValueError, match="per-lane tol has length 2, expected 3"):
        tpar.sharded_cg_solve_batched(blocks, bcols, B, mesh=g, tol=torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError, match="lockstep' or 'block'"):
        tpar.sharded_cg_solve_batched(blocks, bcols, B, mesh=g, method="minres")
    with pytest.raises(ValueError, match=r"B must be \(nrhs, n_padded\)"):
        tpar.sharded_cg_solve_batched(blocks, bcols, B[0], mesh=g)


# ---- torch.distributed: a p = 2 2-D solve over four gloo processes -------------------------

WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from conjugategradient_tpu_torch.parallel import (DistributedGroup, make_mesh_2d,
                                                      partition_csr_blocks_2d,
                                                      sharded_cg_solve_2d,
                                                      sharded_cg_solve_2d_batched)
    from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    rows, cols, vals, shape = poisson2d_coo(14)
    a = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)), shape=shape)
    a.sort_indices()
    blocks, bcols, n_pad = partition_csr_blocks_2d(a.data, a.indices, a.indptr, shape, 2,
                                                   bm=8, bn=8)
    b = np.zeros(n_pad)
    b[:shape[0]] = reference_rhs(shape[0])
    B = torch.tensor(np.stack([b, np.roll(b, 3)]))
    cases = {}
    for key in ("dist", "inproc"):
        if key == "inproc" and rank:
            continue
        g = DistributedGroup.mesh_2d(2, device="cpu") if key == "dist" else make_mesh_2d(2, "cpu")
        x, info = sharded_cg_solve_2d(blocks, bcols, torch.tensor(b), mesh=g, tol=1e-10)
        X, binfo = sharded_cg_solve_2d_batched(blocks, bcols, B, mesh=g, tol=1e-10,
                                               method="block")
        cases[key] = (x, info.rho_history, info.iterations, X, binfo.rho_history,
                      binfo.iterations, dict(g.counts))
    torch.save(cases, f"{out}.{rank}")
    dist.destroy_process_group()
''')


def test_gloo_four_processes_2d_bit_equal_to_in_process(tmp_path):
    """Four processes over gloo (a FileStore under tmp_path), rank i·2 + j
    holding block (i, j), give the bits of ``make_mesh_2d(2, "cpu")`` for a
    2-D CG and a 2-D block-CG solve; every rank ends with the whole x.  The
    workers run with their own 120 s timeout, so they can never hang the
    suite."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    store, out = tmp_path / "store", tmp_path / "out.pt"
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(store), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [torch.load(f"{out}.{r}") for r in range(4)]
    inproc = ranks[0]["inproc"]
    assert int(inproc[2]) > 10
    for r, cases in enumerate(ranks):
        got = cases["dist"]
        for i in (0, 1, 3, 4):
            assert torch.equal(got[i].contiguous().view(torch.uint8),
                               inproc[i].contiguous().view(torch.uint8)), (r, i)
        assert int(got[2]) == int(inproc[2]) and torch.equal(got[5], inproc[5])
        counts = got[6]
        assert counts["all_gather"] == 0 and counts["transpose"] == counts["col_sum"] > 0


def test_chip_smoke_grid_split_is_the_partitioner():
    """chip_smoke.grid_split (the 2-D grid of the block-tridiagonal tiles,
    built on their device) is partition_csr_blocks_2d of the same
    operator, tile for tile."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from conjugategradient_tpu_torch.problems import block_tridiag_tiles

    blocks, cols, _ = block_tridiag_tiles(96, 8, 8, seed=0)
    nrb = blocks.shape[0]
    dense = np.zeros((96, 96), np.float32)
    for r in range(nrb):
        for k in range(3):
            c = cols[r, k]
            if blocks[r, k].any():
                dense[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = blocks[r, k]
    a = sp.csr_matrix(dense)
    want = tpar.partition_csr_blocks_2d(a.data, a.indices, a.indptr, a.shape, 2, bm=8, bn=8)
    got = chip_smoke.grid_split(torch.from_numpy(blocks), torch.from_numpy(cols), 2)
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
