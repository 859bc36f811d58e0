"""The port's fused row-sharded loops against the JAX package's, on the
CPU: the plain versions of kernels 6 (``bell_spmv_dot``) and 17
(``minres_shard_spmv_dot``) against the Pallas kernels in interpret mode,
the fused sharded CG, Jacobi PCG and MINRES (``use_fused="always"`` on CPU
tensors: the plain versions) against the JAX ones (``interpret=True``), the
collectives per iteration, and a two-process ``torch.distributed`` (gloo)
run against the in-process shard group.

Tolerances, with their reasons.  XLA:CPU contracts the kernels'
multiply-add pairs into FMAs where the port rounds each product and sum on
its own, and sums run in another order: so q to 2e-5 of max|q|, the dot
partials to 1e-4 relative (tests/test_fused.py's bounds for the Pallas
kernels against numpy), w and x' to 1e-6 of the largest operand (two or
three product roundings).  Whole float32 solves show trajectory parity,
not equal iteration counts (the rule for the float32 fused paths): the
histories to 1e-3 above the float32 floor over the solve (measured here:
under 1e-4), iterations within 2 and x to 1e-3 of max|x|.  The gloo run
and the in-process group compute the same shards with the same ops and
sum in the same order, so they agree bit for bit.
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

from conjugategradient_tpu.ops.pallas import fused_cg as jk_cg
from conjugategradient_tpu.ops.pallas import fused_minres as jk_mr
from conjugategradient_tpu.parallel import sharded_cg_solve as jsolve
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tk_cg
from conjugategradient_tpu_torch.ops.cuda import fused_minres as tk_mr
from conjugategradient_tpu_torch.parallel import make_row_mesh, partition_csr_rows, sharded_cg_solve
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_DEV = 8


def _csr32(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


def _shard(rng, nrb, bn, n_shards, shard):
    """One shard's tiles with GLOBAL column blocks, the gathered operand
    and the shard's row offset (ragged nrb, shard not 0)."""
    ncb = n_shards * nrb
    blocks = rng.standard_normal((nrb, 3, bn, bn)).astype(np.float32)
    cols = rng.integers(0, ncb, (nrb, 3)).astype(np.int32)
    full = rng.standard_normal((ncb, bn)).astype(np.float32)
    return blocks, cols, full, shard * nrb * bn


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# ---- kernels 6 and 17: plain versions against the Pallas kernels -------------------

@pytest.mark.parametrize("bn", [32, 128])
def test_bell_spmv_dot_plain_matches_pallas(bn):
    blocks, cols, full, off = _shard(np.random.default_rng(bn), 13, bn, 3, 2)
    qj, pj = jk_cg.bell_spmv_dot(jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(full),
                                 jnp.asarray([off], jnp.int32), interpret=True)
    qt, pt = tk_cg.bell_spmv_dot(torch.from_numpy(blocks), torch.from_numpy(cols),
                                 torch.from_numpy(full), off)
    _close(qt, qj, 2e-5)
    np.testing.assert_allclose(float(pt), float(pj[0, 0]), rtol=1e-4)


SU_CASES = {  # 1/β (unused), σ, ε̄, δ̄, 1/γ̄, φ̄
    "pending shift": (0.0, 0.07, 0.11, 0.23, 0.57, 0.83),
    "first step": (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "pending": (0.0, 0.0, -0.4, 1.3, 0.2, -0.6),
}


@pytest.mark.parametrize("case", SU_CASES)
@pytest.mark.parametrize("bn", [32, 128])
def test_minres_shard_spmv_dot_plain_matches_pallas(bn, case):
    rng = np.random.default_rng(bn + 1)
    blocks, cols, full, off = _shard(rng, 13, bn, 2, 1)
    r1, vprev, wm1, wm2, x = (rng.standard_normal((13, bn)).astype(np.float32) for _ in range(5))
    su = np.zeros((1, 8), np.float32)
    su[0, :6] = SU_CASES[case]
    j = jk_mr.minres_shard_spmv_dot(
        *(jnp.asarray(a) for a in (blocks, cols, full, r1, vprev, wm1, wm2, x, su)),
        jnp.asarray([off], jnp.int32), interpret=True)
    t = tk_mr.minres_shard_spmv_dot(
        *(torch.from_numpy(a) for a in (blocks, cols, full, r1, vprev, wm1, wm2, x, su)), off)
    _close(t[0], j[0], 2e-5)
    scale = max(np.abs(a).max() for a in (vprev, wm1, wm2, x))
    for i in (1, 2):  # w, x'
        np.testing.assert_allclose(np.asarray(t[i]), np.asarray(j[i]), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(float(t[3]), float(j[3][0, 0]), rtol=1e-4)
    vwin = full[off // bn:off // bn + 13]
    assert abs(float(t[4]) - float(j[4][0, 0])) <= 1e-4 * np.linalg.norm(vwin) * np.linalg.norm(r1)
    if case == "first step":
        assert not t[1].any() and torch.equal(t[2], torch.from_numpy(x))


# ---- whole fused solves against the JAX fused sharded loops ---------------------

@pytest.fixture(scope="module")
def poisson32():
    """tests/test_sharded.py:250's system: poisson2d(32), float32, 128 x 128
    tiles on 8 shards (one block-row each), b = (1..n)/n."""
    a = _csr32(poisson2d_coo(32))
    n = a.shape[0]
    blocks, bcols, n_pad = partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                              bm=128, bn=128)
    b = np.zeros(n_pad, np.float32)
    b[:n] = reference_rhs(n, dtype=np.float32) / n
    inv_diag = np.ones(n_pad, np.float32)
    inv_diag[:n] = 1.0 / a.diagonal()
    return blocks, bcols, b, inv_diag, n


def _jax(blocks, bcols, b, **kw):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return jsolve(jnp.asarray(blocks), jnp.asarray(bcols), jnp.asarray(b), use_fused="always",
                  interpret=True, **kw)


def _port(blocks, bcols, b, **kw):
    return sharded_cg_solve(blocks, bcols, b, mesh=make_row_mesh(blocks.shape[0], "cpu"),
                            use_fused="always", **kw)


def _trajectory(info, ref, floor=1e-10, rtol=1e-3):
    k = min(int(info.iterations), int(ref.iterations))
    h = np.asarray(info.rho_history)[:k + 1]
    hr = np.asarray(ref.rho_history)[:k + 1]
    sel = hr > hr[0] * floor
    np.testing.assert_allclose(h[sel], hr[sel], rtol=rtol)


@pytest.mark.parametrize("jacobi", [False, True], ids=["cg", "jacobi"])
def test_fused_cg_matches_jax_fused(poisson32, jacobi):
    blocks, bcols, b, inv_diag, n = poisson32
    kw = dict(tol=1e-4, inv_diag=inv_diag if jacobi else None)
    x, info = _port(blocks, bcols, b, **kw)
    xj, ij = _jax(blocks, bcols, b, maxiter=b.shape[0] + 1, **kw)
    assert bool(info.converged) and abs(int(info.iterations) - int(ij.iterations)) <= 2
    _trajectory(info, ij)
    _close(x, xj, 1e-3)
    if jacobi:  # M applied inside the kernels: rho = r·M⁻¹r ≈ ||r||² / 4 here
        assert float(info.rho) < 0.5 * float(info.rnorm_sq)


@pytest.fixture(scope="module")
def banded1024():
    """tests/test_sharded_minres.py:192's system: banded_spd_coo(1024),
    float32, 128 x 128 tiles on 8 shards, b a seeded normal."""
    a = _csr32(banded_spd_coo(1024, bandwidth=5, seed=7))
    blocks, bcols, n_pad = partition_csr_rows(a.data, a.indices, a.indptr, a.shape, N_DEV,
                                              bm=128, bn=128)
    b = np.random.default_rng(7).standard_normal(1024).astype(np.float32)
    return a, blocks, bcols, b


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
def test_fused_minres_matches_jax_fused(banded1024, jacobi):
    a, blocks, bcols, b = banded1024
    kw = dict(method="minres", inv_diag=(1.0 / a.diagonal()).astype(np.float32) if jacobi else None)
    x, info = _port(blocks, bcols, b, tol=0.0, maxiter=24, **kw)
    xj, ij = _jax(blocks, bcols, b, tol=0.0, maxiter=24, **kw)
    assert int(info.iterations) == int(ij.iterations) == 24
    np.testing.assert_allclose(np.asarray(info.rho_history), np.asarray(ij.rho_history), rtol=5e-3)
    _close(x, xj, 1e-3)
    x, info = _port(blocks, bcols, b, tol=1e-4, maxiter=4096, **kw)
    _, ij = _jax(blocks, bcols, b, tol=1e-4, maxiter=4096, **kw)
    assert bool(info.converged) and abs(int(info.iterations) - int(ij.iterations)) <= 2
    assert np.linalg.norm(b - a @ np.asarray(x)) <= 5e-4


def test_fused_minres_matches_portable_loop_at_caps(banded1024):
    """Caps of 0, 1, 2 and 7 steps: the pending update is flushed, and x
    equals the portable loop's to 1e-5 of max|x|."""
    _, blocks, bcols, b = banded1024
    for cap in (0, 1, 2, 7):
        xf, fi = _port(blocks, bcols, b, maxiter=cap, method="minres")
        xp, pi = sharded_cg_solve(blocks, bcols, b, mesh=make_row_mesh(N_DEV, "cpu"),
                                  maxiter=cap, method="minres", use_fused="never")
        assert int(fi.iterations) == int(pi.iterations) == cap
        if cap:
            _close(xf, xp, 1e-5)
        else:
            assert not xf.any()


# ---- collectives per iteration ----------------------------------------------------

@pytest.mark.parametrize("method,use_fused,psums", [
    ("standard", "never", 2), ("standard", "always", 2), ("minres", "always", 2),
    ("minres", "never", 2)])
def test_collectives_per_iteration(poisson32, method, use_fused, psums):
    """One all_gather and two psum rounds per iteration, as
    tests/test_collective_counts.py:84, 131, 372 hold the JAX loops: the
    counts of a 6-step solve less those of a 0-step one."""
    blocks, bcols, b, _, _ = poisson32
    counts = []
    for steps in (0, 6):
        g = make_row_mesh(N_DEV, "cpu")
        sharded_cg_solve(blocks, bcols, b, mesh=g, tol=0.0, maxiter=steps, method=method,
                         use_fused=use_fused)
        counts.append(dict(g.counts))
    per_it = {k: (counts[1][k] - counts[0][k]) / 6 for k in counts[0]}
    assert per_it == {"all_gather": 1, "psum": psums}


# ---- torch.distributed: one shard per process --------------------------------------

WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from conjugategradient_tpu_torch.parallel import (DistributedGroup, make_row_mesh,
                                                      partition_csr_rows, sharded_cg_solve)
    from conjugategradient_tpu_torch.parallel import sharded_cg as front_end
    from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs

    # the operands the solve core hands on to this process's device
    seen = []
    core = front_end._owned_solve

    def spy(group, op_shards, b, x0, precond, **kw):
        blocks, block_cols = op_shards
        seen.append((tuple(blocks.shape), tuple(block_cols.shape), tuple(b.shape),
                     tuple(precond.shape)))
        return core(group, op_shards, b, x0, precond, **kw)

    front_end._owned_solve = spy

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    rows, cols, vals, shape = poisson2d_coo(16)
    cases = {}
    for dtype, fused, method in ((np.float32, "always", "standard"),
                                 (np.float32, "always", "minres"),
                                 (np.float64, "never", "standard")):
        a = sp.csr_matrix((np.asarray(vals, dtype), (rows, cols)), shape=shape)
        a.sort_indices()
        blocks, bcols, n_pad = partition_csr_rows(a.data, a.indices, a.indptr, shape, 2,
                                                  bm=128, bn=128)
        b = reference_rhs(n_pad, dtype=dtype) / n_pad
        inv = (np.ones(n_pad) / 4).astype(dtype)
        for key, group in (("dist", DistributedGroup(device="cpu")),
                           ("inproc", make_row_mesh(2, "cpu"))):
            if key == "inproc" and rank:
                continue
            x, info = sharded_cg_solve(blocks, bcols, b, mesh=group, tol=1e-5, maxiter=40,
                                       inv_diag=inv, use_fused=fused, method=method)
            cases[f"{key} {dtype.__name__} {method}"] = (x, info.rho_history, info.iterations,
                                                         seen[-1])
    torch.save(cases, f"{out}.{rank}")
    dist.destroy_process_group()
''')


def test_gloo_two_processes_bit_equal_to_in_process(tmp_path):
    """Two processes, one shard each, over gloo (a FileStore under
    tmp_path), give the bits of InProcessGroup(2, "cpu"): the fused CG and
    MINRES (float32, Jacobi) and the portable CG (float64); each process's
    solve holds only its own shard of the operator and vectors, and both
    end with the whole x.  The workers run with their own 120 s timeout, so
    they can never hang the suite."""
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
    cases = torch.load(f"{out}.0")
    other = torch.load(f"{out}.1")
    for name in ("float32 standard", "float32 minres", "float64 standard"):
        xd, hd, kd, own = cases[f"dist {name}"]
        xi, hi, ki, own_all = cases[f"inproc {name}"]
        assert int(kd) == int(ki) > 3, name
        assert torch.equal(xd, xi), name
        assert torch.equal(hd.view(torch.uint8), hi.view(torch.uint8)), name
        # each rank's device holds its own shard only, the in-process group both
        (_, nrb, kmax, bm, bn), m = own_all[0], own_all[2][0] // 2
        assert own == other[f"dist {name}"][3] == ((1, nrb, kmax, bm, bn), (1, nrb, kmax),
                                                   (m,), (m,)), name
        assert torch.equal(other[f"dist {name}"][0], xd), name
