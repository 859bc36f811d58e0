"""The port's SELL (degree-bucketed ELL) layout against the JAX package, on
the CPU, from the same numpy inputs.

* Packing, bitwise: ``diag``/``pos``/``cols_flat``/``vals_flat``/
  ``bucket_meta``/``pos_identity`` on every file in problems/, with and
  without RCM (and with the degree sort the loader composes on top).
* SpMV against the JAX ``sell_spmv`` (plain XLA; the JAX package has no
  Pallas kernel for SELL) on powerlaw_1138, with and without the degree
  sort: f32 within 1e-5 of max|y| (f32 sums in another order), f64 within
  1e-12 relative.
* A portable f64 SELL solve takes the JAX solve's iteration count, with
  ``rho_history`` within 1e-10 relative: poisson2d_34 plain and Jacobi,
  powerlaw_1138 Jacobi.  Unpreconditioned CG on powerlaw_1138 is not held
  to that: its trajectory amplifies a one-ulp difference in the SpMV
  (another order of the bucket sums) ~10-fold per step, and the two
  packages stop one step apart.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu import reorder as jreorder
from conjugategradient_tpu.io import loader as jloader
from conjugategradient_tpu.ops import spmv as jspmv
from conjugategradient_tpu.types import SellMatrix as JSell
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.ops import spmv as tspmv
from conjugategradient_tpu_torch.problems import reference_rhs
from conjugategradient_tpu_torch.solver import cg_solve, jacobi_preconditioner
from conjugategradient_tpu_torch.types import SellMatrix
from conjugategradient_tpu_torch.types.sell import _sell_ladder

ROOT = pathlib.Path(__file__).resolve().parents[1]
MTX = sorted((ROOT / "problems").glob("*.mtx"))
POWERLAW = ROOT / "problems" / "powerlaw_1138.mtx"
FIELDS = ("diag", "pos", "cols_flat", "vals_flat")


def _same(ts, js):
    for f in FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ts.bucket_meta == tuple(js.bucket_meta)
    assert (ts.shape, ts.nnz, ts.pos_identity) == (tuple(js.shape), js.nnz, js.pos_identity)


@pytest.mark.parametrize("order", ["plain", "rcm", "rcm+degree"])
@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_sell_packing_bitwise(path, order):
    data, indices, indptr, shape = tloader.read_csr_host(path)
    n = shape[0]
    if order != "plain":
        perm = jreorder.rcm_permutation(indices, indptr, n)
        data, indices, indptr = jreorder.permute_csr(data, indices, indptr, shape, perm)
    if order == "rcm+degree":
        perm = jreorder.degree_sort_permutation(indices, indptr, n)
        data, indices, indptr = jreorder.permute_csr(data, indices, indptr, shape, perm)
    vals = data.astype(np.float32)
    js = JSell.from_csr_host(vals, indices, indptr, shape)
    ts = SellMatrix.from_csr_host(vals, indices, indptr, shape, device="cpu")
    _same(ts, js)
    if order == "rcm+degree":
        assert ts.pos_identity
    carried = convert.sell_from_arrays(
        *(np.asarray(getattr(js, f)) for f in FIELDS), js.bucket_meta, js.shape,
        js.nnz, js.pos_identity, device="cpu")
    _same(carried, js)
    assert ts.padding_ratio() == js.padding_ratio()
    assert ts.memory_footprint() == js.memory_footprint()


def test_ladder_matches_jax():
    from conjugategradient_tpu.types.sell import _sell_ladder as jladder

    for d in (1, 2, 3, 7, 64, 1000):
        assert _sell_ladder(d) == jladder(d)


@pytest.fixture(scope="module")
def powerlaw():
    """powerlaw_1138 as SELL in both packages: as read, and RCM +
    degree-sorted through the loaders (pos the identity)."""
    out = {}
    for dt in (np.float32, np.float64):
        out[dt, False] = (jloader.load_matrix(POWERLAW, layout="sell", dtype=dt),
                          tloader.load_matrix(POWERLAW, layout="sell", dtype=dt,
                                              device="cpu"))
        (j, jp), (t, tp) = (jloader.load_matrix(POWERLAW, layout="sell", dtype=dt, reorder=True),
                            tloader.load_matrix(POWERLAW, layout="sell", dtype=dt,
                                                reorder=True, device="cpu"))
        assert np.array_equal(tp, jp)
        out[dt, True] = (j, t)
    return out


@pytest.mark.parametrize("sorted_rows", [False, True], ids=["pos", "pos_identity"])
def test_sell_spmv_matches_jax(powerlaw, sorted_rows):
    rng = np.random.default_rng(3)
    js, ts = powerlaw[np.float32, sorted_rows]
    assert ts.pos_identity == sorted_rows == js.pos_identity
    x = rng.standard_normal(ts.n).astype(np.float32)
    y = ts.matvec(torch.from_numpy(x)).numpy()
    want = np.asarray(jspmv.sell_spmv(js, jnp.asarray(x)))
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ts.to_dense().numpy(), np.asarray(js.to_dense()))
    js64, ts64 = powerlaw[np.float64, sorted_rows]
    x64 = rng.standard_normal(ts.n)
    y64 = tspmv.sell_spmv(ts64, torch.from_numpy(x64)).numpy()
    want64 = np.asarray(jspmv.sell_spmv(js64, jnp.asarray(x64)))
    np.testing.assert_allclose(y64, want64, rtol=1e-12, atol=1e-12 * np.abs(want64).max())
    np.testing.assert_array_equal(ts64.diagonal().numpy(), np.asarray(js64.diagonal()))


def test_sell_bucket_reduce_multi_column():
    meta = ((2, 0), (3, 2), (1, 3))
    prods = torch.arange(9 * 2, dtype=torch.float64).reshape(9, 2)
    got = tspmv.sell_bucket_reduce(prods, meta).numpy()
    want = np.asarray(jspmv.sell_bucket_reduce(jnp.asarray(prods.numpy()), meta))
    assert got.shape == (6, 2) and np.array_equal(got, want)


@pytest.mark.parametrize("name,precond", [("poisson2d_34", "none"), ("poisson2d_34", "jacobi"),
                                          ("powerlaw_1138", "jacobi")])
def test_f64_sell_solve_matches_jax(name, precond):
    path = ROOT / "problems" / f"{name}.mtx"
    js = jloader.load_matrix(path, layout="sell", dtype=np.float64)
    ts = tloader.load_matrix(path, layout="sell", dtype=np.float64, device="cpu")
    b = reference_rhs(ts.n)
    tol = 1e-8 * float(np.linalg.norm(b))
    jM = jcg.jacobi_preconditioner(js) if precond == "jacobi" else None
    tM = jacobi_preconditioner(ts) if precond == "jacobi" else None
    _, ij = jcg.cg_solve(js, jnp.asarray(b), tol=tol, M=jM)
    _, it = cg_solve(ts, torch.from_numpy(b), tol=tol, M=tM)
    k = int(ij.iterations)
    assert bool(it.converged) and int(it.iterations) == k
    np.testing.assert_allclose(np.asarray(it.rho_history)[: k + 1],
                               np.asarray(ij.rho_history)[: k + 1], rtol=1e-10)
