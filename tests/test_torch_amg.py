"""``smoothed_aggregation_preconditioner`` and ``rigid_body_modes``
(solver/amg.py) against the JAX package's on the same numpy inputs (CPU),
the cases of tests/test_amg.py.

Tolerances:
* host setup bitwise equal: strength graphs, aggregates, the tentative and
  smoothed prolongators, every Galerkin level and the coarsest level
  (scipy CSR arrays compared with ``array_equal``), the Chebyshev
  intervals and the rigid-body modes;
* the native aggregation pass (native/amg_agg.cpp, built here with g++
  into a temporary directory) and the Python pass give equal aggregates;
* the float64 apply to 1e-12 of max|z| against the JAX apply;
* float64 AMG-PCG: equal iteration counts, rho_history to 1e-10 relative
  above 1e-16 of ‖r₀‖²;
* the materialized M^-1 symmetric to 1e-12 of max|M| (1e-13 for the
  stalled hierarchy, as the JAX test) and positive definite; u·M(v) and
  v·M(u) to 1e-12 relative where M is too large to materialize;
* float32 AMG-PCG: iteration counts within 2 of the JAX package's.
"""

import ctypes
import logging
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver import amg as jamg
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import StencilOperator as JStencil
from conjugategradient_tpu_torch import io as tio
from conjugategradient_tpu_torch.problems import (banded_spd_coo, convection_diffusion_2d_coo,
                                                  elasticity3d_coo, poisson2d_coo,
                                                  powerlaw_spd_coo)
from conjugategradient_tpu_torch.solver import (cg_solve, cg_solve_batched, gmres_solve,
                                                rigid_body_modes,
                                                smoothed_aggregation_preconditioner)
from conjugategradient_tpu_torch.solver import amg as tamg
from conjugategradient_tpu_torch.types import CSRMatrix, DIAMatrix, StencilOperator

CPU = "cpu"


def _pair(coo, dtype=np.float64):
    rows, cols, vals, shape = coo
    return (JCSR.from_coo(rows, cols, vals, shape, dtype=dtype),
            CSRMatrix.from_coo(rows, cols, vals, shape, dtype=dtype, device=CPU))


def _scaled_laplacian(nx=24, seed=0):
    rows, cols, vals, shape = poisson2d_coo(nx)
    L = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    s = np.exp(np.random.default_rng(seed).uniform(-3, 3, shape[0]))
    A = (sp.diags(s) @ L @ sp.diags(s)).tocsr()
    return A, s


def _elasticity(nx=6):
    coo = elasticity3d_coo(nx)
    coords = np.stack(np.meshgrid(np.arange(nx), np.arange(nx), np.arange(nx),
                                  indexing="ij"), axis=-1).reshape(-1, 3).astype(float)
    return coo, coords


def _csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _hierarchy_cases():
    A_sl, s = _scaled_laplacian()
    coo_e, coords = _elasticity()
    A_e = sp.csr_matrix((coo_e[2], (coo_e[0], coo_e[1])), shape=coo_e[3])
    return {
        "poisson2d_24": (sp.csr_matrix(_pair(poisson2d_coo(24))[0].to_dense()), {}),
        "poisson2d_24_unsmoothed": (sp.csr_matrix(_pair(poisson2d_coo(24))[0].to_dense()),
                                    {"smooth_prolongator": False}),
        "banded_600": (sp.csr_matrix(_pair(banded_spd_coo(600, bandwidth=5, seed=13))[0]
                                     .to_dense()), {"coarse_size": 30}),
        "powerlaw_1500": (sp.csr_matrix(_pair(powerlaw_spd_coo(1500, seed=4))[0].to_dense()),
                          {}),
        "scaled_laplacian_nullspace": (A_sl, {"near_nullspace": 1.0 / s}),
        "elasticity_rbm_block3": (A_e, {"near_nullspace": rigid_body_modes(coords),
                                        "blocksize": 3}),
    }


@pytest.mark.parametrize("case", list(_hierarchy_cases()))
def test_host_hierarchy_is_bitwise_the_jax_one(case):
    A, kw = _hierarchy_cases()[case]
    args = dict(theta=0.08, smooth_prolongator=kw.get("smooth_prolongator", True),
                coarse_size=kw.get("coarse_size", 400), max_levels=20,
                near_nullspace=kw.get("near_nullspace"), blocksize=kw.get("blocksize", 1))
    jl, jc = jamg._build_hierarchy(A.copy(), **args)
    tl, tc = tamg._build_hierarchy(A.copy(), **args)
    assert len(tl) == len(jl) >= 1
    for t, j in zip(tl, jl):
        _csr_equal(t["A"], j["A"])
        _csr_equal(t["P"], j["P"])
        np.testing.assert_array_equal(t["agg"], j["agg"])
        assert (t["n_agg"], t["smoothed"], t["csr_transfers"]) == \
            (j["n_agg"], j["smoothed"], j["csr_transfers"])
        assert tamg._cheb_interval(t["A"], 1 / 6) == jamg._cheb_interval(j["A"], 1 / 6)
        assert tamg._level_layout(t["A"]) == (
            "dia" if type(jamg._level_operator(j["A"], jnp.float64, "auto")).__name__
            == "DIAMatrix" else "csr")
    _csr_equal(tc, jc)


def test_host_pieces_are_bitwise_the_jax_ones():
    ja, ta = _pair(poisson2d_coo(20))
    A_j, A_t = jamg._to_scipy_csr(ja), tamg._to_scipy_csr(ta)
    _csr_equal(A_t, A_j)
    for theta in (0.0, 0.08, 0.25):
        _csr_equal(tamg._strength_graph(A_t, theta), jamg._strength_graph(A_j, theta))
    S = tamg._strength_graph(A_t, 0.08)
    agg_t, n_t = tamg._aggregate_py(S)
    agg_j, n_j = jamg._aggregate_py(jamg._strength_graph(A_j, 0.08))
    assert n_t == n_j
    np.testing.assert_array_equal(agg_t, agg_j)
    assert tamg._rho_dinv_a_bound(A_t) == jamg._rho_dinv_a_bound(A_j)
    rng = np.random.default_rng(1)
    agg = rng.integers(0, 37, 200)
    agg[np.arange(37)] = np.arange(37)
    B = rng.standard_normal((200, 4))
    P0t, Bct = tamg._tentative_prolongator(agg, 37, B)
    P0j, Bcj = jamg._tentative_prolongator(agg, 37, B)
    _csr_equal(P0t, P0j)
    np.testing.assert_array_equal(Bct, Bcj)
    np.testing.assert_allclose(P0t @ Bct, B, atol=1e-12)
    coo_e, _ = _elasticity(4)
    A_e = sp.csr_matrix((coo_e[2], (coo_e[0], coo_e[1])), shape=coo_e[3])
    _csr_equal(tamg._block_condense(A_e, 3), jamg._block_condense(A_e, 3))
    for nu in (1, 2, 3, 4):
        assert tamg._cheb_smooth_steps(0.3, 1.9, nu) == jamg._cheb_smooth_steps(0.3, 1.9, nu)


def test_rigid_body_modes_contract():
    from conjugategradient_tpu import rigid_body_modes as jrbm

    coords = np.array([[0.0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3]])
    B = rigid_body_modes(coords)
    np.testing.assert_array_equal(B, jrbm(coords))
    assert B.shape == (12, 6) and np.linalg.matrix_rank(B) == 6
    c = coords - coords.mean(axis=0)
    np.testing.assert_allclose(B[0::3, 5], -c[:, 1])
    np.testing.assert_allclose(B[1::3, 5], c[:, 0])
    with pytest.raises(ValueError, match="n_nodes"):
        rigid_body_modes(np.zeros((4, 2)))


@pytest.fixture(scope="module")
def native_agg_lib(tmp_path_factory):
    """native/amg_agg.cpp built with g++ into a temporary directory, with
    the argument types ``io/native`` declares for it."""
    import pathlib

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build native/amg_agg.cpp")
    src = pathlib.Path(__file__).resolve().parents[1] / "native" / "amg_agg.cpp"
    out = tmp_path_factory.mktemp("native") / "libamg_agg.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.cg_amg_aggregate.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.cg_amg_aggregate.restype = ctypes.c_int64
    return lib


def test_native_aggregation_matches_python(native_agg_lib, monkeypatch):
    """The port's binding (io/native.amg_aggregate_native) on the built
    pass gives the Python pass's aggregates, and _aggregate takes it."""
    from conjugategradient_tpu_torch.io import native

    monkeypatch.setattr(native, "_load", lambda: native_agg_lib)
    cases = []
    _, ta = _pair(poisson2d_coo(20))
    cases.append(tamg._strength_graph(tamg._to_scipy_csr(ta), 0.08))
    _, tp = _pair(powerlaw_spd_coo(1500, seed=4))
    A2 = tamg._to_scipy_csr(tp)
    cases += [tamg._strength_graph(A2, 0.08), tamg._strength_graph(A2, 0.0)]
    for S in cases:
        agg_py, n_py = tamg._aggregate_py(S)
        agg_c, n_c = native.amg_aggregate_native(S.indptr, S.indices, S.shape[0])
        agg_d, n_d = tamg._aggregate(S)
        assert n_py == n_c == n_d
        np.testing.assert_array_equal(agg_py, agg_c)
        np.testing.assert_array_equal(agg_py, agg_d)


def test_aggregate_takes_the_python_pass_without_the_library():
    _, ta = _pair(poisson2d_coo(12))
    S = tamg._strength_graph(tamg._to_scipy_csr(ta), 0.08)
    if tio.native.available():
        pytest.skip("the native library is built here")
    agg, n = tamg._aggregate(S)
    agg_py, n_py = tamg._aggregate_py(S)
    assert n == n_py
    np.testing.assert_array_equal(agg, agg_py)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("smooth", [True, False], ids=["smoothed", "unsmoothed"])
@pytest.mark.parametrize("layout", ["auto", "csr"])
@pytest.mark.parametrize("cycles", [1, 2])
def test_apply_matches_jax(smoother, smooth, layout, cycles):
    ja, ta = _pair(poisson2d_coo(16))
    kw = dict(smoother=smoother, smooth_prolongator=smooth, level_layout=layout,
              cycles=cycles, coarse_size=30)
    Mj = jcg.smoothed_aggregation_preconditioner(ja, **kw)
    Mt = smoothed_aggregation_preconditioner(ta, **kw)
    assert Mt.level_sizes == Mj.level_sizes and Mt.n_levels == Mj.n_levels
    assert Mt.operator_complexity == pytest.approx(Mj.operator_complexity, rel=1e-15)
    r = np.random.default_rng(0).standard_normal(ta.shape[0])
    zj = np.asarray(Mj(jnp.asarray(r)))
    zt = Mt(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-12 * np.abs(zj).max())


def _materialize(M, n):
    eye = torch.eye(n, dtype=torch.float64)
    return torch.stack([M(eye[:, j].contiguous()) for j in range(n)], dim=1).numpy()


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("smooth", [True, False], ids=["smoothed", "unsmoothed"])
def test_vcycle_symmetric_positive(smoother, smooth):
    _, ta = _pair(poisson2d_coo(12))
    M = smoothed_aggregation_preconditioner(ta, coarse_size=30, smooth_prolongator=smooth,
                                            smoother=smoother)
    assert M.n_levels >= 2
    Md = _materialize(M, ta.shape[0])
    np.testing.assert_allclose(Md, Md.T, rtol=0, atol=1e-12 * np.abs(Md).max())
    assert np.linalg.eigvalsh(0.5 * (Md + Md.T)).min() > 0


def test_rbm_block_hierarchy_symmetric_and_matches_jax():
    """Rigid-body modes with node (blocksize=3) aggregation on the
    elasticity stand-in: the hierarchy coarsens, the cycle is symmetric,
    and PCG takes the JAX package's iteration count."""
    coo, coords = _elasticity(6)
    ja, ta = _pair(coo)
    B = rigid_body_modes(coords)
    Mt = smoothed_aggregation_preconditioner(ta, near_nullspace=B, blocksize=3)
    Mj = jcg.smoothed_aggregation_preconditioner(ja, near_nullspace=B, blocksize=3)
    assert Mt.level_sizes == Mj.level_sizes
    assert Mt.level_sizes[1] <= 0.6 * Mt.level_sizes[0]
    rng = np.random.default_rng(3)
    n = ta.shape[0]
    u, v = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    uMv, vMu = float(u @ Mt(v)), float(v @ Mt(u))
    assert abs(uMv - vMu) <= 1e-12 * abs(uMv)
    b = rng.standard_normal(n)
    tol = 1e-9 * float(np.linalg.norm(b))
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=tol, M=Mj)
    _, it = cg_solve(ta, torch.from_numpy(b), tol=tol, M=Mt)
    _assert_pcg(it, ij)


def _assert_pcg(it, ij):
    assert bool(it.converged) and bool(ij.converged)
    k = int(ij.iterations)
    assert int(it.iterations) == k
    hj = np.asarray(ij.rho_history)[: k + 1]
    ht = it.rho_history[: k + 1].numpy()
    sel = hj > 1e-16 * hj[0]
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=1e-10)


@pytest.mark.parametrize("kw", [{}, {"smoother": "chebyshev"}, {"smooth_prolongator": False},
                                {"cycles": 2}, {"level_layout": "csr"}],
                         ids=["jacobi", "chebyshev", "unsmoothed", "two-cycles", "csr-levels"])
def test_amg_pcg_matches_jax(kw):
    ja, ta = _pair(poisson2d_coo(32))
    b = np.random.default_rng(5).standard_normal(ta.shape[0])
    tol = 1e-8 * float(np.linalg.norm(b))
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=tol,
                         M=jcg.smoothed_aggregation_preconditioner(ja, **kw))
    xt, it = cg_solve(ta, torch.from_numpy(b), tol=tol,
                      M=smoothed_aggregation_preconditioner(ta, **kw))
    _assert_pcg(it, ij)
    _, plain = cg_solve(ta, torch.from_numpy(b), tol=tol)
    assert int(it.iterations) * 2 < int(plain.iterations)


def test_scaled_laplacian_true_mode_beats_constant():
    A, s = _scaled_laplacian(32, seed=2)
    ta = CSRMatrix.from_scipy(A, device=CPU)
    ja = JCSR.from_arrays(A.data, A.indices, A.indptr, A.shape)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    tol = 1e-9 * float(np.linalg.norm(b))
    _, i_const = cg_solve(ta, torch.from_numpy(b), tol=tol, maxiter=2000,
                          M=smoothed_aggregation_preconditioner(ta))
    _, i_mode = cg_solve(ta, torch.from_numpy(b), tol=tol, maxiter=2000,
                         M=smoothed_aggregation_preconditioner(ta, near_nullspace=1.0 / s))
    _, j_mode = jcg.cg_solve(ja, jnp.asarray(b), tol=tol, maxiter=2000,
                             M=jcg.smoothed_aggregation_preconditioner(ja,
                                                                       near_nullspace=1.0 / s))
    assert bool(i_mode.converged) and int(i_mode.iterations) == int(j_mode.iterations)
    assert 2 * int(i_mode.iterations) <= int(i_const.iterations)


def test_stalled_hierarchy_falls_back_to_jacobi_coarse(caplog):
    """No couplings: nothing aggregates; above dense_cap the coarsest solve
    is Jacobi sweeps, with the JAX package's warning through the port's
    logger, and the cycle stays symmetric."""
    n = 300
    data = 2.0 + np.arange(n, dtype=np.float64) % 3
    ta = CSRMatrix.from_arrays(data, np.arange(n), np.arange(n + 1), (n, n), device=CPU)
    ja = JCSR.from_arrays(data, np.arange(n, dtype=np.int32),
                          np.arange(n + 1, dtype=np.int32), (n, n))
    with caplog.at_level(logging.WARNING, logger="conjugategradient_tpu"):
        M = smoothed_aggregation_preconditioner(ta, dense_cap=50)
    assert any("stalled at n=300" in r.getMessage() for r in caplog.records)
    Mj = jcg.smoothed_aggregation_preconditioner(ja, dense_cap=50)
    assert M.n_levels == Mj.n_levels == 1 and M.level_sizes == Mj.level_sizes
    assert M.operator_complexity == Mj.operator_complexity
    Md = _materialize(M, n)
    np.testing.assert_allclose(Md, Md.T, rtol=0, atol=1e-13 * np.abs(Md).max())
    r = np.random.default_rng(3).standard_normal(n)
    np.testing.assert_allclose(M(torch.from_numpy(r)).numpy(), np.asarray(Mj(jnp.asarray(r))),
                               rtol=1e-14)
    x, info = cg_solve(ta, torch.from_numpy(r), tol=1e-10, M=M)
    assert bool(info.converged)
    np.testing.assert_allclose(x.numpy(), r / data, rtol=1e-8)


def test_banded_levels_ride_the_dia_layout():
    _, ta = _pair(poisson2d_coo(24))
    A_sp = tamg._to_scipy_csr(ta)
    assert isinstance(tamg._level_operator(A_sp, torch.float64, "auto", CPU), DIAMatrix)
    assert isinstance(tamg._level_operator(A_sp, torch.float64, "csr", CPU), CSRMatrix)


def test_hierarchy_metadata_and_scipy_dense_ingest():
    ja, ta = _pair(poisson2d_coo(32))
    M = smoothed_aggregation_preconditioner(ta, coarse_size=50)
    sizes = M.level_sizes
    assert M.n_levels >= 3 and sizes[0] == ta.shape[0] and sizes[-1] <= 50
    assert all(sizes[i + 1] < sizes[i] for i in range(len(sizes) - 1))
    assert M.operator_complexity < 3.0
    A_sp = tamg._to_scipy_csr(ta)
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(ta.shape[0]))
    for A_in in (A_sp, A_sp.toarray()):
        Mi = smoothed_aggregation_preconditioner(A_in, coarse_size=50, dtype=torch.float64,
                                                 device=CPU)
        assert Mi.level_sizes == sizes
        torch.testing.assert_close(Mi(r), M(r), rtol=0, atol=0)
    # dtype: the CSRMatrix's own, or a numpy dtype; host inputs default to
    # torch's default dtype
    assert M(r).dtype == torch.float64
    M32 = smoothed_aggregation_preconditioner(A_sp, coarse_size=50, dtype=np.float32,
                                              device=CPU)
    assert M32(r.float()).dtype == torch.float32
    Md = smoothed_aggregation_preconditioner(A_sp, coarse_size=50, device=CPU)
    assert Md(r.to(torch.get_default_dtype())).dtype == torch.get_default_dtype()


def _errors(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("kw", [
    {"nu": 0}, {"cycles": 0}, {"omega": 2.5}, {"level_layout": "dia"},
    {"smoother": "sor"}, {"smoother": "chebyshev", "cheb_lower": 1.5},
    {"near_nullspace": np.ones(7)}, {"near_nullspace": np.full(144, np.nan)},
    {"blocksize": 0}, {"blocksize": 5},
], ids=lambda kw: ",".join(kw))
def test_validation_errors_match_jax(kw):
    ja, ta = _pair(poisson2d_coo(12))
    assert _errors(lambda: smoothed_aggregation_preconditioner(ta, **kw)) == \
        _errors(lambda: jcg.smoothed_aggregation_preconditioner(ja, **kw))


def test_rejections_match_jax():
    jop = JStencil.poisson((8, 8, 8), dtype=jnp.float64)
    top = StencilOperator.poisson((8, 8, 8), dtype=torch.float64, device=CPU)
    et, ej = (_errors(lambda: smoothed_aggregation_preconditioner(top)),
              _errors(lambda: jcg.smoothed_aggregation_preconditioner(jop)))
    assert et[0] is ej[0] is TypeError and "multigrid_preconditioner" in et[1]
    assert et[1].replace("StencilOperator", "") == ej[1].replace("StencilOperator", "")
    rect = np.zeros((4, 6))
    assert _errors(lambda: smoothed_aggregation_preconditioner(rect, device=CPU)) == \
        _errors(lambda: jcg.smoothed_aggregation_preconditioner(rect))


def test_float32_pcg_and_batched():
    ja, ta = _pair(poisson2d_coo(32), np.float32)
    b = np.random.default_rng(6).standard_normal(ta.shape[0]).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=tol,
                         M=jcg.smoothed_aggregation_preconditioner(ja))
    Mt = smoothed_aggregation_preconditioner(ta)
    _, it = cg_solve(ta, torch.from_numpy(b), tol=tol, M=Mt)
    assert bool(it.converged) and abs(int(it.iterations) - int(ij.iterations)) <= 2
    B = torch.from_numpy(np.random.default_rng(11).standard_normal((4, ta.shape[0])))
    _, t64 = _pair(poisson2d_coo(32))
    M64 = smoothed_aggregation_preconditioner(t64)
    tolb = 1e-9 * torch.linalg.vector_norm(B, dim=1)
    X, info = cg_solve_batched(t64, B, tol=tolb, M=M64)
    assert bool(info.converged.all()) and int(info.iterations.max()) <= 15
    for j in range(4):
        _, solo = cg_solve(t64, B[j].contiguous(), tol=float(tolb[j]), M=M64)
        assert int(solo.iterations) == int(info.iterations[j])


def test_amg_right_preconditions_gmres_like_jax():
    """The nonsymmetric cycle as GMRES's right preconditioner on
    convection-diffusion: the JAX package's iteration count, several times
    fewer than unpreconditioned GMRES."""
    ja, ta = _pair(convection_diffusion_2d_coo(32, peclet=10.0))
    n = ta.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    tol = 1e-8 * float(np.linalg.norm(b))
    _, ij = jcg.gmres_solve(ja, jnp.asarray(b), tol=tol, maxiter=6 * n, restart=30,
                            M=jcg.smoothed_aggregation_preconditioner(ja))
    x, it = gmres_solve(ta, torch.from_numpy(b), tol=tol, maxiter=6 * n, restart=30,
                        M=smoothed_aggregation_preconditioner(ta))
    _, ipl = gmres_solve(ta, torch.from_numpy(b), tol=tol, maxiter=6 * n, restart=30)
    assert bool(it.converged) and int(it.iterations) == int(ij.iterations)
    assert int(it.iterations) * 3 <= int(ipl.iterations)
    assert np.linalg.norm(b - ta.matvec(x).numpy()) <= 5 * tol
