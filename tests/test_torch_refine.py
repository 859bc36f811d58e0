"""Mixed-precision CG-IR (``solver/refine.py``), operator ``astype`` and the
bfloat16 loader, against the JAX package on the CPU.

The same numpy inputs go to both packages.  Bounds:

* f64-high / f32-low: equal ``refinements`` and ``inner_iterations``, and
  ``rnorm_history`` within 1e-10 relative or 1e-10 of its first entry
  (the entries shrink by 1e-20 and the deepest ones are rounding-sized
  differences of equal-count solves: measured 6.5e-5 relative on an entry
  1e-20 of the first, 1e-13 relative on the second);
* f32-high / bf16-low: equal ``converged``, refinements within 1, inner
  iterations within 10% (measured on poisson2d(16): 58 against 59), and
  both final true residuals at or below tol;
* ``astype`` and ``load_matrix(dtype=bfloat16)``: values bit-equal to the
  JAX package's, structure tensors shared with the source operator.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu.types import SellMatrix as JSell
from conjugategradient_tpu.types import StencilOperator as JStencil
from conjugategradient_tpu.types import SymBellMatrix as JSymBell
from conjugategradient_tpu.types import SymDIAMatrix as JSymDIA
from conjugategradient_tpu_torch import (CSRMatrix, RefineInfo, cg_solve, load_matrix,
                                         refined_cg_solve, solver)
from conjugategradient_tpu_torch.types import (BlockedEllMatrix, DenseOperator, DIAMatrix,
                                               MatrixFreeOperator, SellMatrix, StencilOperator,
                                               SymBellMatrix, SymDIAMatrix)
from conjugategradient_tpu_torch.types.base import as_numpy_dtype

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module")
def system():
    rows, cols, vals, shape = poisson2d_coo(16)
    JA = jcg.CSRMatrix.from_coo(rows, cols, vals, shape)
    TA = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    b = reference_rhs(shape[0])
    return JA, TA, b


def _values(op):
    """The value tensors of a port operator, widened to float64 numpy."""
    if isinstance(op, CSRMatrix):
        vals = (op.data,)
    elif isinstance(op, BlockedEllMatrix):
        vals = (op.blocks,)
    elif isinstance(op, SymBellMatrix):
        vals = (op.diag_blocks, op.off_blocks)
    elif isinstance(op, (DIAMatrix, SymDIAMatrix)):
        vals = (op.diags,)
    elif isinstance(op, SellMatrix):
        vals = (op.diag, op.vals_flat)
    else:
        vals = (op.a,)
    return [v.double().numpy() for v in vals]


def _jvalues(op):
    if isinstance(op, jcg.CSRMatrix):
        vals = (op.data,)
    elif isinstance(op, JBell):
        vals = (op.blocks,)
    elif isinstance(op, JSymBell):
        vals = (op.diag_blocks, op.off_blocks)
    elif isinstance(op, (JDIA, JSymDIA)):
        vals = (op.diags,)
    elif isinstance(op, JSell):
        vals = (op.diag, op.vals_flat)
    else:
        vals = (op.a,)
    return [np.asarray(jnp.asarray(v).astype(jnp.float64)) for v in vals]


def _structure(op):
    """The structure tensors a cast must share."""
    if isinstance(op, CSRMatrix):
        return (op.indices, op.indptr, op.row_ids)
    if isinstance(op, BlockedEllMatrix):
        return (op.block_cols,)
    if isinstance(op, SymBellMatrix):
        return (op.off_cols, op.mirror_src)
    if isinstance(op, (DIAMatrix, SymDIAMatrix)):
        return (op.offsets_dev,)
    if isinstance(op, SellMatrix):
        return (op.cols_flat, op.pos)
    return ()


LAYOUTS = ("csr", "bell", "symbell", "dia", "symdia", "sell", "auto")


class TestAstype:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_all_layouts_cast_values_share_structure(self, system, dtype):
        """Every layout's astype: values bit-equal to the JAX astype's,
        structure tensors the source's own, the matvec close to the source's
        (f32: 2e-6 as the JAX test; bf16: 1e-2, its 8 bits)."""
        JA, TA, _ = system
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        x = np.random.default_rng(0).standard_normal(TA.shape[0])
        host = (np.asarray(JA.data), np.asarray(JA.indices), np.asarray(JA.indptr), JA.shape)
        pairs = (
            (JA, TA),
            (JBell.from_csr(JA, bm=8, bn=128),
             BlockedEllMatrix.from_csr_host(*host, bm=8, bn=128, device=CPU)),
            (JSymBell.from_csr_host(*host, bn=32), SymBellMatrix.from_csr_host(*host, bn=32,
                                                                               device=CPU)),
            (JDIA.from_csr(JA), DIAMatrix.from_csr_host(*host, device=CPU)),
            (JSymDIA.from_dia(JDIA.from_csr(JA)),
             SymDIAMatrix.from_dia(DIAMatrix.from_csr_host(*host, device=CPU))),
            (JSell.from_csr(JA), SellMatrix.from_csr_host(*host, device=CPU)),
            (jcg.DenseOperator(JA.to_dense()), DenseOperator(TA.to_dense())),
        )
        tol = 2e-6 if dtype == "float32" else 1e-2
        for jop, top in pairs:
            jlo, tlo = jop.astype(jdt), top.astype(tdt)
            assert tlo.dtype == tdt and tlo.shape == top.shape, type(top)
            for tv, jv in zip(_values(tlo), _jvalues(jlo)):
                assert np.array_equal(tv, jv), type(top)
            for s_lo, s_hi in zip(_structure(tlo), _structure(top)):
                assert s_lo is s_hi, type(top)
            xs = torch.from_numpy(x).to(torch.float32)
            y_lo = tlo.matvec(xs).double().numpy()
            y = top.matvec(torch.from_numpy(x)).double().numpy()
            np.testing.assert_allclose(y_lo, y, rtol=tol, atol=tol * np.abs(y).max())

    def test_stencil_and_footprint(self):
        st = StencilOperator.poisson((4, 4, 4), dtype=torch.float64, device=CPU)
        lo = st.astype(torch.bfloat16)
        jlo = JStencil.poisson((4, 4, 4), dtype=jnp.float64).astype(jnp.bfloat16)
        assert lo.dtype == torch.bfloat16
        assert lo.grid_shape == st.grid_shape
        assert (lo.center, lo.off) == (float(jlo.center), float(jlo.off))
        # the round to bfloat16 goes through float32, as jnp.asarray rounds it
        odd = StencilOperator(1.00390625 + 2.0 ** -40, -1.0, (2, 2, 2), torch.bfloat16, CPU)
        assert odd.center == float(jnp.asarray(1.00390625 + 2.0 ** -40, jnp.bfloat16))

    def test_dia_blocked_copy_cast(self, system):
        """The port's DIA has no pre-blocked copy (the TPU's relayout): the
        cast keeps the offsets tuple and its device tensor."""
        _, TA, _ = system
        dia = DIAMatrix.from_csr_host(TA.data.numpy(), TA.indices.numpy(), TA.indptr.numpy(),
                                      TA.shape, device=CPU)
        lo = dia.astype(torch.float32)
        assert lo.diags.dtype == torch.float32
        assert lo.offsets == dia.offsets and lo.offsets_dev is dia.offsets_dev

    def test_matrix_free_rejects(self):
        op = MatrixFreeOperator(lambda v: v, 8, device=CPU)
        with pytest.raises(NotImplementedError):
            op.astype(torch.bfloat16)

    def test_memory_halves_f64_to_f32(self, system):
        _, TA, _ = system
        dia = DIAMatrix.from_csr_host(TA.data.numpy(), TA.indices.numpy(), TA.indptr.numpy(),
                                      TA.shape, device=CPU)
        assert dia.astype(torch.float32).memory_footprint() * 2 == dia.memory_footprint()


class TestLoader:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("name", ["poisson3d_48", "elasticity3d_16"])
    def test_bf16_load_is_bit_equal_to_jax(self, name, layout):
        """load_matrix(dtype=bfloat16): the layout the JAX loader picks,
        values bit-equal to its (float64 rounded through float32), the nnz
        and the structure equal."""
        path = ROOT / "problems" / f"{name}.mtx"
        jop = jcg.load_matrix(str(path), layout=layout, dtype=jnp.bfloat16)
        top = load_matrix(path, layout=layout, dtype=torch.bfloat16, device=CPU)
        assert type(top).__name__ == type(jop).__name__
        assert top.dtype == torch.bfloat16 and top.shape == tuple(jop.shape)
        assert top.nnz == jop.nnz
        for tv, jv in zip(_values(top), _jvalues(jop)):
            assert tv.shape == jv.shape and np.array_equal(tv, jv)
        # the same file as float32 and cast: the same bits
        t32 = load_matrix(path, layout=layout, dtype=np.float32, device=CPU)
        for tv, cv in zip(_values(top), _values(t32.astype(torch.bfloat16))):
            assert np.array_equal(tv, cv)

    def test_dtype_names(self):
        assert as_numpy_dtype(torch.bfloat16) == np.float32  # staged, then cast
        assert as_numpy_dtype("bfloat16") == np.float32
        assert as_numpy_dtype(torch.float64) == np.float64
        path = ROOT / "problems" / "poisson2d_34.mtx"
        assert load_matrix(path, layout="csr", dtype="bfloat16", device=CPU).dtype == torch.bfloat16


def _both(JA, TA, b, **kw):
    jkw = {k: (getattr(jnp, v) if k == "low_dtype" else v) for k, v in kw.items()}
    tkw = {k: (getattr(torch, v) if k == "low_dtype" else v) for k, v in kw.items()}
    xj, ij = jcg.refined_cg_solve(JA, jnp.asarray(b), **jkw)
    xt, it = refined_cg_solve(TA, torch.from_numpy(b), **tkw)
    return (np.asarray(xj), ij), (xt, it)


def _same_f64_f32(ij, it):
    assert it.refinements == ij.refinements
    assert it.inner_iterations == ij.inner_iterations
    assert it.converged == ij.converged
    hj, ht = np.array(ij.rnorm_history), np.array(it.rnorm_history)
    np.testing.assert_allclose(ht, hj, rtol=1e-10, atol=1e-10 * hj[0])


class TestRefinedCG:
    def test_beats_pure_low_precision_floor(self, system):
        """f64-high / f32-low reaches 1e-10 ||b|| in a few corrections, as
        the JAX package does, with its counts; a float32-only solve cannot."""
        JA, TA, b = system
        tol = 1e-10 * float(np.linalg.norm(b))
        (_, ij), (x, info) = _both(JA, TA, b, tol=tol, low_dtype="float32")
        _same_f64_f32(ij, info)
        assert isinstance(info, RefineInfo) and info.converged and x.dtype == torch.float64
        r = b - TA.to_dense().numpy() @ x.numpy()
        assert np.linalg.norm(r) <= tol
        assert info.refinements >= 2
        h = info.rnorm_history
        assert all(h[i + 1] < h[i] for i in range(len(h) - 1))
        x32, _ = cg_solve(TA.astype(torch.float32), torch.from_numpy(b).float(), tol=tol,
                          maxiter=4 * TA.shape[0])
        r32 = b - TA.to_dense().numpy() @ x32.double().numpy()
        assert np.linalg.norm(r32) > np.linalg.norm(r)

    def test_cheaper_outer_count_than_inner_iterations(self, system):
        JA, TA, b = system
        tol = 1e-9 * float(np.linalg.norm(b))
        (_, ij), (_, info) = _both(JA, TA, b, tol=tol, low_dtype="float32")
        _same_f64_f32(ij, info)
        assert info.converged and info.refinements <= 6
        assert info.inner_iterations > info.refinements
        assert len(info.inner_infos) == info.refinements

    def test_explicit_low_operator_other_layout(self, system):
        """A_low in another layout (CSR high residuals, DIA low inner solves)."""
        JA, TA, b = system
        tol = 1e-9 * float(np.linalg.norm(b))
        jlo = JDIA.from_csr(JA).astype(jnp.float32)
        tlo = DIAMatrix.from_csr_host(TA.data.numpy(), TA.indices.numpy(), TA.indptr.numpy(),
                                      TA.shape, device=CPU).astype(torch.float32)
        _, ij = jcg.refined_cg_solve(JA, jnp.asarray(b), tol=tol, A_low=jlo)
        x, info = refined_cg_solve(TA, torch.from_numpy(b), tol=tol, A_low=tlo)
        _same_f64_f32(ij, info)
        assert info.converged
        assert np.linalg.norm(b - TA.to_dense().numpy() @ x.numpy()) <= tol

    def test_preconditioned_inner(self, system):
        JA, TA, b = system
        tol = 1e-9 * float(np.linalg.norm(b))
        inv = (1.0 / np.asarray(JA.diagonal())).astype(np.float32)
        jinv, tinv = jnp.asarray(inv), torch.from_numpy(inv)
        _, ij = jcg.refined_cg_solve(JA, jnp.asarray(b), tol=tol, low_dtype=jnp.float32,
                                     M=lambda v: jinv.astype(v.dtype) * v)
        x, info = refined_cg_solve(TA, torch.from_numpy(b), tol=tol, low_dtype=torch.float32,
                                   M=lambda v: tinv.to(v.dtype) * v)
        _same_f64_f32(ij, info)
        assert info.converged
        assert np.linalg.norm(b - TA.to_dense().numpy() @ x.numpy()) <= tol

    def test_x0_and_immediate_convergence(self, system):
        _, TA, b = system
        x_ref, _ = cg_solve(TA, torch.from_numpy(b), tol=1e-12)
        x, info = refined_cg_solve(TA, torch.from_numpy(b), x0=x_ref, tol=1e-6)
        assert info.converged and info.refinements == 0 and info.inner_iterations == 0
        assert torch.equal(x, x_ref)

    def test_tol_zero_rejected(self, system):
        _, TA, b = system
        with pytest.raises(ValueError, match="tol > 0"):
            refined_cg_solve(TA, torch.from_numpy(b), tol=0.0)

    def test_shape_mismatch_rejected(self, system):
        _, TA, b = system
        rows, cols, vals, shape = poisson2d_coo(8)
        lo = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device=CPU)
        with pytest.raises(ValueError, match="A_low shape"):
            refined_cg_solve(TA, torch.from_numpy(b), tol=1e-6, A_low=lo)

    @pytest.mark.parametrize("layout", ["csr", "bell", "symbell", "dia"])
    def test_bf16_inner_on_cpu(self, system, layout):
        """f32-high / bf16-low against the JAX package: equal converged,
        refinements within 1, inner iterations within 10%, both true
        residuals at or below 1.05 tol (the JAX test's bound; the true
        residual is recomputed in float64 from float32 x)."""
        JA, TA, b = system
        host = (TA.data.numpy(), TA.indices.numpy(), TA.indptr.numpy(), TA.shape)
        jhost = tuple(np.asarray(a) for a in (JA.data, JA.indices, JA.indptr)) + (JA.shape,)
        if layout == "csr":
            jop, top = JA.astype(jnp.float32), TA.astype(torch.float32)
        elif layout == "bell":
            jop = JBell.from_csr_host(*jhost, bm=8, bn=128).astype(jnp.float32)
            top = BlockedEllMatrix.from_csr_host(*host, bm=8, bn=128, device=CPU,
                                                 dtype=np.float32)
        elif layout == "symbell":
            jop = JSymBell.from_csr_host(*jhost, bn=32).astype(jnp.float32)
            top = SymBellMatrix.from_csr_host(*host, bn=32, device=CPU, dtype=np.float32)
        else:
            jop = JDIA.from_csr_host(*jhost).astype(jnp.float32)
            top = DIAMatrix.from_csr_host(*host, device=CPU, dtype=np.float32)
        b32 = b.astype(np.float32)
        tol = 1e-5 * float(np.linalg.norm(b32))
        xj, ij = jcg.refined_cg_solve(jop, jnp.asarray(b32), tol=tol, low_dtype=jnp.bfloat16)
        xt, it = refined_cg_solve(top, torch.from_numpy(b32), tol=tol, low_dtype=torch.bfloat16)
        assert it.converged == ij.converged is True
        assert abs(it.refinements - ij.refinements) <= 1
        assert abs(it.inner_iterations - ij.inner_iterations) <= 0.1 * ij.inner_iterations
        dense = TA.to_dense().numpy()
        for x in (np.asarray(xj, np.float64), xt.double().numpy()):
            assert np.linalg.norm(b32.astype(np.float64) - dense @ x) <= 1.05 * tol

    def test_stagnation_reports_unconverged(self, system):
        JA, TA, b = system
        b32 = b.astype(np.float32)
        _, ij = jcg.refined_cg_solve(JA.astype(jnp.float32), jnp.asarray(b32), tol=1e-30,
                                     low_dtype=jnp.bfloat16, max_refinements=50)
        _, info = refined_cg_solve(TA.astype(torch.float32), torch.from_numpy(b32), tol=1e-30,
                                   low_dtype=torch.bfloat16, max_refinements=50)
        assert not info.converged and not ij.converged
        assert info.refinements < 50
        assert abs(info.refinements - ij.refinements) <= 1

    def test_exports(self):
        import conjugategradient_tpu_torch as tcg

        for name in ("refined_cg_solve", "RefineInfo"):
            assert name in tcg.__all__ and name in solver.__all__
            assert getattr(tcg, name) is getattr(solver, name)


# ---- cg_solve on bfloat16 operators (tests/test_solver_api.py:164-183) -------

@pytest.mark.parametrize("vectors", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["csr", "bell", "symbell", "dia"])
def test_cg_solve_on_bf16_operators_matches_jax(layout, vectors):
    """cg_solve on a bfloat16 operator with float32 or bfloat16 vectors:
    the result in the vectors' dtype, finite, and within 1e-2 of the JAX
    package's x in the float32 case (equal iteration counts within 10%);
    bfloat16 vectors (the JAX test's b / 100, tol 1e-1, 400 steps): finite
    x in bf16 in both packages, their true residuals within 2x."""
    path = ROOT / "problems" / "poisson2d_34.mtx"
    jop = jcg.load_matrix(str(path), layout=layout, dtype=jnp.bfloat16)
    top = load_matrix(path, layout=layout, dtype=torch.bfloat16, device=CPU)
    n = top.shape[0]
    b = np.asarray(reference_rhs(n), np.float32)
    dense = load_matrix(path, layout="csr", dtype=np.float64, device=CPU).to_dense().numpy()
    if vectors == "float32":
        tol = 1e-3 * float(np.linalg.norm(b))
        xj, ij = jcg.cg_solve(jop, jnp.asarray(b), tol=tol)
        xt, it = cg_solve(top, torch.from_numpy(b), tol=tol)
        assert xt.dtype == torch.float32
        assert bool(it.converged) == bool(ij.converged) is True
        assert abs(int(it.iterations) - int(ij.iterations)) <= 0.1 * int(ij.iterations)
    else:
        bb = np.asarray(jnp.asarray(b, jnp.bfloat16) / 100)
        xj, ij = jcg.cg_solve(jop, jnp.asarray(bb), tol=1e-1, maxiter=400)
        xt, it = cg_solve(top, torch.from_numpy(bb.astype(np.float32)).to(torch.bfloat16),
                          tol=1e-1, maxiter=400)
        assert xt.dtype == torch.bfloat16 and xj.dtype == jnp.bfloat16
        b = bb.astype(np.float32)
    xj = np.asarray(jnp.asarray(xj).astype(jnp.float64))
    xt = xt.double().numpy()
    assert np.isfinite(xt).all() and np.isfinite(xj).all()
    rt = np.linalg.norm(b - dense @ xt)
    rj = np.linalg.norm(b - dense @ xj)
    assert rt <= 2 * rj + 1e-3 * np.linalg.norm(b) and rj <= 2 * rt + 1e-3 * np.linalg.norm(b)
