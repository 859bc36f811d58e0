"""The port's multi-RHS SpMVs (``ops/spmv.py``'s ``*_spmv_multi``) against
the JAX package's, on the same numpy inputs (CPU).

Tolerances, with their reasons: float64 within 1e-12 of max|Y| (the two
packages contract the tile products in another order); float32 within
1e-5 of max|Y| (XLA:CPU may fuse a multiply-add pair where the port rounds
twice, ``tests/test_torch_dia.py``'s bound).  Each column also agrees with
the port's single-RHS plain SpMV on that column to the same bound: the
DIA forms run the same operations, so there it is bit-equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conjugategradient_tpu.ops import spmv as jspmv
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu.types import SellMatrix as JSell
from conjugategradient_tpu.types import SymBellMatrix as JSymBell
from conjugategradient_tpu.types import SymDIAMatrix as JSymDIA
from conjugategradient_tpu_torch import ops as tops
from conjugategradient_tpu_torch.ops import spmv as tspmv
from conjugategradient_tpu_torch.problems import banded_spd_coo, powerlaw_spd_coo
from conjugategradient_tpu_torch.types import (BlockedEllMatrix, CSRMatrix, DIAMatrix,
                                               SellMatrix, SymBellMatrix, SymDIAMatrix)

CPU = "cpu"
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
NRHS = (1, 3, 8)
N_RAGGED = 203  # not a multiple of any tile width


def _spd(n=N_RAGGED, bandwidth=7, seed=0):
    rows, cols, vals, shape = banded_spd_coo(n, bandwidth=bandwidth, seed=seed)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def _pair_csr(a, dtype):
    return JCSR.from_scipy(a, dtype=dtype), CSRMatrix.from_scipy(a, dtype=dtype, device=CPU)


def _bell(a, dtype, bm, bn):
    jc, tc = _pair_csr(a, dtype)
    return JBell.from_csr(jc, bm=bm, bn=bn), BlockedEllMatrix.from_csr(tc, bm=bm, bn=bn)


def _symbell(a, dtype, bn):
    jc, tc = _pair_csr(a, dtype)
    return (JSymBell.from_bell(JBell.from_csr(jc, bm=bn, bn=bn)),
            SymBellMatrix.from_csr(tc, bm=bn, bn=bn))


def _sell(a, dtype):
    jc, tc = _pair_csr(a, dtype)
    return JSell.from_csr(jc), SellMatrix.from_csr(tc)


def _dia_far(dtype, n=N_RAGGED, seed=3):
    """A DIA operator with offsets beyond n on both sides (their slots are
    read from the padding and never reach a row), ncols = n."""
    rng = np.random.default_rng(seed)
    offsets = (-n - 4, -5, -1, 0, 2, 9, n + 3)
    diags = rng.standard_normal((len(offsets), n)).astype(dtype)
    shape = (n, n)
    return (JDIA(diags, offsets, shape, int(diags.size)),
            DIAMatrix(torch.from_numpy(diags), offsets, shape, int(diags.size)))


def _symdia_far(dtype, n=N_RAGGED, seed=4):
    rng = np.random.default_rng(seed)
    offsets = (0, 1, 6, n + 2)
    diags = rng.standard_normal((len(offsets), n)).astype(dtype)
    for d, off in enumerate(offsets):  # the stored slots past the end are zero
        diags[d, max(n - off, 0):] = 0
    shape = (n, n)
    return (JSymDIA(diags, offsets, shape, int(diags.size)),
            SymDIAMatrix(torch.from_numpy(diags), offsets, shape, int(diags.size)))


def _dia(a, dtype):
    jc, tc = _pair_csr(a, dtype)
    return JDIA.from_csr(jc), DIAMatrix.from_csr(tc)


def _symdia(a, dtype):
    jc, tc = _pair_csr(a, dtype)
    return JSymDIA.from_csr(jc), SymDIAMatrix.from_csr(tc)


def _powerlaw():
    rows, cols, vals, shape = powerlaw_spd_coo(311, avg_degree=3.5, seed=2)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


# form name -> (form, a function of the dtype that makes the JAX and port operators)
FORMS = {
    "bell-8x8": ("bell", lambda dt: _bell(_spd(), dt, 8, 8)),
    "bell-16x32": ("bell", lambda dt: _bell(_spd(), dt, 16, 32)),
    "symbell-8": ("symbell", lambda dt: _symbell(_spd(), dt, 8)),
    "symbell-32": ("symbell", lambda dt: _symbell(_spd(bandwidth=40), dt, 32)),
    "sell": ("sell", lambda dt: _sell(_powerlaw(), dt)),
    "dia": ("dia", lambda dt: _dia(_spd(), dt)),
    "dia-far": ("dia", _dia_far),
    "symdia": ("symdia", lambda dt: _symdia(_spd(), dt)),
    "symdia-far": ("symdia", _symdia_far),
}
JAX_MULTI = {"bell": jspmv.bell_spmv_multi, "symbell": jspmv.sym_bell_spmv_multi,
             "sell": jspmv.sell_spmv_multi, "dia": jspmv.dia_spmv_multi,
             "symdia": jspmv.sym_dia_spmv_multi}
PORT_MULTI = {"bell": tspmv.bell_spmv_multi, "symbell": tspmv.sym_bell_spmv_multi,
              "sell": tspmv.sell_spmv_multi, "dia": tspmv.dia_spmv_multi,
              "symdia": tspmv.sym_dia_spmv_multi}
PORT_SINGLE = {"bell": lambda a, x: tspmv.bell_spmv(a, x, use_kernel="never"),
               "symbell": lambda a, x: tspmv.sym_bell_spmv(a, x, use_kernel="never"),
               "sell": tspmv.sell_spmv,
               "dia": lambda a, x: tspmv.dia_spmv(a, x, use_kernel="never"),
               "symdia": lambda a, x: tspmv.sym_dia_spmv(a, x, use_kernel="never")}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("R", NRHS)
@pytest.mark.parametrize("case", list(FORMS))
def test_multi_matches_jax_and_the_single_rhs_form(case, R, dtype):
    form, build = FORMS[case]
    ja, ta = build(dtype)
    n = ta.shape[1]
    X = np.random.default_rng(R).standard_normal((n, R)).astype(dtype)
    Y = PORT_MULTI[form](ta, torch.from_numpy(X))
    assert Y.shape == (ta.shape[0], R) and Y.dtype == torch.from_numpy(X).dtype
    Yj = np.asarray(JAX_MULTI[form](ja, X))
    scale = max(np.abs(Yj).max(), 1e-300)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=0, atol=RTOL[dtype] * scale)
    for j in range(R):
        y = PORT_SINGLE[form](ta, torch.from_numpy(np.ascontiguousarray(X[:, j])))
        if form in ("dia", "symdia"):
            assert torch.equal(Y[:, j], y), j  # the same operations, column by column
        else:
            np.testing.assert_allclose(Y[:, j].numpy(), y.numpy(), rtol=0,
                                       atol=RTOL[dtype] * scale)


def test_sym_bell_multi_repeats_bit_for_bit():
    _, ta = _symbell(_spd(bandwidth=40), np.float64, 32)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal((N_RAGGED, 4)))
    assert torch.equal(tspmv.sym_bell_spmv_multi(ta, X), tspmv.sym_bell_spmv_multi(ta, X))


def test_ops_exports_the_jax_multi_forms():
    from conjugategradient_tpu import ops as jops

    for name in ("bell_spmv_multi", "dia_spmv_multi", "sell_spmv_multi"):
        assert name in jops.__all__ and name in tops.__all__
        assert getattr(tops, name) is getattr(tspmv, name)
