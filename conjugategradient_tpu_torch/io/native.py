"""ctypes bindings to the native C++ MatrixMarket parser (native/mm_reader.cpp).

The reference's parser is native C++ (test/mm_reader.cpp); ours is too, but
exposed through a minimal C ABI instead of being compiled into a harness
binary.  Two-call protocol:

1. ``cg_mm_open(path, &handle, &nrows, &ncols, &nnz_expanded)`` parses the
   file, expands symmetry, sorts, and builds CSR in native memory.
2. ``cg_mm_fill(handle, data*, indices*, indptr*)`` copies into caller
   buffers; ``cg_mm_close(handle)`` frees.

If the shared library hasn't been built (``make -C native``), ``available()``
returns False and callers fall back to the pure-Python reader.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_NAME = "libcgtpu_io.so"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", _LIB_NAME)


def _sources_newer_than(lib_path: str) -> bool:
    """True if any native/*.cpp is newer than the built library — a stale
    binary would silently shadow source edits (round-1 advisor finding)."""
    try:
        lib_mtime = os.path.getmtime(lib_path)
        src_dir = os.path.dirname(lib_path)
        for f in os.listdir(src_dir):
            if f.endswith(".cpp") and os.path.getmtime(
                os.path.join(src_dir, f)
            ) > lib_mtime:
                return True
    except OSError:
        pass
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = _lib_path()
    if not os.path.exists(path):
        _load_failed = True
        return None
    if _sources_newer_than(path):
        import warnings

        warnings.warn(
            f"{path} is older than the C++ sources next to it; falling back "
            "to the Python reader — rebuild with `make -C native`",
            stacklevel=3,
        )
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.cg_mm_open.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.cg_mm_open.restype = ctypes.c_int
        lib.cg_mm_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.cg_mm_fill.restype = ctypes.c_int
        lib.cg_mm_close.argtypes = [ctypes.c_void_p]
        lib.cg_mm_close.restype = None
        lib.cg_mm_error.argtypes = [ctypes.c_void_p]
        lib.cg_mm_error.restype = ctypes.c_char_p
        lib.cg_ell_plan.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.cg_ell_plan.restype = ctypes.c_int
        for name, valty in (
            ("cg_ell_pack_f32", ctypes.c_float),
            ("cg_ell_pack_f64", ctypes.c_double),
        ):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(valty),
                ctypes.POINTER(ctypes.c_int32),
            ]
            fn.restype = ctypes.c_int
        lib.cg_amg_aggregate.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.cg_amg_aggregate.restype = ctypes.c_int64
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def read_mtx_csr_native(path, dtype=np.float64):
    """Parse via the C++ library. Returns (data, indices, indptr, shape)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native mm_reader library not built (run `make -C native`)")
    handle = ctypes.c_void_p()
    nrows = ctypes.c_int64()
    ncols = ctypes.c_int64()
    nnz = ctypes.c_int64()
    rc = lib.cg_mm_open(
        str(path).encode(),
        ctypes.byref(handle),
        ctypes.byref(nrows),
        ctypes.byref(ncols),
        ctypes.byref(nnz),
    )
    if rc != 0:
        msg = lib.cg_mm_error(handle) if handle else b"open failed"
        lib.cg_mm_close(handle)
        raise ValueError(f"mm_reader: {msg.decode() if msg else 'parse error'}: {path}")
    try:
        data = np.empty(nnz.value, dtype=np.float64)
        indices = np.empty(nnz.value, dtype=np.int32)
        indptr = np.empty(nrows.value + 1, dtype=np.int64)
        rc = lib.cg_mm_fill(
            handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc != 0:
            raise ValueError(f"mm_reader: fill failed for {path}")
    finally:
        lib.cg_mm_close(handle)
    if dtype is not np.float64:
        data = data.astype(dtype)
    return data, indices, indptr, (nrows.value, ncols.value)


def ell_pack_native(data, indices, indptr, shape, bm: int, bn: int, dtype=np.float32):
    """Native CSR -> blocked-ELL pack.  Returns (blocks, block_cols, nnz).

    blocks: (nrb, kmax, bm, bn) ``dtype``; block_cols: (nrb, kmax) int32.
    Falls back is the caller's job (``available()`` gate).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (run `make -C native`)")
    data = np.ascontiguousarray(data, dtype=np.float64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    nrows, ncols = shape
    nrb = ctypes.c_int64()
    kmax = ctypes.c_int64()
    rc = lib.cg_ell_plan(
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nrows, ncols, bm, bn,
        ctypes.byref(nrb), ctypes.byref(kmax),
    )
    if rc != 0:
        raise ValueError("cg_ell_plan failed")
    out_dtype = np.dtype(dtype)
    if out_dtype == np.float32:
        pack, cty = lib.cg_ell_pack_f32, ctypes.c_float
    elif out_dtype == np.float64:
        pack, cty = lib.cg_ell_pack_f64, ctypes.c_double
    else:
        raise ValueError(f"native pack supports f32/f64, not {out_dtype}")
    blocks = np.empty((nrb.value, kmax.value, bm, bn), dtype=out_dtype)
    block_cols = np.empty((nrb.value, kmax.value), dtype=np.int32)
    rc = pack(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nrows, ncols, bm, bn, kmax.value,
        blocks.ctypes.data_as(ctypes.POINTER(cty)),
        block_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError("cg_ell_pack failed (plan/pack mismatch)")
    return blocks, block_cols, int(len(data))


def amg_aggregate_native(indptr, indices, n: int):
    """Greedy Vanek aggregation via the C++ library (native/amg_agg.cpp).

    Returns ``(agg, n_agg)`` identical to the pure-Python
    solver/amg._aggregate_py (tests assert bitwise equality); measured
    470x faster at 1M rows (5.35 s -> 11 ms, poisson2d-1024 strength
    graph).  Raises RuntimeError when the library is not built — callers
    fall back to Python.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built (run `make -C native`)"
        )
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if len(indptr) != n + 1:
        raise ValueError(f"indptr length {len(indptr)} != n+1 ({n + 1})")
    agg = np.empty(n, dtype=np.int64)
    n_agg = lib.cg_amg_aggregate(
        ctypes.c_int64(n),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        agg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return agg, int(n_agg)
