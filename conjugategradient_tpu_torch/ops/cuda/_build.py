"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source to an object for ``sm_90a`` (Hopper), all
sources at once in parallel processes, and links them into one shared
library with a plain C interface, which :func:`load_library` opens with
ctypes — no PyTorch headers, so a build takes seconds.  The library is
keyed by a hash of the sources and flags, so an edited kernel is rebuilt
and a stale one is never loaded.  Nothing here runs at import time: the
first call to :func:`load_library` builds, later calls reuse the handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
#: build outputs (listed in .gitignore)
BUILD_DIR = _PKG_DIR.parent / "build" / "cuda"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double
# argtypes of each C entry point (csrc/*.cu); every pointer is c_void_p so
# ctypes never truncates it to 32 bits
SIGNATURES = {
    "cg_sym_dir_banded": [_P] * 14 + [_I, _I, _I, _P],
    "cg_sym_dir_general": [_P] * 16 + [_I, _I, _I, _I, _I, _P],
    "cg_full_dir": [_P] * 13 + [_I, _I, _I, _I, _P],
    "cg_full_dir_packed": [_P] * 15 + [_I64, _P],
    "cg_update": [_P] * 15 + [_I, _I64, _I, _P],
    "cg_bell_spmv_dot": [_P] * 3 + [_I64] + [_P] * 5 + [_I] * 4 + [_P],
    "cg_bell_spmv": [_P] * 4 + [_I64, _I, _I, _I, _P],
    "cg_bell_spmv_packed": [_P] * 6 + [_I64, _P],
    "cg_dia_spmv": [_P] * 4 + [_I64, _I64, _I, _P],
    "cg_sym_dia_spmv": [_P] * 4 + [_I64, _I, _P],
    "cg_stencil7_f32": [_P] * 2 + [_I] * 3 + [_F, _F, _I, _P],
    "cg_stencil7_f64": [_P] * 2 + [_I] * 3 + [_D, _D, _I, _P],
    "cg_fused_stencil_dir": [_P] * 10 + [_I] * 3 + [_F, _F, _I, _P],
    "minres_full_dir": [_P] * 20 + [_I] * 4 + [_P],
    "minres_sym_dir_banded": [_P] * 21 + [_I] * 3 + [_P],
    "minres_sym_dir_general": [_P] * 23 + [_I] * 5 + [_P],
    "minres_update": [_P] * 13 + [_I, _I64, _I, _P],
    "minres_shard_dir": [_P] * 16 + [_I64] + [_I] * 4 + [_P],
    "minres_dir_packed": [_P] * 22 + [_I64, _P],
    "bicgstab_dir": [_P] * 17 + [_I] * 4 + [_P],
    "bicgstab_s": [_P] * 19 + [_I] * 4 + [_P],
    "bicgstab_dir_packed": [_P] * 19 + [_I64, _P],
    "bicgstab_s_packed": [_P] * 21 + [_I64, _P],
    "bicgstab_update": [_P] * 15 + [_I, _I64, _I, _P],
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built on the machine that has the GPU"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcgtorch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these exact sources is
    already built; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    # compile into a private directory and link to a temporary name, then
    # rename: a concurrent or interrupted build never leaves a half-written
    # library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                  for s, o in zip(cu, objs)])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build on first use and open the kernel library (cached handle)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
