#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``conjugategradient_tpu_torch``)
on one NVIDIA GPU.

Usage, from the repository root: ``python3 chip_smoke.py``

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``conjugategradient_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel).
2. Hold each of the fifteen kernels against its plain-torch version on the
   card, at the main paths' shapes (128 x 128 tiles on the n = 262,144
   block-tridiagonal operator and on poisson3d_48; 8 x 128 tiles on
   poisson3d_48 for the SpMV; the JAX package's symdia-big operator,
   n = 2,097,152 with 41 diagonals, in full and symmetric DIA storage, and
   poisson3d_48 as DIA; the 256^3 stencil of BASELINE config 4 in float32
   and float64) and at small ragged shapes, and time both, beside one
   library call (cuSPARSE ``torch.sparse_csr_tensor @ x`` for the SpMVs,
   cuDNN ``conv3d`` with TF32 off for the stencil) and the least time the
   card could take for each kernel's bytes.  ``stencil7``,
   ``fused_stencil_dir_dot`` (p_new, q) and ``fused_update_dot(_pcg)``
   (x', r'; also at lengths 210, 4097 and 256^3) must be bit-equal to
   their plain versions; a NaN put into the stencil's input reaches only its point and
   its six neighbours.  The fused MINRES kernels (full storage, symmetric
   storage with the banded and the general landing, the update; with and
   without the Jacobi diagonal, shift 0 and not 0, a first step without a
   pending update) give v, w, x' and r2' bit-equal, q and the dots within
   the stated tolerances, repeat bit for bit, and their last CTAs' scalar
   steps agree with the plain versions' torch ops to ``TAIL_ULPS``.  The
   fused BiCGStab kernels, on bench.py's bicgstab-bell operator (n =
   262,144, 128 x 128, nonsymmetric), on the timed path's convection-
   diffusion operator (nx = 512, kmax 5, padding slots on column block 0;
   kernels 18 and 19 timed there too) and at a ragged nrb = 13 with bn = 32
   and 64 (with and without the Jacobi diagonal, with alpha, beta and omega
   0, and with a NaN alpha and omega, which their tails clamp to 0 so that
   the next update is a no-op; the update kernel at lengths 210, 4097 and
   n): p', p^, s, s^, x_h, x' and r' bit-equal, v', t and the dots within
   the stated tolerances, two launches bit-identical, the tails within
   ``TAIL_ULPS``.
3. Drive the blocked-ELL path through its entry points, with the launch
   counters reset just before and read just after: the tester on
   ``problems/poisson3d_48.mtx`` and ``problems/elasticity3d_16.mtx`` in
   both blocked layouts (symbell and bell, float32, plain CG and Jacobi
   PCG); the n = 262,144 operator in both storages for 256 timed steps;
   the fused solves against the plain-torch loop on the same card, and
   twice against themselves (bitwise); the portable loop on
   ``load_matrix(layout="bell")`` (8 x 128 tiles); residual replacement
   every 8 steps on the fused symmetric and full solves and the portable
   loop, against the same solves run by the plain versions on the CPU; one
   x0 warm start; the tester's default CSR float64 path twice (bitwise).
   Then the DIA / SELL path, with its own reset and read: the tester with
   ``--layout auto`` (resolves to DIA) and ``--layout symdia --precond
   jacobi`` on poisson3d_48, ``--layout auto --reorder`` on powerlaw_1138
   (SELL), the float64 ``--layout auto`` tester on poisson2d_34 twice
   (bitwise); CG on symdia-big in both storages for 64 timed steps; a
   float32 DIA solve twice (bitwise) and against the plain versions on the
   CPU (trajectory, with and without residual replacement).
   Then the stencil path, with its own reset and read: the tester on
   ``stencil:64`` float32 (the fused stencil CG), on ``stencil:48``
   float64 twice (bitwise), and with ``--precond jacobi`` and ``--precond
   amg`` (both smoothers); at 256^3 the fused stencil CG for 256 timed
   steps (and its busy share over 64), the portable loop, and bench.py's
   mgpcg comparison (plain fused CG against MG-PCG with each smoother, to
   1e-5 ||b||); residual replacement against the CPU's plain versions on
   64^3 and a ragged 33 x 35 x 37 grid; one x0 warm start.
   Then the MINRES path, with its own reset and read: the tester with
   ``--method minres`` on poisson3d_48 (symbell and bell, float32, with and
   without Jacobi), once with ``--shift`` inside the spectrum, and on CSR
   float64 twice (bitwise); the n = 262,144 operator in both storages for
   256 timed steps (bench.py's minres protocol, b = arange(1, n+1)/n), the
   busy share over 64, and the portable MINRES loop beside it; the fused
   solve against the portable loop and twice against itself (bitwise); an
   indefinite solve (shift between the Lanczos Ritz extremes) in both
   storages; caps of 1, 2 and 7 steps against the portable loop; b = 0;
   one x0 warm start.
   Then the BiCGStab path, with its own reset and read: the tester with
   ``--method bicgstab`` on the general ``problems/convdiff_34.mtx`` (bell
   float32, dia float32 with Jacobi, auto, CSR float64 twice, bitwise),
   each float32 line run again through ``bicgstab_solve`` on the card (the
   same history; its true residual held to the residual-gap law that a
   sweep of renumbered host solves reads) and on the host (where the two
   trajectories part);
   ``bicgstab_solve(fused="always")`` on the bicgstab-bell operator, which
   ends in a few steps, against the portable loop's flags; the steady-state
   timing on bench.py's convection-diffusion operator at nx = 512 (n =
   262,144) as full 128 x 128 blocked-ELL, 256 live steps at tol = 0, fused
   and portable, with the busy share and the three kernels' device times;
   the portable loop on bench.py's DIA lane (nx = 2048, n = 4,194,304) for
   64 steps; fused against portable over 25 steps and twice against itself
   (bitwise); the skew breakdown; the half-step exit; caps of 1, 2 and 7;
   b = 0; one x0 warm start.
   The portable loops end at convergence: the steps launched are counted
   against the iterations for MG-PCG at 256^3, a portable DIA solve and a
   portable BiCGStab solve.
4. Check that every kernel launched during its path and that no plain
   version was given a CUDA tensor there; print the kernel table as JSON
   (a kernel's launches summed over the paths that run it).

``python3 chip_smoke.py --fused-cg-only`` runs nothing but the fused CG
loops at n = 262,144 (both storages) and at 256^3 and prints their ms/it
and a hash of each history: for comparing two trees on one card.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result.  Times are CUDA-event times, and kernel device times from
torch.profiler, on this card.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FUSED_SOURCE = "conjugategradient_tpu_torch/csrc/fused_cg.cu"
MINRES_SOURCE = "conjugategradient_tpu_torch/csrc/fused_minres.cu"
BICGSTAB_SOURCE = "conjugategradient_tpu_torch/csrc/fused_bicgstab.cu"
SOURCES = {
    "sym_fused_dir_spmv_dot": FUSED_SOURCE,
    "fused_dir_spmv_dot": FUSED_SOURCE,
    "fused_update_dot": FUSED_SOURCE,
    "fused_update_dot_pcg": FUSED_SOURCE,
    "bell_spmv": "conjugategradient_tpu_torch/csrc/bell_spmv.cu",
    "dia_spmv": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
    "sym_dia_spmv": "conjugategradient_tpu_torch/csrc/dia_spmv.cu",
    "stencil7": "conjugategradient_tpu_torch/csrc/stencil.cu",
    "fused_stencil_dir_dot": "conjugategradient_tpu_torch/csrc/fused_stencil.cu",
    "minres_dir_spmv_dot": MINRES_SOURCE,
    "sym_minres_dir_spmv_dot": MINRES_SOURCE,
    "minres_update_dot": MINRES_SOURCE,
    "bicgstab_dir_spmv_dot": BICGSTAB_SOURCE,
    "bicgstab_s_spmv_dot": BICGSTAB_SOURCE,
    "bicgstab_update_dot": BICGSTAB_SOURCE,
}
REPLACES = {
    "sym_fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:338",
    "fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:111",
    "fused_update_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:608 (fused_update_dot), "
                        "conjugategradient_tpu/ops/pallas/fused_stencil.py:150 "
                        "(fused_update_dot_3d)",
    "fused_update_dot_pcg": "conjugategradient_tpu/ops/pallas/fused_cg.py:555",
    "bell_spmv": "conjugategradient_tpu/ops/pallas/ell_spmv.py:57",
    "dia_spmv": "conjugategradient_tpu/ops/pallas/dia_spmv.py:181 (dia_spmv_pallas), "
                "dia_spmv.py:130 (dia_spmv_pallas_2d), "
                "dia_spmv.py:398 (dia_spmv_pallas_blocked)",
    "sym_dia_spmv": "conjugategradient_tpu/ops/pallas/dia_spmv.py:304",
    "stencil7": "conjugategradient_tpu/ops/pallas/stencil.py:136",
    "fused_stencil_dir_dot": "conjugategradient_tpu/ops/pallas/fused_stencil.py:69",
    "minres_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:113",
    "sym_minres_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:298",
    "minres_update_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:425",
    "bicgstab_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:84",
    "bicgstab_s_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:200",
    "bicgstab_update_dot": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:293",
}
BLOCKED_KERNELS = ("sym_fused_dir_spmv_dot", "fused_dir_spmv_dot", "fused_update_dot",
                   "fused_update_dot_pcg", "bell_spmv")
DIA_KERNELS = ("dia_spmv", "sym_dia_spmv")
STENCIL_KERNELS = ("stencil7", "fused_stencil_dir_dot", "fused_update_dot")
MINRES_KERNELS = ("minres_dir_spmv_dot", "sym_minres_dir_spmv_dot", "minres_update_dot",
                  "bell_spmv")
BICGSTAB_KERNELS = ("bicgstab_dir_spmv_dot", "bicgstab_s_spmv_dot", "bicgstab_update_dot",
                    "bell_spmv", "dia_spmv")
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 rate, and
# float32 and float64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# BASELINE config 4: the 7-point Poisson stencil on a 256^3 grid
STENCIL_GRID = (256, 256, 256)
STENCIL_SMALL = ((5, 6, 7), (3, 9, 130), (2, 2, 2))
STENCIL_STEPS = 256
F32_TRUE_REL_FLOOR = 2e-2  # ||b - Ax|| / ||b|| after a float32 256^3 solve
# the JAX package's symdia-big operator (bench.py bench_symdia_big)
SYMDIA_N = 1 << 21
SYMDIA_OFFSETS = tuple(k * 1024 for k in range(21))
DIA_STEPS = 64
# stated tolerances (f32 sum order differs between kernel and plain version)
TOL_ELEMWISE = 1e-6  # p_new, x', r': rtol of max|plain|
TOL_Q = 1e-5  # q: of max|q|
TOL_DOT = 1e-5  # pap, rnorm, rho: relative
TOL_SOLVE_REL = 1e-5  # solve tolerance: 1e-5 * ||b||
REL_ERROR_BOUND = 1e-8  # tester rel_error = ||b - Ax||^2 / ||x||^2
TRAJ_RTOL = 5e-2  # fused vs plain rho_history over 25 steps
RESTART_RTOL = 2e-3  # card vs CPU plain versions, 32 steps with restarts
RESTART_EVERY = 8
ITER_SLACK = 8
TAIL_ULPS = 2  # the kernels' scalar steps against torch 0-d ops, per slot
MINRES_TRAJ_RTOL = 5e-3  # fused vs portable MINRES rnorm_history over 25 steps
MINRES_STEPS = 256
# an indefinite float32 solve to 1e-4 ||b||: the true residual may exceed the
# estimate by this factor (MINRES loses ~eps * kappa^2 in its w recurrence)
MINRES_INDEF_TOL_REL = 1e-4
MINRES_TRUE_FACTOR = 10.0
# a portable loop launches at most this many steps after the one that set
# done (solver/restart.py: LOOKAHEAD - 1)
STEPS_AFTER_DONE = 3
# BiCGStab: bench.py:1367's operator ends in ~4 steps (kappa ~ 1.015); the
# timed convection-diffusion runs BICG_STEPS live steps at tol = 0
BICG_BENCH_MAX_K = 4
BICG_STEPS = 256
BICG_DIA_STEPS = 64
# fused vs portable BiCGStab rnorm_history over 25 f32 steps: 5e-3 over the
# first 10 (the JAX package's bound for its two loops), 5e-2 over steps
# 11-15, and finite after: the two loops' sums run in another order and its
# products amplify that.  On the card, convdiff nx=512 parts by 1.2e-2 at
# step 21 and then spikes (273 against 12.2 at step 23); nx=64 by 3e-3 at
# step 15, 1.4e-2 at 16, 0.11 at 19
BICG_TRAJ_RTOL = 5e-3
BICG_TRAJ_MID_RTOL = 5e-2
# float32 BiCGStab's true residual stalls at the residual gap, a multiple
# of eps * max_k ||r_k||: the recurrence can spike to hundreds of ||b|| on
# convdiff_34, and where it does rel_error = ||b - Ax||^2 / ||x||^2 rises
# with the square of the spike.  bicg_gap_sweep reads the multiple on the
# host, over the tester's system with its unknowns renumbered (every sum
# then rounds another way), and each float32 tester line is held to
# REL_ERROR_BOUND, or where its own recurrence spiked to the gap law with
# GAP_ULPS (the run's true residual within tol + GAP_ULPS eps max_k ||r_k||)
GAP_ULPS = 64
GAP_SEEDS = 32
CONVDIFF = "problems/convdiff_34.mtx"
N_BIG = 262_144
MATRICES = ("problems/poisson3d_48.mtx", "problems/elasticity3d_16.mtx")
DEVICE = "cuda:0"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int = 10):
    """Device time per call: the sum of the CUDA kernels' own times in a
    torch.profiler trace of ``reps`` calls, or None if the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total_us += getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
    return total_us / 1e3 / reps if total_us > 0 else None


def kernel_profile(fn, top: int = 4):
    """One call under torch.profiler: (device ms, kernels launched, the
    ``top`` kernels by device time as (name, ms, count)), or None if the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            rows.append((e.key, us / 1e3, e.count))
    if not rows or sum(r[1] for r in rows) <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top]


def time_pair(kernel_fn, plain_fn) -> dict:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain): CUDA-event time per call (host work included) and profiler
    device time per call.  ``ms``/``plain_ms`` are the device times when the
    profiler saw them, else the event times."""
    ev = [cuda_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
    dk, dp = device_ms(kernel_fn), device_ms(plain_fn)
    ek, ep = min(ev[1], ev[2]), min(ev[0], ev[3])
    return {"ms": dk if dk is not None else ek,
            "plain_ms": dp if dp is not None else ep,
            "event_ms": ek, "plain_event_ms": ep,
            "device_ms": dk, "plain_device_ms": dp}


def rel_max_err(a, b) -> tuple:
    """(max |a - b|, max |b|)."""
    d = float((a.double() - b.double()).abs().max())
    return d, float(b.double().abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, flops: int, peak_flops: float = PEAK_F32_PER_S) -> dict:
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) over the HBM rate, or its
    operations over the rate for their type (float32 unless given),
    whichever is larger."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_ms(fn) -> float:
    """One PyTorch call's time, as ``time_pair`` reports a kernel's: device
    time when the profiler sees it, else CUDA-event time."""
    dm = device_ms(fn)
    return dm if dm is not None else cuda_ms(fn)


def csr_from_dia(a):
    """A DIA operator's nonzeros as a torch sparse CSR tensor (rows in
    order, columns ascending): the cuSPARSE yardstick's operand."""
    import torch

    n, ncols = a.shape
    cols = torch.arange(n, device=a.device)[:, None] + a.offsets_dev.long()[None, :]
    vals = a.diags.t()  # (n, ndiag): row i's entries in ascending column order
    keep = (cols >= 0) & (cols < ncols) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=a.device)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(), vals[keep], (n, ncols))


def csr_from_bell(a):
    """A full blocked-ELL operator's nonzeros as a torch sparse CSR tensor."""
    import torch

    nrb, kmax, bm, bn = a.blocks.shape
    n, ncols = a.shape
    dev = a.device
    order = torch.argsort(a.block_cols.long(), dim=1, stable=True)
    bcols = torch.gather(a.block_cols.long(), 1, order)
    vals = a.blocks[torch.arange(nrb, device=dev)[:, None], order].permute(0, 2, 1, 3)
    cols = (bcols[:, None, :, None] * bn
            + torch.arange(bn, device=dev)[None, None, None, :]).expand(nrb, bm, kmax, bn)
    keep = ((vals != 0) & (cols < ncols)).reshape(nrb * bm, kmax * bn)[:n]
    vals = vals.reshape(nrb * bm, kmax * bn)[:n]
    cols = cols.reshape(nrb * bm, kmax * bn)[:n]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(), vals[keep], (n, ncols))


def library_spmv(csr, x, y_kernel, label) -> float:
    """Time ``csr @ x`` (one cuSPARSE SpMV) and check it computes what the
    kernel computed, to TOL_Q of max|y| (another summation order)."""
    y = csr @ x
    e, m = rel_max_err(y, y_kernel)
    check(e <= TOL_Q * m, f"library SpMV {label}: differs from the kernel by {e} (max {m})")
    return library_ms(lambda: csr @ x)


# ---- phase 2: kernels against their plain versions -------------------------

def block_tridiag_ops(n, bn, device):
    """The n-row block-tridiagonal operator in full and in symmetric
    storage, from the same host tiles."""
    import torch

    from conjugategradient_tpu_torch.problems import block_tridiag_tiles
    from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix

    blocks, cols, nnz = block_tridiag_tiles(n, bn, bn, seed=0)
    full = BlockedEllMatrix(torch.from_numpy(blocks).to(device),
                            torch.from_numpy(cols).to(device), (n, n), nnz)
    sym = SymBellMatrix._pack_np(blocks, cols.astype(np.int64), (n, n), (n, n),
                                 nnz, check=False, device=device)
    return full, sym


def random_block_csr(rng, nrb, bm, bn, per_row, ncols=None):
    """Random block-sparse host CSR: SPD with square bn tiles (the shape of
    tests/test_symbell.py's _random_block_sym) when ``ncols`` is None, else
    a general (nrb*bm, ncols) pattern of bm x bn tiles."""
    n = nrb * bm
    A = np.zeros((n, n if ncols is None else ncols), np.float32)
    for i in range(nrb):
        if ncols is None:
            D = rng.standard_normal((bn, bn)).astype(np.float32)
            A[i * bn:(i + 1) * bn, i * bn:(i + 1) * bn] = D + D.T + 4 * bn * np.eye(bn, dtype=np.float32)
            hi = np.arange(i + 1, nrb)
            for c in rng.choice(hi, size=min(per_row, len(hi)), replace=False):
                B = rng.standard_normal((bn, bn)).astype(np.float32)
                A[i * bn:(i + 1) * bn, c * bn:(c + 1) * bn] = B
                A[c * bn:(c + 1) * bn, i * bn:(i + 1) * bn] = B.T
        else:
            for c in rng.choice(-(-ncols // bn), size=per_row, replace=False):
                hi = min((c + 1) * bn, ncols)
                A[i * bm:(i + 1) * bm, c * bn:hi] = rng.standard_normal((bm, hi - c * bn))
    rows, cols = np.nonzero(A)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return A[rows, cols], cols, indptr, A.shape


def random_block_sym(rng, nrb, bn, per_row, device):
    from conjugategradient_tpu_torch.types import SymBellMatrix
    from conjugategradient_tpu_torch.types.bell import pack_host_arrays

    data, cols, indptr, shape = random_block_csr(rng, nrb, bn, bn, per_row)
    blocks, bcols, nnz = pack_host_arrays(data, cols, indptr, shape, bn, bn)
    return SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), shape, shape,
                                  nnz, check=True, device=device)


def random_block_full(rng, nrb, bm, bn, per_row, device, ncols=None):
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    data, cols, indptr, shape = random_block_csr(rng, nrb, bm, bn, per_row, ncols)
    return BlockedEllMatrix.from_csr_host(data, cols, indptr, shape, bm=bm, bn=bn,
                                          device=device)


def load_symbell(path, device):
    from conjugategradient_tpu_torch import load_matrix

    return load_matrix(os.path.join(ROOT, path), layout="symbell",
                       dtype=np.float32, bn=128, device=device)


def load_bell(path, device, bm=128):
    from conjugategradient_tpu_torch import load_matrix

    return load_matrix(os.path.join(ROOT, path), layout="bell",
                       dtype=np.float32, bm=bm, bn=128, device=device)


def padded_inv_diag(a, rows):
    """1 / diag(A) padded with 1 to ``rows`` entries."""
    import torch

    d = (1.0 / a.diagonal()).reshape(-1)
    return torch.nn.functional.pad(d, (0, rows - d.numel()), value=1.0)


def check_k1(a, rng, mirror, with_d, row_group, errs, label):
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    nrb, bn = a.nrb, a.bn
    dev = a.device

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[0.37]], dtype=torch.float32, device=dev)
    pk, qk, papk = fc.sym_fused_dir_spmv_dot(
        a.diag_blocks, a.off_blocks, a.off_cols, r, pold, beta, d,
        mirror=mirror, row_group=row_group, mirror_src=a.mirror_src)
    pp, qp, papp = fc._sym_dir_plain(a.diag_blocks, a.off_blocks, a.off_cols, r, pold,
                                     beta, d, a.mirror_src, None, None)
    torch.cuda.synchronize()
    e_p, m_p = rel_max_err(pk, pp)
    e_q, m_q = rel_max_err(qk, qp)
    e_pap = abs(float(papk) - float(papp))
    check(e_p <= TOL_ELEMWISE * m_p, f"K1 {label}: p_new err {e_p} vs max {m_p}")
    check(e_q <= TOL_Q * m_q, f"K1 {label}: q err {e_q} vs max|q| {m_q}")
    check(e_pap <= TOL_DOT * abs(float(papp)), f"K1 {label}: pap {float(papk)} vs {float(papp)}")
    errs["sym_fused_dir_spmv_dot"] = max(errs["sym_fused_dir_spmv_dot"], e_p, e_q, e_pap)
    print(f"  K1 {label:<34} |dp|={e_p:.3g} |dq|={e_q:.3g} (max|q| {m_q:.4g}) "
          f"|dpap|={e_pap:.3g} (pap {float(papp):.6g})")
    return (r, pold, beta, d)


def check_k4(a, rng, with_d, beta_v, errs, label):
    """Kernel 4 against its plain version: p_new bit for bit, q and pap to
    the stated tolerances."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    nrb, bn = a.nrb, a.bn
    dev = a.device

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=dev)
    pk, qk, papk = fc.fused_dir_spmv_dot(a.blocks, a.block_cols, r, pold, beta, d)
    pp, qp, papp = fc._full_dir_plain(a.blocks, a.block_cols, r, pold, beta, d, None, None)
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(qk, qp)
    e_pap = abs(float(papk) - float(papp))
    check(torch.equal(pk, pp), f"K4 {label}: p_new not bit-equal to the plain version")
    check(e_q <= TOL_Q * m_q, f"K4 {label}: q err {e_q} vs max|q| {m_q}")
    check(e_pap <= TOL_DOT * abs(float(papp)), f"K4 {label}: pap {float(papk)} vs {float(papp)}")
    errs["fused_dir_spmv_dot"] = max(errs["fused_dir_spmv_dot"], e_q, e_pap)
    print(f"  K4 {label:<38} p_new bit-equal |dq|={e_q:.3g} (max|q| {m_q:.4g}) "
          f"|dpap|={e_pap:.3g} (pap {float(papp):.6g})")
    return r, pold, beta


def check_k5(a, rng, errs, label):
    """Kernel 5 against its plain version."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb

    x2d = torch.as_tensor(rng.standard_normal((a.padded_shape[1] // a.bn, a.bn)),
                          dtype=torch.float32, device=a.device)
    yk = kb.bell_spmv_tiles(a.blocks, a.block_cols, x2d)
    yp = kb._bell_plain(a.blocks, a.block_cols, x2d)
    torch.cuda.synchronize()
    e, m = rel_max_err(yk, yp)
    check(e <= TOL_Q * m, f"K5 {label}: y err {e} vs max|y| {m}")
    errs["bell_spmv"] = max(errs["bell_spmv"], e)
    print(f"  K5 {label:<38} |dy|={e:.3g} (max|y| {m:.4g}), tiles {a.tile_bytes() / 1e6:.1f} MB")
    return x2d


def check_update(shape, rng, pcg, errs, label, dev):
    """Kernel 2 (or 3) against its plain version: x' and r' bit for bit,
    the dots within TOL_DOT."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    def vec():
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    x, p, r, q = vec(), vec(), vec(), vec()
    d = vec().abs() + 0.1
    alpha = torch.tensor([[0.61]], dtype=torch.float32, device=dev)
    name = "fused_update_dot_pcg" if pcg else "fused_update_dot"
    if pcg:
        ok = fc.fused_update_dot_pcg(x, p, r, q, d, alpha)
        op = fc._update_plain(name, x, p, r, q, d, alpha, None, None)
    else:
        ok = fc.fused_update_dot(x, p, r, q, alpha)
        op = fc._update_plain(name, x, p, r, q, None, alpha, None, None)
    torch.cuda.synchronize()
    check(torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1]),
          f"{name} {label}: x' or r' not bit-equal to the plain version")
    worst = 0.0
    for i, what in ((2, "rnorm"), (3, "rho"))[: 2 if pcg else 1]:
        e = abs(float(ok[i]) - float(op[i]))
        check(e <= TOL_DOT * abs(float(op[i])), f"{name} {label}: {what} {float(ok[i])} vs {float(op[i])}")
        worst = max(worst, e)
    errs[name] = max(errs[name], worst)
    print(f"  {name:<21}{label:<14} x', r' bit-equal; max abs err of the dots {worst:.3g}")
    return x, p, r, q, d, alpha


def phase_kernels(dev, big, big_full):
    """Kernels against plain versions; returns (errs, times of the JSON
    table's shapes, times at the other main-path shapes, operators)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    rng = np.random.default_rng(0)
    errs = dict.fromkeys(fc.LAUNCHES, 0.0)
    times, extra = {}, {}
    p3d = load_symbell(MATRICES[0], dev)
    p3d_full = load_bell(MATRICES[0], dev)
    p3d_8 = load_bell(MATRICES[0], dev, bm=8)
    for label, a in (("tridiag n=262144 full", big_full), ("poisson3d_48 full", p3d_full),
                     ("poisson3d_48 8x128 (load_matrix default)", p3d_8)):
        print(f"  {label}: tiles {tuple(a.blocks.shape)}, {a.tile_bytes() / 1e6:.1f} MB")
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        args = check_k1(big, rng, "banded", with_d, 8, errs, f"tridiag n=262144 banded{tag}")
        check_k1(big, rng, "scatter", with_d, 8, errs, f"tridiag n=262144 general{tag}")
        check_k1(p3d, rng, "scatter", with_d, 8, errs, f"poisson3d_48 general{tag}")
    _, small_t = block_tridiag_ops(13 * 64, 64, dev)
    small_g = random_block_sym(rng, 13, 32, 3, dev)
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        check_k1(small_t, rng, "banded", with_d, 4, errs, f"ragged nrb=13 bn=64 banded{tag}")
        check_k1(small_g, rng, "scatter", with_d, 4, errs, f"ragged nrb=13 bn=32 general{tag}")

    # main-path timing, kernel and plain version on the same inputs; the
    # kernels get their scratch and outputs made once, as inside a solve
    r, pold, beta, _ = args
    # a solve state that never finishes, so every timed launch does its work
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    times["sym_fused_dir_spmv_dot"] = time_pair(
        lambda: fc.sym_fused_dir_spmv_dot(
            big.diag_blocks, big.off_blocks, big.off_cols, r, pold, beta,
            mirror="banded", mirror_src=big.mirror_src, out=out, work=work),
        lambda: fc._sym_dir_plain(
            big.diag_blocks, big.off_blocks, big.off_cols, r, pold, beta, None,
            big.mirror_src, None, None))
    rg = torch.randn(p3d.nrb, 128, device=dev)
    out_g = (torch.empty_like(rg), torch.empty_like(rg))
    extra["K1 general poisson3d_48"] = time_pair(
        lambda: fc.sym_fused_dir_spmv_dot(
            p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, rg, rg, beta,
            mirror="scatter", mirror_src=p3d.mirror_src, out=out_g, work=work),
        lambda: fc._sym_dir_plain(
            p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, rg, rg, beta, None,
            p3d.mirror_src, None, None))
    for pcg in (False, True):
        name = "fused_update_dot_pcg" if pcg else "fused_update_dot"
        x, p, r, q, d, alpha = check_update((N_BIG // 128, 128), rng, pcg, errs, "(2048, 128)", dev)
        check_update((13, 32), rng, pcg, errs, "(13, 32)", dev)
        out = (torch.empty_like(x), torch.empty_like(r))
        dd = d if pcg else None
        kern = fc.fused_update_dot_pcg if pcg else (
            lambda x_, p_, r_, q_, d_, a_, **kw: fc.fused_update_dot(x_, p_, r_, q_, a_, **kw))
        times[name] = time_pair(
            lambda: kern(x, p, r, q, dd, alpha, out=out, work=work),
            lambda: fc._update_plain(name, x, p, r, q, dd, alpha, None, None))

    # kernels 4 and 5 (full blocked-ELL)
    for with_d in (False, True):
        for beta_v in (0.0, 0.37):
            tag = f"{'+d' if with_d else ''} beta={beta_v}"
            k4_args = check_k4(big_full, rng, with_d, beta_v, errs, f"tridiag n=262144{tag}")
            check_k4(p3d_full, rng, with_d, beta_v, errs, f"poisson3d_48{tag}")
    small_f = random_block_full(rng, 13, 32, 32, 3, dev)
    for with_d in (False, True):
        check_k4(small_f, rng, with_d, 0.37, errs, f"ragged nrb=13 bn=32{'+d' if with_d else ''}")
    x_big = check_k5(big_full, rng, errs, "tridiag n=262144 128x128")
    x_p3d = check_k5(p3d_full, rng, errs, "poisson3d_48 128x128")
    x_p8 = check_k5(p3d_8, rng, errs, "poisson3d_48 8x128")
    check_k5(random_block_full(rng, 13, 8, 64, 3, dev, ncols=300), rng, errs,
             "ragged rect 104x300 8x64")
    r, pold, beta = k4_args
    out = (torch.empty_like(r), torch.empty_like(r))
    times["fused_dir_spmv_dot"] = time_pair(
        lambda: fc.fused_dir_spmv_dot(big_full.blocks, big_full.block_cols, r, pold, beta,
                                      out=out, work=work),
        lambda: fc._full_dir_plain(big_full.blocks, big_full.block_cols, r, pold, beta,
                                   None, None, None))
    extra["K4 poisson3d_48"] = time_pair(
        lambda: fc.fused_dir_spmv_dot(p3d_full.blocks, p3d_full.block_cols, rg, rg, beta,
                                      out=out_g, work=work),
        lambda: fc._full_dir_plain(p3d_full.blocks, p3d_full.block_cols, rg, rg, beta,
                                   None, None, None))
    times["bell_spmv"] = time_pair(
        lambda: kb.bell_spmv_tiles(big_full.blocks, big_full.block_cols, x_big),
        lambda: kb._bell_plain(big_full.blocks, big_full.block_cols, x_big))
    for label, a, x in (("K5 poisson3d_48 128x128", p3d_full, x_p3d),
                        ("K5 poisson3d_48 8x128", p3d_8, x_p8)):
        extra[label] = time_pair(lambda: kb.bell_spmv_tiles(a.blocks, a.block_cols, x),
                                 lambda: kb._bell_plain(a.blocks, a.block_cols, x))
        extra[label].update(bound(nbytes(a.blocks, a.block_cols, x) + a.n * 4,
                                  2 * a.blocks.numel()))
        extra[label]["library_ms"] = library_spmv(
            csr_from_bell(a), x.reshape(-1)[:a.shape[1]],
            kb.bell_spmv_tiles(a.blocks, a.block_cols, x)[:a.n], label)

    # bounds from this run's inputs: every vector is n float32 entries
    n, v = N_BIG, N_BIG * 4
    times["sym_fused_dir_spmv_dot"].update(bound(
        nbytes(big.diag_blocks, big.off_blocks, big.off_cols) + 4 * v,
        2 * big.diag_blocks.numel() + 4 * big.off_blocks.numel() + 4 * n))
    extra["K1 general poisson3d_48"].update(bound(
        nbytes(p3d.diag_blocks, p3d.off_blocks, p3d.off_cols, p3d.mirror_src)
        + 4 * p3d.nrb * 128 * 4,
        2 * p3d.diag_blocks.numel() + 4 * p3d.off_blocks.numel() + 4 * p3d.nrb * 128))
    times["fused_update_dot"].update(bound(6 * v, 6 * n))  # x p r q in, x' r' out
    times["fused_update_dot_pcg"].update(bound(7 * v, 9 * n))  # and d
    times["fused_dir_spmv_dot"].update(bound(
        nbytes(big_full.blocks, big_full.block_cols) + 4 * v, 2 * big_full.blocks.numel() + 4 * n))
    extra["K4 poisson3d_48"].update(bound(
        nbytes(p3d_full.blocks, p3d_full.block_cols) + 4 * p3d_full.nrb * 128 * 4,
        2 * p3d_full.blocks.numel() + 4 * p3d_full.nrb * 128))
    times["bell_spmv"].update(bound(nbytes(big_full.blocks, big_full.block_cols) + 2 * v,
                                    2 * big_full.blocks.numel()))
    # kernels 1-4 fuse an SpMV with vector updates and dots: no one PyTorch
    # call computes that
    for name in BLOCKED_KERNELS[:4]:
        times[name]["library_ms"] = None
    times["bell_spmv"]["library_ms"] = library_spmv(
        csr_from_bell(big_full), x_big.reshape(-1),
        kb.bell_spmv_tiles(big_full.blocks, big_full.block_cols, x_big), "tridiag n=262144")
    torch.cuda.synchronize()
    return errs, times, extra, {"p3d": p3d, "p3d_full": p3d_full, "p3d_8": p3d_8}


# ---- phase 2, DIA: kernels 7-10 against their plain versions -----------------

def sym_dia_pair(n, offs_pos, rng, dev, scale=0.05):
    """A random diagonally dominant symmetric DIA operator in full and in
    symmetric storage, drawn as bench.py's symdia-big is (one normal draw
    per stored off-diagonal, in order, zero past the end; the main diagonal
    1 + 2·max row sum)."""
    import torch

    from conjugategradient_tpu_torch.types import DIAMatrix, SymDIAMatrix

    diags_pos = np.zeros((len(offs_pos), n), np.float32)
    for j, k in enumerate(offs_pos[1:], start=1):
        d = (scale * rng.standard_normal(n)).astype(np.float32)
        d[n - k:] = 0.0
        diags_pos[j] = d
    diags_pos[0] = 1.0 + 2.0 * np.abs(diags_pos[1:]).sum(axis=0).max()
    offs_full = tuple(-k for k in reversed(offs_pos[1:])) + tuple(offs_pos)
    diags_full = np.zeros((len(offs_full), n), np.float32)
    for j, off in enumerate(offs_full):
        if off >= 0:
            diags_full[j] = diags_pos[offs_pos.index(off)]
        else:
            diags_full[j, -off:] = diags_pos[offs_pos.index(-off)][: n + off]
    nnz = int(np.count_nonzero(diags_full))
    full = DIAMatrix(torch.from_numpy(diags_full).to(dev), offs_full, (n, n), nnz)
    sym = SymDIAMatrix(torch.from_numpy(diags_pos).to(dev), tuple(offs_pos), (n, n), nnz)
    return full, sym


def check_dia(a, sym, rng, errs, label):
    """dia_spmv on ``a`` (and sym_dia_spmv on ``sym``, its symmetric half,
    when given) bit for bit against the plain versions on one random x;
    returns x and the kernel's y."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    x = torch.as_tensor(rng.standard_normal(a.shape[1]), dtype=torch.float32, device=a.device)
    yk = kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x)
    yp = kd._dia_plain(a.diags, a.offsets, x)
    torch.cuda.synchronize()
    e, m = rel_max_err(yk, yp)
    check(torch.equal(yk, yp), f"dia_spmv {label}: not bit-equal to the plain version ({e})")
    errs["dia_spmv"] = max(errs["dia_spmv"], e)
    msg = (f"  dia_spmv {label:<30} bit-equal (max|y| {m:.4g}); {a.ndiag} diagonals, "
           f"{a.shape[0]} x {a.shape[1]}, {nbytes(a.diags) / 1e6:.1f} MB")
    if sym is not None:
        ys = kd.sym_dia_spmv_diags(sym.diags, sym.offsets, sym.offsets_dev, x)
        yps = kd._sym_dia_plain(sym.diags, sym.offsets, x)
        torch.cuda.synchronize()
        es, _ = rel_max_err(ys, yps)
        check(torch.equal(ys, yps), f"sym_dia_spmv {label}: not bit-equal to the plain version ({es})")
        errs["sym_dia_spmv"] = max(errs["sym_dia_spmv"], es)
        ef, _ = rel_max_err(ys, yk)
        check(ef <= TOL_Q * m, f"sym_dia_spmv {label}: {ef} from the full layout's y")
        msg += f"; sym_dia_spmv bit-equal ({sym.ndiag} stored), |y_sym - y_full| {ef:.3g}"
    print(msg)
    return x, yk


def dia_bounds(a, sym):
    """Bounds of one call: dia_spmv reads its diagonals, offsets and x once
    and writes y; sym_dia_spmv the same on its stored half-band, with two
    multiply-adds per stored off-diagonal entry."""
    n, ncols = a.shape
    full = bound(nbytes(a.diags, a.offsets_dev) + (ncols + n) * 4, 2 * a.ndiag * n)
    half = bound(nbytes(sym.diags, sym.offsets_dev) + 2 * n * 4, 2 * (2 * sym.ndiag - 1) * n)
    return full, half


def phase_dia_kernels(dev, errs, times, extra):
    """Kernels 7-10 (two CUDA kernels) against their plain versions, timed
    beside cuSPARSE; returns the operators phase 3 reuses."""
    import torch

    from conjugategradient_tpu_torch import load_matrix
    from conjugategradient_tpu_torch.convert import dia_from_arrays
    from conjugategradient_tpu_torch.ops.cuda import dia_spmv as kd

    errs.update(dict.fromkeys(DIA_KERNELS, 0.0))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    big, big_sym = sym_dia_pair(SYMDIA_N, SYMDIA_OFFSETS, rng, dev)
    print(f"  symdia-big built in {time.perf_counter() - t0:.1f} s: full {big.ndiag} diagonals "
          f"{nbytes(big.diags) / 1e6:.1f} MB, symmetric {big_sym.ndiag} "
          f"{nbytes(big_sym.diags) / 1e6:.1f} MB, nnz {big.nnz}")
    p3d = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="dia", dtype=np.float32, device=dev)
    p3d_sym = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="symdia", dtype=np.float32,
                          device=dev)
    dense = load_matrix(os.path.join(ROOT, "problems/dense_256.mtx"), layout="dia",
                        dtype=np.float32, device=dev)
    dense_sym = load_matrix(os.path.join(ROOT, "problems/dense_256.mtx"), layout="symdia",
                            dtype=np.float32, device=dev)
    x_big, y_big = check_dia(big, big_sym, rng, errs, "symdia-big n=2097152")
    x_p3d, y_p3d = check_dia(p3d, p3d_sym, rng, errs, "poisson3d_48")
    check_dia(dense, dense_sym, rng, errs, "dense_256")
    check_dia(*sym_dia_pair(1001, (0, 3, 300), rng, dev, scale=0.3), rng, errs,
              "ragged n=1001 offsets 0,3,300")
    rect = rng.standard_normal((4, 1001)).astype(np.float32)
    check_dia(dia_from_arrays(rect, (-7, 0, 5, 299), (1001, 1300), rect.size, device=dev),
              None, rng, errs, "rect 1001x1300")
    neg = rng.standard_normal((3, 777)).astype(np.float32)
    check_dia(dia_from_arrays(neg, (-300, -3, -1), (777, 777), neg.size, device=dev),
              None, rng, errs, "negative offsets only")

    for label, a, sym, x, y in (("symdia-big", big, big_sym, x_big, y_big),
                                ("poisson3d_48", p3d, p3d_sym, x_p3d, y_p3d)):
        full_b, half_b = dia_bounds(a, sym)
        tf = time_pair(lambda: kd.dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x),
                       lambda: kd._dia_plain(a.diags, a.offsets, x))
        ts = time_pair(lambda: kd.sym_dia_spmv_diags(sym.diags, sym.offsets, sym.offsets_dev, x),
                       lambda: kd._sym_dia_plain(sym.diags, sym.offsets, x))
        csr = csr_from_dia(a)
        lib = library_spmv(csr, x, y, label)  # the same y = A x for both storages
        del csr
        tf.update(full_b, library_ms=lib)
        ts.update(half_b, library_ms=lib)
        full_bytes = nbytes(a.diags) + (a.shape[1] + a.n) * 4
        print(f"  {label} SpMV on full-layout bytes ({full_bytes / 1e6:.1f} MB): dia_spmv "
              f"{full_bytes / tf['ms'] / 1e6:.1f} GB/s, sym_dia_spmv "
              f"{full_bytes / ts['ms'] / 1e6:.1f} GB/s effective")
        if label == "symdia-big":
            times["dia_spmv"], times["sym_dia_spmv"] = tf, ts
        else:
            extra[f"dia_spmv {label}"], extra[f"sym_dia_spmv {label}"] = tf, ts
    torch.cuda.synchronize()
    return {"big": big, "big_sym": big_sym, "p3d": p3d, "p3d_sym": p3d_sym}


# ---- phase 2, MINRES: kernels 14-16 against their plain versions -------------

def minres_operands(nrb, bn, rng, dev, with_d, shift, first=False):
    """Six random (nrb, bn) vectors, the (1, 8) scalar row (``first``: the
    first step's, 1/gamma = phi = 0) and the Jacobi diagonal (or None)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    vecs = [torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)
            for _ in range(6)]
    su = torch.zeros(1, 8)
    su[0, fm.SU_INV_BETA], su[0, fm.SU_SHIFT] = 0.31, shift
    if not first:
        su[0, fm.SU_OLDEPS], su[0, fm.SU_DELTA] = 0.11, 0.23
        su[0, fm.SU_IGAMMA], su[0, fm.SU_PHI] = 0.57, 0.83
    d = None
    if with_d:
        d = torch.as_tensor(0.5 + rng.random((nrb, bn)), dtype=torch.float32, device=dev)
    return vecs, su.to(dev), d


def minres_dir_pair(a, mirror, row_group=None):
    """(name, kernel wrapper, plain version) of MINRES kernel 1 on ``a``:
    kernel 14 on full storage, kernel 15 (with ``mirror``) on symmetric."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.spmv import bell_apply, sym_bell_apply
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    if isinstance(a, BlockedEllMatrix):
        name = "minres_dir_spmv_dot"
        kern = lambda vecs, su, d, **kw: fm.minres_dir_spmv_dot(
            a.blocks, a.block_cols, *vecs, su, d, row_group=row_group, **kw)
        apply = lambda v: bell_apply(a.blocks, a.block_cols, v)
    else:
        name = "sym_minres_dir_spmv_dot"
        kern = lambda vecs, su, d, **kw: fm.sym_minres_dir_spmv_dot(
            a.diag_blocks, a.off_blocks, a.off_cols, *vecs, su, d, mirror=mirror,
            mirror_src=a.mirror_src, row_group=row_group or 8, **kw)
        apply = lambda v: sym_bell_apply(a.diag_blocks, a.off_blocks, a.off_cols,
                                         a.mirror_src, v)
    plain = lambda vecs, su, d: fm._dir_plain(name, apply, vecs, su, d, None, None)
    return name, kern, plain


def check_minres_dir(a, rng, mirror, with_d, shift, errs, label, first=False, row_group=None):
    """MINRES kernel 1 against its plain version: v, w_new, x_new bit for
    bit, q within TOL_Q of max|q|, v.q within TOL_DOT and v.r1 within
    TOL_DOT of ||v|| ||r1|| (a dot of unrelated vectors can cancel); two
    launches bit-identical; the last CTA's scalar step (c1, alpha,
    alpha/beta) within TAIL_ULPS of torch's on the kernel's own dots."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    name, kern, plain = minres_dir_pair(a, mirror, row_group)
    vecs, su, d = minres_operands(a.nrb, a.bn, rng, a.device, with_d, shift, first)
    wk = fm.MinresWork.new(a.device, maxiter=4)
    wk.scal[fm.M_OLDB] = 1.7
    wk.start(torch.tensor(2.3, device=a.device))
    wp_scal = wk.scal.clone()
    k = kern(vecs, su, d, work=wk)
    k2 = kern(vecs, su, d)
    p = plain(vecs, su, d)
    torch.cuda.synchronize()
    for i, what in ((0, "v"), (2, "w_new"), (3, "x_new")):
        check(torch.equal(k[i], p[i]), f"{name} {label}: {what} not bit-equal to the plain version")
    check(all(torch.equal(x, y) for x, y in zip(k, k2)), f"{name} {label}: two launches differ")
    if first:
        check(torch.equal(k[3], vecs[5]) and not bool(k[2].any()),
              f"{name} {label}: a first step (1/gamma = phi = 0) changed x or w")
    e_q, m_q = rel_max_err(k[1], p[1])
    check(e_q <= TOL_Q * m_q, f"{name} {label}: q err {e_q} vs max|q| {m_q}")
    e_vq = abs(float(k[4]) - float(p[4]))
    e_vr1 = abs(float(k[5]) - float(p[5]))
    check(e_vq <= TOL_DOT * abs(float(p[4])), f"{name} {label}: vq {float(k[4])} vs {float(p[4])}")
    vr1_scale = float(p[0].norm() * vecs[1].norm())
    check(e_vr1 <= TOL_DOT * vr1_scale, f"{name} {label}: vr1 {float(k[5])} vs {float(p[5])}")
    wp = fm.MinresWork.new(a.device, maxiter=4)
    wp.scal.copy_(wp_scal)
    fm.finish_dir(wp, k[4][0, 0], k[5][0, 0])
    ulps = int((wk.scal[:fm.M_VQ].view(torch.int32) - wp.scal[:fm.M_VQ].view(torch.int32)).abs().max())
    check(ulps <= TAIL_ULPS, f"{name} {label}: scalar step {ulps} ulps from torch's")
    errs[name] = max(errs[name], e_q, e_vq, e_vr1)
    print(f"  {name} {label:<34} v, w, x' bit-equal; |dq|={e_q:.3g} (max|q| {m_q:.4g}) "
          f"|dvq|={e_vq:.3g} |dvr1|={e_vr1:.3g}; repeat ok; scalar step {ulps} ulp")
    return vecs, su, d


def check_minres_update(shape, rng, with_d, errs, label, dev):
    """Kernel 16 against its plain version: r2' bit for bit (also written
    over r1), beta^2 within TOL_DOT, and every scalar the last CTA writes
    (the Givens step) within TAIL_ULPS of torch's on the kernel's own dot."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    q, r1, r2 = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                 for _ in range(3))
    d = torch.as_tensor(0.5 + rng.random(shape), dtype=torch.float32, device=dev) if with_d else None

    def work():
        w = fm.MinresWork.new(dev, maxiter=9, tol=1e-3, shift=0.07)
        w.scal[fm.M_OLDB], w.scal[fm.M_DBAR], w.scal[fm.M_EPSLN] = 1.7, 0.4, 0.2
        w.scal[fm.M_CS], w.scal[fm.M_SN], w.scal[fm.M_ALFA] = -0.8, 0.6, 2.2
        w.scal[fm.M_C1], w.scal[fm.M_IA] = 0.4, 0.9
        w.start(torch.tensor(2.3, device=dev))
        return w

    wk, wp = work(), work()
    yk, bk = fm.minres_update_dot(q, r1, r2, wk.c1, wk.ia, d, work=wk)
    yp, bp = fm._update_plain(q, r1, r2, wp.c1, wp.ia, d, None, None)
    r1c = r1.clone()
    y2, b2 = fm.minres_update_dot(q, r1c, r2, wp.c1, wp.ia, d, out=r1c)
    torch.cuda.synchronize()
    check(torch.equal(yk, yp), f"minres_update_dot {label}: r2' not bit-equal to the plain version")
    check(torch.equal(y2, yp) and torch.equal(b2, bk),
          f"minres_update_dot {label}: in place over r1, or launched again, it differs")
    e = abs(float(bk) - float(bp))
    check(e <= TOL_DOT * abs(float(bp)), f"minres_update_dot {label}: bsq {float(bk)} vs {float(bp)}")
    fm.finish_update(wp, bk[0, 0])
    ulps = int((wk.scal[:fm.M_VQ].view(torch.int32) - wp.scal[:fm.M_VQ].view(torch.int32)).abs().max())
    check(ulps <= TAIL_ULPS and torch.equal(wk.ctl, wp.ctl) and int(wk.ctl[fc.C_K]) == 1,
          f"minres_update_dot {label}: scalar step {ulps} ulps from torch's, ctl {wk.ctl.tolist()} "
          f"vs {wp.ctl.tolist()}")
    errs["minres_update_dot"] = max(errs["minres_update_dot"], e)
    print(f"  minres_update_dot {label:<20} r2' bit-equal (also over r1); |dbsq|={e:.3g}; "
          f"Givens step {ulps} ulp, ctl equal")
    return q, r1, r2, d


def phase_minres_kernels(dev, big, big_full, ops, errs, times, extra):
    """Kernels 14-16 against their plain versions and timed, at the MINRES
    path's shapes and at small ragged ones."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    rng = np.random.default_rng(14)
    p3d = ops["p3d"]
    for with_d in (False, True):
        for shift in (0.0, 0.07):
            tag = f"{'+d' if with_d else ''} shift={shift}"
            full_args = check_minres_dir(big_full, rng, None, with_d, shift, errs,
                                         f"tridiag n=262144 full{tag}")
            band_args = check_minres_dir(big, rng, "banded", with_d, shift, errs,
                                         f"tridiag n=262144 banded{tag}")
            gen_args = check_minres_dir(p3d, rng, "scatter", with_d, shift, errs,
                                        f"poisson3d_48 general{tag}")
    check_minres_dir(big, rng, "scatter", True, 0.07, errs, "tridiag n=262144 general+d")
    _, small_t = block_tridiag_ops(13 * 64, 64, dev)
    small_g = random_block_sym(rng, 13, 32, 3, dev)
    small_f = random_block_full(rng, 13, 32, 32, 3, dev)
    for first in (False, True):
        tag = " first step" if first else "+d"
        for a, mirror, label in ((big_full, None, "tridiag n=262144 full"),
                                 (big, "banded", "tridiag n=262144 banded"),
                                 (small_f, None, "ragged nrb=13 bn=32 full"),
                                 (small_t, "banded", "ragged nrb=13 bn=64 banded"),
                                 (small_g, "scatter", "ragged nrb=13 bn=32 general")):
            if first or a.nrb == 13:
                check_minres_dir(a, rng, mirror, not first, 0.07, errs, label + tag, first=first,
                                 row_group=4 if a.nrb == 13 else None)
    upd = {}
    for with_d in (False, True):
        upd[with_d] = check_minres_update((N_BIG // 128, 128), rng, with_d, errs,
                                          f"(2048, 128){'+d' if with_d else ''}", dev)
        check_minres_update((13, 32), rng, with_d, errs, f"(13, 32){'+d' if with_d else ''}", dev)

    # timing on the last shifted, unpreconditioned inputs, launched as the
    # solver launches them: in place, with a work that never finishes
    work = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.tensor(2.3, device=dev))
    n, v = N_BIG, N_BIG * 4
    for key, a, mirror, args, table in (
        ("minres_dir_spmv_dot", big_full, None, full_args, times),
        ("sym_minres_dir_spmv_dot", big, "banded", band_args, times),
        ("sym_minres_dir_spmv_dot general poisson3d_48", p3d, "scatter", gen_args, extra),
    ):
        _, kern, plain = minres_dir_pair(a, mirror)
        vecs, su, _ = args
        vecs = [t.clone() for t in vecs]
        out = (vecs[2], torch.empty_like(vecs[0]), vecs[4], vecs[5])
        su0 = su.clone()
        su0[0, fm.SU_PHI] = 0.0  # x stays put over the timed launches
        t = time_pair(lambda: kern(vecs, su0, None, out=out, work=work),
                      lambda: plain(vecs, su0, None))
        tiles = nbytes(a.blocks, a.block_cols) if mirror is None else \
            nbytes(a.diag_blocks, a.off_blocks, a.off_cols)
        flops = 2 * a.blocks.numel() if mirror is None else \
            2 * a.diag_blocks.numel() + 4 * a.off_blocks.numel()
        t.update(bound(tiles + 10 * a.nrb * a.bn * 4, flops + 14 * a.nrb * a.bn),
                 library_ms=None)  # an SpMV fused with updates and two dots: no one call
        table[key] = t
    q, r1, r2, _ = upd[False]
    out = torch.empty_like(q)
    t = time_pair(lambda: fm.minres_update_dot(q, r1, r2, work.c1, work.ia, out=out, work=work),
                  lambda: fm._update_plain(q, r1, r2, work.c1, work.ia, None, None, None))
    t.update(bound(4 * v, 7 * n), library_ms=None)  # q r1 r2 in, r2' out
    times["minres_update_dot"] = t
    torch.cuda.synchronize()


# ---- phase 2, BiCGStab: kernels 18-20 against their plain versions -----------

def nonsym_tridiag(n, bn, dev, seed=0):
    """bench.py:1367-1403's nonsymmetric block-tridiagonal operator (the JAX
    lane bicgstab-bell): up/lo tiles 0.08 N(0, 1) from the seed, the
    diagonal (2 + sum|up| + sum|lo|) I, as full blocked-ELL."""
    import torch

    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    nrb = n // bn
    rng = np.random.default_rng(seed)
    up = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    lo = (0.08 * rng.standard_normal((bn, bn))).astype(np.float32)
    diag = np.eye(bn, dtype=np.float32) * (2.0 + np.abs(up).sum() + np.abs(lo).sum())
    blocks = np.zeros((nrb, 3, bn, bn), dtype=np.float32)
    cols = np.zeros((nrb, 3), dtype=np.int32)
    for i in range(nrb):
        blocks[i, 0], cols[i, 0] = diag, i
        k = 1
        for c, t in ((i - 1, lo), (i + 1, up)):
            if 0 <= c < nrb:
                blocks[i, k], cols[i, k] = t, c
                k += 1
    return BlockedEllMatrix(torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev),
                            (n, n), nrb * 3 * bn * bn)


def convdiff_csr(nx):
    """bench.py:1113-1138's operator: the 5-point upwind convection-diffusion
    stencil on an nx x nx grid, peclet 10, as float32 host CSR."""
    from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo

    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=10.0)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order].astype(np.float32)
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    return v, c, np.cumsum(indptr), shape


def convdiff_bell(nx, dev):
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    return BlockedEllMatrix.from_csr_host(*convdiff_csr(nx), bm=128, bn=128, device=dev)


def bicg_work(dev, maxiter=5, tol=1e-3):
    """A live BiCGStab work with non-trivial scalars (rho_k = 1.7, beta from
    ||r0||^2 = 2.3)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    w = fb.BicgstabWork.new(dev, maxiter=maxiter, tol=tol)
    w.scal[fb.B_RHO_NEXT] = 1.7
    w.start(torch.tensor(2.3, device=dev))
    return w


def tail_ulps(wk, wp) -> int:
    """The largest distance in ulps between two works' scalar slots (the
    kernels' last CTA against torch's 0-d ops), the dots left out."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    return int((wk.scal[:fb.B_RV].view(torch.int32)
                - wp.scal[:fb.B_RV].view(torch.int32)).abs().max())


def check_bicg_tiles(a, rng, with_d, beta_v, omega_v, alpha_v, errs, label, row_group=None,
                     nan=False):
    """Kernels 18 and 19 against their plain versions: p', p^, s, s^, x_h
    bit for bit, v' and t within TOL_Q of their largest entry, the dots
    within TOL_DOT of the product of their operands' norms (dots of
    unrelated vectors can cancel), two launches bit-identical, and the last
    CTAs' scalar steps within TAIL_ULPS of torch's on the kernels' own dots.
    ``nan``: r^ = 0 and rho_k = 0 make alpha = 0/0 in kernel 18's tail, and
    r = v' = 0 make omega = 0/0 in kernel 19's: both are clamped to 0, and
    the next kernel's update is an exact no-op."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    dev, nrb, bn = a.device, a.nrb, a.bn

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, p, v, rhat, x = vec(), vec(), vec(), vec(), vec()
    if nan:
        rhat.zero_()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=dev)
    omega = torch.tensor([[omega_v]], dtype=torch.float32, device=dev)
    wk, wp = bicg_work(dev), bicg_work(dev)
    if nan:
        wk.scal[fb.B_RHO_NEXT] = wp.scal[fb.B_RHO_NEXT] = 0.0
    k1 = fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d,
                                  row_group=row_group, work=wk)
    k1b = fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d,
                                   row_group=row_group)
    p1 = fb._dir_plain(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, d, None, None)
    torch.cuda.synchronize()
    check(torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1]),
          f"K18 {label}: p' or p^ not bit-equal to the plain version")
    check(all(torch.equal(s_, t_) for s_, t_ in zip(k1, k1b)), f"K18 {label}: two launches differ")
    e_v, m_v = rel_max_err(k1[2], p1[2])
    e_rv = abs(float(k1[3]) - float(p1[3]))
    check(e_v <= TOL_Q * m_v, f"K18 {label}: v' err {e_v} vs max {m_v}")
    check(e_rv <= TOL_DOT * float(rhat.norm() * p1[2].norm()),
          f"K18 {label}: rv {float(k1[3])} vs {float(p1[3])}")
    fb.finish_dir(wp, k1[3][0, 0])
    u1 = tail_ulps(wk, wp)
    check(u1 <= TAIL_ULPS, f"K18 {label}: scalar step {u1} ulps from torch's")
    if nan:
        check(math.isnan(float(wk.scal[fb.B_ALPHA])) and float(wk.scal[fb.B_ALPHA_C]) == 0.0,
              f"K18 {label}: alpha = 0/0 was not clamped to 0")
        r.zero_()
    alpha = wk.alpha_c if nan else torch.tensor([[alpha_v]], dtype=torch.float32, device=dev)
    vn = torch.zeros_like(r) if nan else k1[2]
    k2 = fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, r, vn, x, k1[1], alpha, d,
                                row_group=row_group, work=wk)
    k2b = fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, r, vn, x, k1[1], alpha, d,
                                 row_group=row_group)
    p2 = fb._s_plain(a.blocks, a.block_cols, r, vn, x, k1[1], alpha, d, None, None)
    torch.cuda.synchronize()
    check(all(torch.equal(k2[i], p2[i]) for i in range(3)),
          f"K19 {label}: s, s^ or x_h not bit-equal to the plain version")
    check(all(torch.equal(s_, t_) for s_, t_ in zip(k2, k2b)), f"K19 {label}: two launches differ")
    e_t, m_t = rel_max_err(k2[3], p2[3])
    check(e_t <= TOL_Q * max(m_t, 1e-30), f"K19 {label}: t err {e_t} vs max {m_t}")
    scale = float(p2[0].norm() * p2[0].norm() + p2[3].norm() * p2[0].norm()
                  + p2[3].norm() * p2[3].norm())
    e_d = max(abs(float(k2[i]) - float(p2[i])) for i in range(4, 7))
    check(e_d <= TOL_DOT * scale, f"K19 {label}: dots {[float(t) for t in k2[4:]]} vs "
          f"{[float(t) for t in p2[4:]]}")
    fb.finish_s(wp, k2[4][0, 0], k2[5][0, 0], k2[6][0, 0])
    u2 = tail_ulps(wk, wp)
    check(u2 <= TAIL_ULPS and torch.equal(wk.ctl, wp.ctl),
          f"K19 {label}: scalar step {u2} ulps from torch's, ctl {wk.ctl.tolist()} vs "
          f"{wp.ctl.tolist()}")
    if nan:
        check(torch.equal(k2[0], r) and torch.equal(k2[2], x),
              f"K19 {label}: a clamped alpha changed s or x_h")
        check(math.isnan(float(wk.scal[fb.B_OMEGA])) and float(wk.scal[fb.B_OMEGA_C]) == 0.0,
              f"K19 {label}: omega = 0/0 was not clamped to 0")
        k3 = fb.bicgstab_update_dot(k2[2], k2[1], k2[0], k2[3], rhat, wk.omega_c)
        torch.cuda.synchronize()
        check(torch.equal(k3[0], k2[2]) and torch.equal(k3[1], k2[0]),
              f"K20 {label}: a clamped omega changed x_h or s")
    for name, e in (("bicgstab_dir_spmv_dot", max(e_v, e_rv)), ("bicgstab_s_spmv_dot", max(e_t, e_d))):
        errs[name] = max(errs[name], e)
    print(f"  K18/K19 {label:<40} p', p^, s, s^, x_h bit-equal; |dv'|={e_v:.3g} (max {m_v:.4g}) "
          f"|dt|={e_t:.3g} (max {m_t:.4g}) |drv|={e_rv:.3g} |ddots|={e_d:.3g}; repeat ok; "
          f"scalar steps {u1}, {u2} ulp{'; NaN alpha and omega clamped, updates no-ops' if nan else ''}")
    return r, p, v, rhat, x, k1, beta, omega, alpha


def check_bicg_update(n, rng, errs, label, dev):
    """Kernel 20 against its plain version: x', r' bit for bit (also in place
    over x_h and s), the dots within TOL_DOT, its scalar step within
    TAIL_ULPS and its control words equal; omega = 0 returns x_h and s."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    xh, sh, s, t, rhat = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
                          for _ in range(5))
    w = torch.tensor([[0.45]], dtype=torch.float32, device=dev)
    wk, wp = bicg_work(dev), bicg_work(dev)
    k = fb.bicgstab_update_dot(xh, sh, s, t, rhat, w, work=wk)
    p = fb._update_plain(xh, sh, s, t, rhat, w, None, None)
    xc, sc = xh.clone(), s.clone()
    k2 = fb.bicgstab_update_dot(xc, sh, sc, t, rhat, w, out=(xc, sc))
    z = fb.bicgstab_update_dot(xh, sh, s, t, rhat, torch.zeros(1, 1, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k2[0], p[0])
          and torch.equal(k2[1], p[1]), f"K20 {label}: x' or r' not bit-equal to the plain version")
    check(torch.equal(z[0], xh) and torch.equal(z[1], s), f"K20 {label}: omega = 0 changed x_h or s")
    e = max(abs(float(k[i]) - float(p[i])) for i in (2, 3))
    scale = float(p[1].norm() * (p[1].norm() + rhat.norm()))
    check(e <= TOL_DOT * scale, f"K20 {label}: dots {float(k[2])}, {float(k[3])} vs "
          f"{float(p[2])}, {float(p[3])}")
    fb.finish_update(wp, k[2][0, 0], k[3][0, 0])
    u = tail_ulps(wk, wp)
    check(u <= TAIL_ULPS and torch.equal(wk.ctl, wp.ctl),
          f"K20 {label}: scalar step {u} ulps from torch's, ctl {wk.ctl.tolist()} vs {wp.ctl.tolist()}")
    errs["bicgstab_update_dot"] = max(errs["bicgstab_update_dot"], e)
    print(f"  K20 n={n:<10}{label:<14} x', r' bit-equal (also in place); omega = 0 keeps x_h, s; "
          f"|ddots|={e:.3g}; scalar step {u} ulp, ctl equal")
    return xh, sh, s, t, rhat, w


def time_bicg_tiles(a, args, work) -> tuple:
    """Kernels 18 and 19 timed against their plain versions on the operands
    ``check_bicg_tiles`` returned, launched as the solver launches them
    (outputs made once, ``work`` live), each with its bound: each input
    read once, each output written once."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    r, p, v, rhat, x, k1, beta, omega, alpha = args
    out1 = tuple(torch.empty_like(r) for _ in range(3))
    out2 = tuple(torch.empty_like(r) for _ in range(4))
    t1 = time_pair(
        lambda: fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, r, p, v, rhat, beta, omega,
                                         out=out1, work=work),
        lambda: fb._dir_plain(a.blocks, a.block_cols, r, p, v, rhat, beta, omega, None, None, None))
    t2 = time_pair(
        lambda: fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha,
                                       out=out2, work=work),
        lambda: fb._s_plain(a.blocks, a.block_cols, r, k1[2], x, k1[1], alpha, None, None, None))
    n, vb, tiles = r.numel(), r.numel() * 4, nbytes(a.blocks, a.block_cols)
    t1.update(bound(tiles + 7 * vb, 2 * a.blocks.numel() + 6 * n))
    t2.update(bound(tiles + 8 * vb, 2 * a.blocks.numel() + 10 * n))
    for t in (t1, t2):
        # an SpMV fused with updates and dots: no one call
        t["library_ms"] = None
    return t1, t2


def phase_bicgstab_kernels(dev, errs, times, extra):
    """Kernels 18-20 against their plain versions and timed, on bench.py's
    bicgstab-bell operator (n = 262,144, 128 x 128), on the timed main
    path's convection-diffusion operator and at ragged shapes."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    rng = np.random.default_rng(18)
    a = nonsym_tridiag(N_BIG, 128, dev, seed=0)
    print(f"  bicgstab-bell operator: tiles {tuple(a.blocks.shape)}, {a.tile_bytes() / 1e6:.1f} MB")
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        args = check_bicg_tiles(a, rng, with_d, 0.4, 0.25, 0.6, errs, f"n=262144{tag}")
        check_bicg_tiles(a, rng, with_d, 0.0, 0.0, 0.0, errs, f"n=262144{tag} beta=omega=alpha=0")
    check_bicg_tiles(a, rng, False, 0.4, 0.25, 0.6, errs, "n=262144 NaN alpha, omega", nan=True)
    # the timed main path's operator: kmax 5, its padding slots point at
    # column block 0
    cd = convdiff_bell(512, dev)
    check(cd.kmax == 5, f"convdiff 512 blocked-ELL: kmax {cd.kmax}, expected 5")
    print(f"  convdiff-512 operator: tiles {tuple(cd.blocks.shape)}, {cd.tile_bytes() / 1e6:.1f} MB")
    cd_args = check_bicg_tiles(cd, rng, False, 0.4, 0.25, 0.6, errs, "convdiff-512 (main path)")
    for bn in (32, 64):
        small = nonsym_tridiag(13 * bn, bn, dev, seed=bn)
        for with_d in (False, True):
            check_bicg_tiles(small, rng, with_d, 0.4, 0.25, 0.6, errs,
                             f"ragged nrb=13 bn={bn}{'+d' if with_d else ''}", row_group=3)
        check_bicg_tiles(small, rng, True, 0.4, 0.25, 0.6, errs, f"ragged nrb=13 bn={bn} NaN",
                         nan=True)
    for n in (210, 4097):
        check_bicg_update(n, rng, errs, "", dev)
    upd = check_bicg_update(N_BIG, rng, errs, "(main path)", dev)

    # timing on a work that never finishes (tol = -1, maxiter 2^20)
    work = fb.BicgstabWork.new(dev, maxiter=1 << 20, tol=-1.0)
    work.start(torch.sum(args[0] * args[0]))
    times["bicgstab_dir_spmv_dot"], times["bicgstab_s_spmv_dot"] = time_bicg_tiles(a, args, work)
    extra["K18 convdiff-512"], extra["K19 convdiff-512"] = time_bicg_tiles(cd, cd_args, work)
    xh, sh, s, t, rh, w = upd
    out3 = (torch.empty_like(xh), torch.empty_like(xh))
    times["bicgstab_update_dot"] = time_pair(
        lambda: fb.bicgstab_update_dot(xh, sh, s, t, rh, w, out=out3, work=work),
        lambda: fb._update_plain(xh, sh, s, t, rh, w, None, None))
    torch.cuda.synchronize()
    check(int(work.ctl[fb.C_LIVE]) == 1, "BiCGStab timing: the timing work stopped being live")
    times["bicgstab_update_dot"].update(bound(7 * N_BIG * 4, 8 * N_BIG))
    # two axpys and two dots: no one call
    times["bicgstab_update_dot"]["library_ms"] = None
    return {"bench_bell": a, "convdiff": cd}


# ---- phase 3: the main path ------------------------------------------------

def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


def bnorm(n: int) -> float:
    return math.sqrt(n * (n + 1) * (2 * n + 1) / 6.0)


def run_tester(path, layout, precond, tol, dtype="float32", extra=()):
    """The port's tester in this process; returns (dim, nnz, ms, rel_error,
    summary, printed lines)."""
    from conjugategradient_tpu_torch import tester

    src = path if path.startswith("stencil:") else os.path.join(ROOT, path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tester.main([src, "--layout", layout,
                          "--dtype", dtype, "--precond", precond,
                          "--tol", repr(tol), "--summary",
                          "--device", str(DEVICE), *extra])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0, f"tester {path} {layout} {precond} {' '.join(extra)}: rc={rc}")
    dim, nnz, ms, rel = lines[0].split()
    summ = json.loads(lines[1])
    return int(dim), int(nnz), float(ms), float(rel), summ, lines


def trajectory_ok(h_fused, h_plain, k, floor_rel=1e-10):
    """rho_history over the first k steps, restricted to entries above the
    f32 noise floor (floor_rel * rho_0)."""
    hf = h_fused[1:k + 1].double().cpu().numpy()
    hp = h_plain[1:k + 1].double().cpu().numpy()
    keep = hp > floor_rel * float(h_plain[0])
    if not keep.any():
        return True, 0
    ok = np.allclose(hf[keep], hp[keep], rtol=TRAJ_RTOL, atol=0)
    return ok, int(keep.sum())


def phase_main_path(dev, big, big_full, ops, card):
    import torch

    from conjugategradient_tpu_torch import cg_solve, fused_bell_cg_solve, jacobi_preconditioner
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.utils import Timer

    p3d, p3d_full = ops["p3d"], ops["p3d_full"]
    results = {}
    # (a) the tester, the reference protocol's entry point, in both blocked
    # layouts (bell: kernels 4, 2/3 per step and kernel 5 for rel_error)
    for layout in ("symbell", "bell"):
        for path in MATRICES:
            for precond in ("none", "jacobi"):
                n = read_csr_host(os.path.join(ROOT, path))[3][0]
                tol = TOL_SOLVE_REL * bnorm(n)
                dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, tol)
                it = summ["iterations"][0]
                what = f"tester {path} --layout {layout} --precond {precond}"
                check(summ["converged"][0], f"{what}: not converged in {it}")
                check(math.isfinite(rel) and rel < REL_ERROR_BOUND,
                      f"{what}: rel_error {rel} >= {REL_ERROR_BOUND}")
                print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its "
                      f"({ms / max(it, 1):.4f} ms/it), rel_error {rel:.3e}  [{card}]")
                results[(path, layout, precond)] = (ms, it)

    # (b) n = 262,144 block-tridiagonal: 256 timed steps, then to tolerance
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    steps = 256
    # tol = -1: no tolerance stops it.  This operator (kappa ~ 1.004) drives
    # the recurrence residual to f32 underflow in ~15 steps; from there the
    # rho == 0 guard keeps every step a full pass over the tiles.
    fused_bell_cg_solve(big, b, tol=-1.0, maxiter=steps)
    t = Timer(dev).start_measure()
    _, info = fused_bell_cg_solve(big, b, tol=-1.0, maxiter=steps)
    t.stop_measure()
    check(int(info.iterations) == steps, f"fixed run took {int(info.iterations)} steps")
    ms_it = t.get_duration() / steps
    eff = big.full_tile_bytes() + 10 * n * 4
    streamed = big.tile_bytes() + 10 * n * 4
    print(f"  fused CG n={n} banded: {ms_it:.5f} ms/it, effective "
          f"{eff / ms_it / 1e6:.1f} GB/s (full-layout {eff / 1e6:.1f} MB/it), "
          f"streamed {streamed / ms_it / 1e6:.1f} GB/s ({streamed / 1e6:.1f} MB/it)  [{card}]")
    # the card's stream rate, measured here: one 1 GiB device-to-device copy
    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbps = 2 * src.numel() * 4 / cuda_ms(lambda: dst.copy_(src), reps=10) / 1e6
    del src, dst
    print(f"  stream copy {copy_gbps:.1f} GB/s; fused CG streams at "
          f"{streamed / ms_it / 1e6 / copy_gbps:.3f} of it  [{card}]")
    run64 = lambda: fused_bell_cg_solve(big, b, tol=-1.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64()
    t.stop_measure()
    busy = device_ms(run64, reps=1)
    if busy is not None:
        print(f"  fused CG n={n}, 64 steps: device busy {busy:.4f} of "
              f"{t.get_duration():.4f} ms wall ({100 * busy / t.get_duration():.1f}%)  [{card}]")
    else:
        print("  device busy share: not measured (no device time in the trace)")
    _, info2 = fused_bell_cg_solve(big, b, tol=-1.0, maxiter=steps)
    check(torch.equal(info.rho_history.view(torch.int32), info2.rho_history.view(torch.int32)),
          "two fused runs gave different rho_history bits")

    # (b') the same operator in full storage: kernel 4 streams every tile
    fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=steps)
    t = Timer(dev).start_measure()
    _, infof = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=steps)
    t.stop_measure()
    check(int(infof.iterations) == steps, f"full fixed run took {int(infof.iterations)} steps")
    ms_it_full = t.get_duration() / steps
    streamed_full = big_full.tile_bytes() + 10 * n * 4
    print(f"  fused CG n={n} full storage: {ms_it_full:.5f} ms/it, streamed "
          f"{streamed_full / ms_it_full / 1e6:.1f} GB/s ({streamed_full / 1e6:.1f} MB/it), "
          f"{streamed_full / ms_it_full / 1e6 / copy_gbps:.3f} of the copy rate; "
          f"symmetric {ms_it:.5f} ms/it  [{card}]")
    run64f = lambda: fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64f()
    t.stop_measure()
    busy = device_ms(run64f, reps=1)
    if busy is not None:
        print(f"  fused CG n={n} full, 64 steps: device busy {busy:.4f} of "
              f"{t.get_duration():.4f} ms wall ({100 * busy / t.get_duration():.1f}%)  [{card}]")
    _, infof2 = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=steps)
    check(torch.equal(infof.rho_history.view(torch.int32), infof2.rho_history.view(torch.int32)),
          "two full-storage fused runs gave different rho_history bits")
    results["big_full"] = (ms_it_full, streamed_full, copy_gbps)

    cg_solve(big, b, tol=-1.0, maxiter=32, fused="never")
    t = Timer(dev).start_measure()
    cg_solve(big, b, tol=-1.0, maxiter=64, fused="never")
    t.stop_measure()
    plain_ms_it = t.get_duration() / 64
    print(f"  plain-torch CG n={n}: {plain_ms_it:.5f} ms/it, effective "
          f"{eff / plain_ms_it / 1e6:.1f} GB/s  [{card}]")
    results["big"] = (ms_it, plain_ms_it, eff, streamed)

    # fused against the portable loop (plain torch on symmetric storage; on
    # full storage its SpMV is kernel 5)
    for label, a, M in (
        ("tridiag", big, None),
        ("poisson3d_48", p3d, None),
        ("poisson3d_48 jacobi", p3d, "jacobi"),
        ("tridiag full", big_full, None),
        ("poisson3d_48 full", p3d_full, None),
        ("poisson3d_48 full jacobi", p3d_full, "jacobi"),
    ):
        bb = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev)
        tt = TOL_SOLVE_REL * bnorm(a.n)
        Mf = jacobi_preconditioner(a) if M else None
        _, fin = cg_solve(a, bb, tol=tt, M=Mf)
        _, pin = cg_solve(a, bb, tol=tt, M=Mf, fused="never")
        _, f25 = cg_solve(a, bb, tol=0.0, maxiter=25, M=Mf)
        _, p25 = cg_solve(a, bb, tol=0.0, maxiter=25, M=Mf, fused="never")
        ok, used = trajectory_ok(f25.rho_history, p25.rho_history, 25)
        check(ok, f"{label}: fused vs plain rho_history differ beyond rtol {TRAJ_RTOL}")
        check(bool(fin.converged) and bool(pin.converged), f"{label}: a solve did not converge")
        di = abs(int(fin.iterations) - int(pin.iterations))
        check(di <= ITER_SLACK, f"{label}: iterations {int(fin.iterations)} vs {int(pin.iterations)}")
        _, fin2 = cg_solve(a, bb, tol=tt, M=Mf)
        check(torch.equal(fin.rho_history.view(torch.int32), fin2.rho_history.view(torch.int32)),
              f"{label}: fused rho_history not bitwise repeatable")
        print(f"  {label}: fused {int(fin.iterations)} its vs plain {int(pin.iterations)}; "
              f"25-step trajectory agrees on {used} entries; bitwise repeat ok")

    phase_bell_paths(dev, ops, card)

    # the tester's default path: CSR, float64, portable loop; its SpMV is a
    # segmented reduction that must repeat bit for bit on the card
    from conjugategradient_tpu_torch import load_matrix

    csr = load_matrix(os.path.join(ROOT, MATRICES[0]), layout="csr",
                      dtype=np.float64, device=dev)
    b64 = torch.arange(1, csr.n + 1, dtype=torch.float64, device=dev)
    _, i64 = cg_solve(csr, b64, tol=1e-8 * bnorm(csr.n))
    _, i64b = cg_solve(csr, b64, tol=1e-8 * bnorm(csr.n))
    check(bool(i64.converged), "csr float64 solve did not converge")
    check(torch.equal(i64.rho_history.view(torch.int64), i64b.rho_history.view(torch.int64)),
          "csr float64 history not repeatable")
    print(f"  csr float64 poisson3d_48: {int(i64.iterations)} its, bitwise repeat ok")
    torch.cuda.synchronize()
    return results


def phase_bell_paths(dev, ops, card):
    """The portable loop on load_matrix's default 8 x 128 tiles, residual
    replacement on the three loops, and an x0 warm start."""
    import torch

    from conjugategradient_tpu_torch import accuracy, cg_solve, fused_bell_cg_solve
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.utils import Timer

    # (c) the portable loop on full storage with bm != bn: kernel 5 once a step
    p8 = ops["p3d_8"]
    check((p8.bm, p8.bn) == (8, 128), f"load_matrix default tiles {p8.bm}x{p8.bn}")
    bb = torch.arange(1, p8.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(p8.n)
    cg_solve(p8, bb, tol=tt, maxiter=8)
    before = fc.LAUNCHES["bell_spmv"]
    t = Timer(dev).start_measure()
    x, info = cg_solve(p8, bb, tol=tt)
    t.stop_measure()
    k = int(info.iterations)
    launched = fc.LAUNCHES["bell_spmv"] - before
    rel = float(accuracy(p8, bb, x))
    check(bool(info.converged), f"portable bell 8x128: not converged in {k}")
    check(launched >= k + 1, f"portable bell 8x128: {launched} SpMV launches for {k} steps")
    check(rel < REL_ERROR_BOUND, f"portable bell 8x128: rel_error {rel}")
    print(f"  portable loop poisson3d_48 bell 8x128: {k} its, {launched} kernel-5 launches, "
          f"{t.get_duration() / k:.4f} ms/it, rel_error {rel:.3e}  [{card}]")

    # (d) recompute_r_every on the fused symmetric and full solves and the
    # portable loop, against the same solves by the plain versions (CPU)
    path = MATRICES[1]
    sym, full, b8 = load_symbell(path, dev), load_bell(path, dev), load_bell(path, dev, bm=8)
    be = torch.arange(1, sym.n + 1, dtype=torch.float32, device=dev)
    for label, a, run in (
        ("fused symmetric", sym, fused_bell_cg_solve),
        ("fused full", full, fused_bell_cg_solve),
        ("portable bell 8x128", b8, cg_solve),
    ):
        _, ic = run(a, be, tol=0.0, maxiter=32, recompute_r_every=RESTART_EVERY)
        _, ip = run(a.to("cpu"), be.cpu(), tol=0.0, maxiter=32, recompute_r_every=RESTART_EVERY)
        hc, hp = ic.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        check(int(ic.iterations) == 32 and np.isfinite(hc).all(),
              f"restart {label}: {int(ic.iterations)} steps, history finite {np.isfinite(hc).all()}")
        err = float(np.max(np.abs(hc - hp) / np.abs(hp)))
        check(err <= RESTART_RTOL, f"restart {label}: card vs plain rel diff {err}")
        print(f"  recompute_r_every={RESTART_EVERY} {label} elasticity3d_16: 32 steps, "
              f"max rel diff to the plain versions {err:.3g}")

    # (e) x0 warm start: r0 = b - A x0 through kernel 5
    p3f = ops["p3d_full"]
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(p3f.n),
                         dtype=torch.float32, device=dev)
    bb = torch.arange(1, p3f.n + 1, dtype=torch.float32, device=dev)
    before = fc.LAUNCHES["bell_spmv"]
    x, info = fused_bell_cg_solve(p3f, bb, x0, tol=TOL_SOLVE_REL * bnorm(p3f.n))
    r0 = (bb.cpu() - p3f.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rho_history[0]) / float(r0 @ r0) - 1)
    rel = float(accuracy(p3f, bb, x))
    check(fc.LAUNCHES["bell_spmv"] > before, "x0 warm start did not launch kernel 5")
    check(bool(info.converged) and rel < REL_ERROR_BOUND,
          f"x0 warm start: converged {bool(info.converged)}, rel_error {rel}")
    check(e0 <= TOL_DOT, f"x0 warm start: ||r0||^2 off the plain version by {e0}")
    print(f"  x0 warm start poisson3d_48 full: {int(info.iterations)} its, ||r0||^2 "
          f"rel diff {e0:.3g}, rel_error {rel:.3e}")


def phase_dia_path(dev, ops, card):
    """The DIA / SELL path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import SellMatrix, cg_solve, jacobi_preconditioner, load_matrix
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import cg as cg_mod
    from conjugategradient_tpu_torch.utils import Timer

    # (a) the tester: --layout auto resolves poisson3d_48 to DIA, which the
    # dia_spmv counter shows; symdia with Jacobi PCG
    path = MATRICES[0]
    n = read_csr_host(os.path.join(ROOT, path))[3][0]
    for layout, precond, kernel in (("auto", "none", "dia_spmv"),
                                    ("symdia", "jacobi", "sym_dia_spmv")):
        before = _common.LAUNCHES[kernel]
        dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, TOL_SOLVE_REL * bnorm(n))
        it = summ["iterations"][0]
        launched = _common.LAUNCHES[kernel] - before
        what = f"tester {path} --layout {layout} --precond {precond}"
        check(summ["converged"][0], f"{what}: not converged in {it}")
        check(math.isfinite(rel) and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
        check(launched >= 2 * it, f"{what}: {launched} {kernel} launches for 2 solves of {it} steps")
        print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} "
              f"ms/it), {launched} {kernel} launches, rel_error {rel:.3e}  [{card}]")

    # (b) --layout auto --reorder on powerlaw_1138 resolves to SELL (plain
    # torch: no kernel of this package)
    path = "problems/powerlaw_1138.mtx"
    op, _ = load_matrix(os.path.join(ROOT, path), layout="auto", reorder=True, device=dev)
    check(isinstance(op, SellMatrix) and op.pos_identity,
          f"auto --reorder on {path} gave {type(op).__name__}")
    before = dict(_common.LAUNCHES)
    n = op.n
    dim, nnz, ms, rel, summ, _ = run_tester(path, "auto", "jacobi", TOL_SOLVE_REL * bnorm(n),
                                            extra=("--reorder",))
    check(summ["converged"][0] and rel < REL_ERROR_BOUND, f"tester {path} sell: rel_error {rel}")
    check(dict(_common.LAUNCHES) == before, "the SELL solve launched a kernel")
    print(f"  tester {path} --layout auto --reorder --precond jacobi (SELL): dim {dim} nnz {nnz} "
          f"{ms:.3f} ms, {summ['iterations'][0]} its, rel_error {rel:.3e}  [{card}]")

    # (c) the float64 auto path (DIA, plain torch) twice: bit for bit
    path = "problems/poisson2d_34.mtx"
    runs = [run_tester(path, "auto", "none", 1e-8 * bnorm(1156), dtype="float64",
                       extra=("--history",)) for _ in range(2)]
    check(runs[0][4]["converged"][0], "f64 auto poisson2d_34 did not converge")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "f64 auto poisson2d_34: the two runs differ")
    print(f"  tester {path} --layout auto --dtype float64 twice: {runs[0][4]['iterations'][0]} its, "
          f"rel_error {runs[0][3]:.3e}, residual history bitwise repeat ok")

    # (d) symdia-big in both storages, DIA_STEPS timed full passes (tol = -1)
    big, big_sym = ops["big"], ops["big_sym"]
    n = big.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    eff = nbytes(big.diags) + 7 * n * 4  # full-layout bytes, bench.py's convention
    for label, a, kernel in (("full", big, "dia_spmv"), ("symmetric", big_sym, "sym_dia_spmv")):
        cg_solve(a, b, tol=-1.0, maxiter=8)
        before = _common.LAUNCHES[kernel]
        t = Timer(dev).start_measure()
        _, info = cg_solve(a, b, tol=-1.0, maxiter=DIA_STEPS)
        t.stop_measure()
        check(int(info.iterations) == DIA_STEPS, f"symdia-big {label}: {int(info.iterations)} steps")
        launched = _common.LAUNCHES[kernel] - before
        check(launched >= DIA_STEPS + 1, f"symdia-big {label}: {launched} launches")
        ms_it = t.get_duration() / DIA_STEPS
        streamed = nbytes(a.diags) + 7 * n * 4
        busy = device_ms(lambda: cg_solve(a, b, tol=-1.0, maxiter=DIA_STEPS), reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy / DIA_STEPS:.5f} ms/it ({100 * busy / t.get_duration():.1f}%)"
        print(f"  CG symdia-big {label} ({a.ndiag} diagonals): {ms_it:.5f} ms/it, effective "
              f"{eff / ms_it / 1e6:.1f} GB/s ({eff / 1e6:.1f} MB/it full layout), streamed "
              f"{streamed / ms_it / 1e6:.1f} GB/s; device busy {busy_s}; {launched} launches  "
              f"[{card}]")

    # (e) a float32 DIA solve twice (bitwise), and the card against the plain
    # versions on the CPU over 32 steps (trajectory), with and without
    # residual replacement, and symmetric storage with Jacobi
    p3d, p3d_sym = ops["p3d"], ops["p3d_sym"]
    bb = torch.arange(1, p3d.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(p3d.n)
    with count_steps(cg_mod, "cg_step") as counter:
        _, i1 = cg_solve(p3d, bb, tol=tt)
    check_stops_at_done("portable DIA CG poisson3d_48", counter.calls, int(i1.iterations))
    _, i2 = cg_solve(p3d, bb, tol=tt)
    check(bool(i1.converged), "f32 DIA poisson3d_48 did not converge")
    check(torch.equal(i1.rho_history.view(torch.int32), i2.rho_history.view(torch.int32)),
          "f32 DIA solve: rho_history not bitwise repeatable")
    print(f"  f32 DIA poisson3d_48: {int(i1.iterations)} its, bitwise repeat ok")
    for label, a, pc, every in (("dia", p3d, False, 0), ("dia", p3d, False, RESTART_EVERY),
                                ("symdia jacobi", p3d_sym, True, 0)):
        Mc = jacobi_preconditioner(a) if pc else None
        ac = a.to("cpu")
        Mp = jacobi_preconditioner(ac) if pc else None
        _, ic = cg_solve(a, bb, tol=0.0, maxiter=32, M=Mc, recompute_r_every=every)
        _, ip = cg_solve(ac, bb.cpu(), tol=0.0, maxiter=32, M=Mp, recompute_r_every=every)
        hc, hp = ic.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        check(np.isfinite(hc).all(), f"f32 {label}: history not finite")
        err = float(np.max(np.abs(hc - hp) / np.abs(hp)))
        check(err <= RESTART_RTOL, f"f32 {label} every={every}: card vs plain rel diff {err}")
        print(f"  f32 {label} poisson3d_48 recompute_r_every={every}: 32 steps, max rel diff "
              f"to the plain versions on the CPU {err:.3g}")
    torch.cuda.synchronize()


# ---- phase 2, stencil: kernels 11-13 against their plain versions ------------

def conv3d_stencil(u, center, off):
    """The 7-point stencil as one cuDNN 3-D convolution (3x3x3 weight,
    zero padding 1): the library yardstick, which the port never calls."""
    import torch

    wgt = torch.zeros(1, 1, 3, 3, 3, dtype=u.dtype, device=u.device)
    wgt[0, 0, 1, 1, 1] = center
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        wgt[0, 0, i, j, k] = off
    return lambda: torch.nn.functional.conv3d(u[None, None], wgt, padding=1)[0, 0]


def nan_mask(shape, at, dev):
    """Where a NaN at ``at`` must reach: the point and its six neighbours."""
    import torch

    want = torch.zeros(shape, dtype=torch.bool, device=dev)
    for d in ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)):
        idx = tuple(a + b for a, b in zip(at, d))
        if all(0 <= i < n for i, n in zip(idx, shape)):
            want[idx] = True
    return want


def check_stencil7(shape, dtype, dev, errs, rng):
    """stencil7 bit for bit against its plain version, and a NaN at one
    point reaching only that point and its six neighbours in both."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    u = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    yk, yp = ks.stencil7(u, 6.0, -1.0), ks._stencil7_plain(u, 6.0, -1.0)
    torch.cuda.synchronize()
    e, m = rel_max_err(yk, yp)
    check(torch.equal(yk, yp), f"stencil7 {shape} {dtype}: not bit-equal to the plain version ({e})")
    at = tuple(n // 2 for n in shape)
    u[at] = float("nan")
    yk, yp = ks.stencil7(u, 6.0, -1.0), ks._stencil7_plain(u, 6.0, -1.0)
    want = nan_mask(shape, at, dev)
    check(torch.equal(torch.isnan(yk), want) and torch.equal(torch.isnan(yp), want)
          and torch.equal(yk.nan_to_num(), yp.nan_to_num()),
          f"stencil7 {shape} {dtype}: a NaN reached other points than its neighbours")
    errs["stencil7"] = max(errs["stencil7"], e)
    print(f"  stencil7 {str(shape):<16} {str(dtype):<14} bit-equal (max|y| {m:.4g}); "
          f"NaN reaches {int(want.sum())} points in both")
    return u


def check_fused_stencil(shape, dev, errs, rng):
    """fused_stencil_dir_dot: p_new and q bit-equal to the plain version,
    pap within TOL_DOT, two launches bit-identical, a no-op once not live."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_stencil as kfs

    def vol():
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    r, pold = vol(), vol()
    beta = torch.tensor([[0.37]], dtype=torch.float32, device=dev)
    k1 = kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0)
    k2 = kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0)
    pl = kfs._fused_stencil_dir_plain(r, pold, beta, 6.0, -1.0, None, None)
    torch.cuda.synchronize()
    check(torch.equal(k1[0], pl[0]) and torch.equal(k1[1], pl[1]),
          f"fused_stencil_dir_dot {shape}: p_new or q not bit-equal to the plain version")
    e_pap = abs(float(k1[2]) - float(pl[2]))
    check(e_pap <= TOL_DOT * abs(float(pl[2])),
          f"fused_stencil_dir_dot {shape}: pap {float(k1[2])} vs {float(pl[2])}")
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"fused_stencil_dir_dot {shape}: two launches differ")
    w = fc.FusedWork.new(dev, maxiter=4)
    w.ctl[fc.C_LIVE] = 0
    out = (torch.full_like(r, 7.0), torch.full_like(r, 7.0))
    kept = [o.clone() for o in out] + [w.scal.clone()]
    kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0, out=out, work=w)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(kept, [*out, w.scal])),
          f"fused_stencil_dir_dot {shape}: launched with live = 0, it changed its outputs")
    errs["fused_stencil_dir_dot"] = max(errs["fused_stencil_dir_dot"], e_pap)
    print(f"  fused_stencil_dir_dot {str(shape):<16} p_new, q bit-equal; |dpap|={e_pap:.3g} "
          f"(pap {float(pl[2]):.6g}); repeat bit-identical; no-op at live = 0")
    return r, pold, beta


def phase_stencil_kernels(dev, errs, times, extra):
    """Kernels 11-13 against their plain versions and timed, at 256^3 and at
    small ragged shapes."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_stencil as kfs
    from conjugategradient_tpu_torch.ops.cuda import stencil as ks

    rng = np.random.default_rng(4)
    n = int(np.prod(STENCIL_GRID))
    big = {}
    for dtype in (torch.float32, torch.float64):
        for shape in (STENCIL_GRID,) + STENCIL_SMALL:
            u = check_stencil7(shape, dtype, dev, errs, rng)
            if shape == STENCIL_GRID:
                big[dtype] = u.nan_to_num_(0.0)
    for shape in (STENCIL_GRID, STENCIL_SMALL[0]):
        args = check_fused_stencil(shape, dev, errs, rng)
        if shape == STENCIL_GRID:
            r, pold, beta = args
    for length in (210, 4097):  # n % 4 != 0: the kernel's scalar tail
        check_update((length,), rng, False, errs, f"n={length}", dev)
    x, p, rr, q, _, alpha = check_update((n,), rng, False, errs, "256^3", dev)

    torch.backends.cudnn.allow_tf32 = False  # the yardstick in full float32
    for dtype, key in ((torch.float32, "stencil7"), (torch.float64, "stencil7 float64 256^3")):
        u = big[dtype]
        t = time_pair(lambda: ks.stencil7(u, 6.0, -1.0), lambda: ks._stencil7_plain(u, 6.0, -1.0))
        t.update(bound(2 * nbytes(u), 8 * n,
                       PEAK_F32_PER_S if dtype == torch.float32 else PEAK_F64_PER_S))
        conv = conv3d_stencil(u, 6.0, -1.0)
        e, m = rel_max_err(conv(), ks.stencil7(u, 6.0, -1.0))
        check(e <= TOL_Q * m, f"conv3d yardstick {dtype}: differs from stencil7 by {e} (max {m})")
        t["library_ms"] = library_ms(conv)
        if key == "stencil7":
            times[key] = t
        else:
            extra[key] = t
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    t = time_pair(lambda: kfs.fused_stencil_dir_dot(r, pold, beta, 6.0, -1.0, out=out, work=work),
                  lambda: kfs._fused_stencil_dir_plain(r, pold, beta, 6.0, -1.0, None, None))
    t.update(bound(4 * n * 4, 12 * n), library_ms=None)  # r, p_old in; p_new, q out
    times["fused_stencil_dir_dot"] = t
    out = (torch.empty_like(x), torch.empty_like(x))
    t = time_pair(lambda: fc.fused_update_dot(x, p, rr, q, alpha, out=out, work=work),
                  lambda: fc._update_plain("fused_update_dot", x, p, rr, q, None, alpha, None, None))
    t.update(bound(6 * n * 4, 6 * n), library_ms=None)
    extra["fused_update_dot 256^3"] = t
    torch.cuda.synchronize()


# ---- phase 3, stencil: the matrix-free path (BASELINE config 4) ---------------

def stencil_rhs(n, dev, scale=1.0):
    import torch

    return torch.arange(1, n + 1, dtype=torch.float32, device=dev) / scale


def phase_stencil_path(dev, card):
    """The stencil path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (StencilOperator, accuracy, cg_solve,
                                             fused_stencil_cg_solve, multigrid_preconditioner)
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import cg as cg_mod
    from conjugategradient_tpu_torch.utils import Timer

    # (a) the tester: stencil:64 float32 takes the fused path
    n64 = 64 ** 3
    before = dict(_common.LAUNCHES)
    dim, nnz, ms, rel, summ, _ = run_tester("stencil:64", "csr", "none", TOL_SOLVE_REL * bnorm(n64))
    it = summ["iterations"][0]
    fused = _common.LAUNCHES["fused_stencil_dir_dot"] - before["fused_stencil_dir_dot"]
    check(summ["converged"][0] and math.isfinite(rel) and rel < REL_ERROR_BOUND,
          f"tester stencil:64 f32: converged {summ['converged'][0]} rel_error {rel}")
    check(fused >= 2 * it, f"tester stencil:64 f32: {fused} fused launches for 2 solves of {it}")
    print(f"  tester stencil:64 --dtype float32: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its "
          f"({ms / max(it, 1):.4f} ms/it), rel_error {rel:.3e}  [{card}]")
    # (b) float64 stencil:48 (portable loop on the float64 kernel) twice, bitwise
    n48 = 48 ** 3
    runs = [run_tester("stencil:48", "csr", "none", 1e-8 * bnorm(n48), dtype="float64",
                       extra=("--history",)) for _ in range(2)]
    check(runs[0][4]["converged"][0] and runs[0][3] < REL_ERROR_BOUND,
          f"tester stencil:48 f64: rel_error {runs[0][3]}")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "tester stencil:48 f64: the two runs differ")
    print(f"  tester stencil:48 --dtype float64 twice: {runs[0][4]['iterations'][0]} its, "
          f"{runs[0][2]:.3f} ms, rel_error {runs[0][3]:.3e}, history bitwise repeat ok  [{card}]")
    # (c) the tester with Jacobi and with multigrid, both smoothers
    for precond, extra in (("jacobi", ()), ("amg", ()), ("amg", ("--smoother", "chebyshev"))):
        dim, nnz, ms, rel, summ, _ = run_tester("stencil:64", "csr", precond,
                                                TOL_SOLVE_REL * bnorm(n64), extra=extra)
        it = summ["iterations"][0]
        what = f"tester stencil:64 --precond {precond} {' '.join(extra)}"
        check(summ["converged"][0] and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
        print(f"  {what}: {it} its, {ms:.3f} ms ({ms / max(it, 1):.4f} ms/it), "
              f"rel_error {rel:.3e}  [{card}]")

    # (d) 256^3: the fused stencil CG over STENCIL_STEPS full steps (tol = -1)
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    n = op.shape[0]
    b = stencil_rhs(n, dev, scale=n)
    fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=16)
    t = Timer(dev).start_measure()
    _, info = fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=STENCIL_STEPS)
    t.stop_measure()
    check(int(info.iterations) == STENCIL_STEPS, f"stencil fixed run took {int(info.iterations)}")
    ms_it = t.get_duration() / STENCIL_STEPS
    per_it = 10 * n * 4  # kernel 12: 4 volumes; kernel 2: 6
    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbps = 2 * src.numel() * 4 / cuda_ms(lambda: dst.copy_(src), reps=10) / 1e6
    del src, dst
    print(f"  fused stencil CG 256^3: {ms_it:.5f} ms/it, effective {per_it / ms_it / 1e6:.1f} "
          f"GB/s on {per_it / 1e6:.1f} MB/it (bound {per_it / PEAK_BYTES_PER_S * 1e3:.4f} ms/it), "
          f"{per_it / ms_it / 1e6 / copy_gbps:.3f} of the {copy_gbps:.1f} GB/s copy rate  [{card}]")
    run64 = lambda: fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64()
    t.stop_measure()
    busy = device_ms(run64, reps=1)
    busy_s = "not measured" if busy is None else \
        f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
    print(f"  fused stencil CG 256^3, 64 steps: device busy {busy_s}  [{card}]")
    _, info2 = fused_stencil_cg_solve(op, b, tol=-1.0, maxiter=STENCIL_STEPS)
    check(torch.equal(info.rho_history.view(torch.int32), info2.rho_history.view(torch.int32)),
          "two fused stencil runs gave different rho_history bits")
    cg_solve(op, b, tol=-1.0, maxiter=4, fused="never")
    t = Timer(dev).start_measure()
    _, pi = cg_solve(op, b, tol=-1.0, maxiter=32, fused="never")
    t.stop_measure()
    plain_ms_it = t.get_duration() / 32
    ok, used = trajectory_ok(info.rho_history, pi.rho_history, 25)
    check(ok, f"stencil 256^3: fused vs portable rho_history differ beyond rtol {TRAJ_RTOL}")
    print(f"  portable loop (fused='never') 256^3: {plain_ms_it:.5f} ms/it; fused vs portable "
          f"25-step trajectory agrees on {used} entries  [{card}]")

    # (e) bench.py's mgpcg comparison: time to tol 1e-5 ||b||, b = arange/n
    bn_ = float(b.double().norm())
    tol = TOL_SOLVE_REL * bn_
    rows = {}
    for label, M in (("plain fused CG", None),
                     ("MG-PCG jacobi", multigrid_preconditioner(op)),
                     ("MG-PCG chebyshev", multigrid_preconditioner(op, smoother="chebyshev"))):
        cg_solve(op, b, tol=tol, M=M)
        with count_steps(cg_mod, "cg_step") as counter:  # the portable loop's steps
            t = Timer(dev).start_measure()
            x, info = cg_solve(op, b, tol=tol, M=M)
            t.stop_measure()
        if M is not None:
            check_stops_at_done(f"{label} 256^3", counter.calls, int(info.iterations))
        true_rel = float((b - op.matvec(x)).double().norm()) / bn_
        # float32's attainable accuracy here is ~eps * kappa ~ 3e-3 of ||b||
        check(bool(info.converged) and true_rel < F32_TRUE_REL_FLOOR,
              f"{label} 256^3: converged {bool(info.converged)}, true rel residual {true_rel}")
        rows[label] = (t.get_duration(), int(info.iterations))
        busy = device_ms(lambda: cg_solve(op, b, tol=tol, M=M), reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy:.2f} ms ({100 * busy / t.get_duration():.1f}%)"
        print(f"  {label} 256^3 to 1e-5 ||b||: {t.get_duration():.2f} ms, {int(info.iterations)} its "
              f"({t.get_duration() / int(info.iterations):.4f} ms/it), true rel residual "
              f"{true_rel:.3e}; device busy {busy_s}  [{card}]")
    # one V-cycle apply: host wall, device time, kernels and the longest ones
    r = stencil_rhs(n, dev, scale=n)
    for label, M in (("jacobi", multigrid_preconditioner(op)),
                     ("chebyshev", multigrid_preconditioner(op, smoother="chebyshev"))):
        wall = cuda_ms(lambda: M(r), reps=5, warm=1)
        prof = kernel_profile(lambda: M(r))
        if prof is None:
            print(f"  V-cycle apply 256^3 {label}: {wall:.3f} ms; device time not measured")
            continue
        dev_ms, launched, top = prof
        names = "; ".join(f"{k[:48]} {ms:.3f} ms x{c}" for k, ms, c in top)
        print(f"  V-cycle apply 256^3 {label}: {wall:.3f} ms wall, {dev_ms:.3f} ms device "
              f"({100 * dev_ms / wall:.1f}%), {launched} device launches; longest: {names}  [{card}]")
    plain_it = rows["plain fused CG"][1]
    for label in ("MG-PCG jacobi", "MG-PCG chebyshev"):
        check(5 * rows[label][1] <= plain_it, f"{label}: {rows[label][1]} its vs plain {plain_it}")
        print(f"  {label}: {plain_it / rows[label][1]:.1f}x fewer iterations, "
              f"{rows['plain fused CG'][0] / rows[label][0]:.2f}x the plain solve's speed")

    # (f) residual replacement every RESTART_EVERY steps, card against the
    # plain versions on the CPU; a ragged grid too (kernel 2's scalar tail)
    for grid in ((64, 64, 64), (33, 35, 37)):
        sop = StencilOperator.poisson(grid, device=dev)
        bs = stencil_rhs(sop.shape[0], dev)
        _, ic = fused_stencil_cg_solve(sop, bs, tol=0.0, maxiter=32, recompute_r_every=RESTART_EVERY)
        _, ip = fused_stencil_cg_solve(sop.to("cpu"), bs.cpu(), tol=0.0, maxiter=32,
                                       recompute_r_every=RESTART_EVERY)
        hc, hp = ic.rho_history.double().cpu().numpy(), ip.rho_history.double().numpy()
        check(int(ic.iterations) == 32 and np.isfinite(hc).all(), f"restart stencil {grid}")
        err = float(np.max(np.abs(hc - hp) / np.abs(hp)))
        check(err <= RESTART_RTOL, f"restart stencil {grid}: card vs plain rel diff {err}")
        print(f"  recompute_r_every={RESTART_EVERY} fused stencil {grid}: 32 steps, max rel diff "
              f"to the plain versions on the CPU {err:.3g}")
    # (g) x0 warm start: r0 = b - A x0 through stencil7
    sop = StencilOperator.poisson((64, 64, 64), device=dev)
    bs = stencil_rhs(sop.shape[0], dev)
    x0 = torch.as_tensor(np.random.default_rng(6).standard_normal(sop.shape[0]),
                         dtype=torch.float32, device=dev)
    before = _common.LAUNCHES["stencil7"]
    x, info = fused_stencil_cg_solve(sop, bs, x0, tol=TOL_SOLVE_REL * bnorm(sop.shape[0]))
    r0 = (bs.cpu() - sop.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rho_history[0]) / float(r0 @ r0) - 1)
    rel = float(accuracy(sop, bs, x))
    check(_common.LAUNCHES["stencil7"] > before, "x0 warm start did not launch stencil7")
    check(bool(info.converged) and rel < REL_ERROR_BOUND and e0 <= TOL_DOT,
          f"stencil x0 warm start: converged {bool(info.converged)}, rel_error {rel}, r0 {e0}")
    print(f"  x0 warm start stencil 64^3: {int(info.iterations)} its, ||r0||^2 rel diff {e0:.3g}, "
          f"rel_error {rel:.3e}")
    torch.cuda.synchronize()


# ---- phase 3, MINRES: the symmetric-indefinite path ---------------------------

class count_steps(contextlib.AbstractContextManager):
    """Count the calls of a portable loop's step function (``cg_step`` of
    solver/cg.py or ``minres_step`` of solver/minres.py) while inside."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def check_stops_at_done(label, launched, iterations):
    """The repair of the portable loop: steps launched against iterations."""
    extra = launched - iterations
    check(0 <= extra <= STEPS_AFTER_DONE,
          f"{label}: {launched} steps launched for {iterations} iterations "
          f"(more than {STEPS_AFTER_DONE} after done)")
    print(f"  {label}: {launched} steps launched for {iterations} iterations "
          f"({extra} after done; at most {STEPS_AFTER_DONE})")


def ritz_shift(op, fraction):
    """A shift strictly inside the spectrum: ``fraction`` of the way from
    the smallest to the largest Ritz value of 30 Lanczos steps (both lie
    inside the spectrum, so A - shift I is indefinite)."""
    from conjugategradient_tpu_torch.solver.cg import _lanczos_ritz_extremes

    lo, hi = _lanczos_ritz_extremes(op, 30, 0)
    return lo + fraction * (hi - lo), lo, hi


def phase_minres_path(dev, big, big_full, ops, card):
    """The MINRES path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (fused_minres_solve, jacobi_preconditioner,
                                             minres_solve)
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.solver import minres as minres_mod
    from conjugategradient_tpu_torch.solver.fused_minres import fused_minres_init, fused_minres_step
    from conjugategradient_tpu_torch.utils import Timer

    p3d, p3d_full = ops["p3d"], ops["p3d_full"]
    path = MATRICES[0]
    n = read_csr_host(os.path.join(ROOT, path))[3][0]
    tol = TOL_SOLVE_REL * bnorm(n)
    minres = ("--method", "minres")
    # (a) the tester with --method minres, both blocked layouts
    for layout, kernel in (("symbell", "sym_minres_dir_spmv_dot"), ("bell", "minres_dir_spmv_dot")):
        for precond in ("none", "jacobi"):
            before = _common.LAUNCHES[kernel]
            dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, tol, extra=minres)
            it = summ["iterations"][0]
            launched = _common.LAUNCHES[kernel] - before
            what = f"tester {path} --method minres --layout {layout} --precond {precond}"
            check(summ["converged"][0], f"{what}: not converged in {it}")
            check(math.isfinite(rel) and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
            check(launched >= 2 * it, f"{what}: {launched} {kernel} launches for 2 solves of {it}")
            print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} "
                  f"ms/it), rel_error {rel:.3e}  [{card}]")
    # once with a shift inside the spectrum (indefinite)
    shift, lo, hi = ritz_shift(p3d, 0.002)
    dim, nnz, ms, rel, summ, _ = run_tester(path, "symbell", "none", tol,
                                            extra=minres + ("--shift", repr(shift)))
    it = summ["iterations"][0]
    check(summ["converged"][0] and math.isfinite(rel) and rel < REL_ERROR_BOUND,
          f"tester --method minres --shift {shift}: converged {summ['converged'][0]} "
          f"in {it}, rel_error {rel}")
    print(f"  tester {path} --method minres --layout symbell --shift {shift:.5f} (Ritz extremes "
          f"{lo:.4f}, {hi:.4f}): {it} its, {ms:.3f} ms, rel_error {rel:.3e}  [{card}]")
    # the float64 CSR path (portable loop) twice: bit for bit
    runs = [run_tester(path, "csr", "none", 1e-8 * bnorm(n), dtype="float64",
                       extra=minres + ("--history",)) for _ in range(2)]
    check(runs[0][4]["converged"][0] and runs[0][3] < REL_ERROR_BOUND,
          f"tester --method minres csr f64: rel_error {runs[0][3]}")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "tester --method minres csr f64: the two runs differ")
    print(f"  tester {path} --method minres --layout csr --dtype float64 twice: "
          f"{runs[0][4]['iterations'][0]} its, {runs[0][2]:.3f} ms, rel_error {runs[0][3]:.3e}, "
          f"history bitwise repeat ok  [{card}]")

    # (b) n = 262,144, both storages: MINRES_STEPS timed steps.  tol = -1: this
    # operator (kappa ~ 1.004) drives the estimate to float32 underflow in
    # ~16 steps, and 0 <= 0 would end a tol = 0 run there.
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbps = 2 * src.numel() * 4 / cuda_ms(lambda: dst.copy_(src), reps=10) / 1e6
    del src, dst
    eff = big_full.tile_bytes() + 14 * n * 4
    for label, a in (("symmetric", big), ("full", big_full)):
        fused_minres_solve(a, b, tol=-1.0, maxiter=MINRES_STEPS)
        # bench.py's protocol: the init and MINRES_STEPS steps (no exit work)
        t = Timer(dev).start_measure()
        state = fused_minres_init(a, b, None, MINRES_STEPS, tol=-1.0)
        for _ in range(MINRES_STEPS):
            fused_minres_step(a, state)
        t.stop_measure()
        check(int(state.k) == MINRES_STEPS, f"fused MINRES {label}: {int(state.k)} steps stepped")
        ms_it = t.get_duration() / MINRES_STEPS
        # and the whole solve: the flush and rnorm_true's extra SpMV included
        t = Timer(dev).start_measure()
        _, info = fused_minres_solve(a, b, tol=-1.0, maxiter=MINRES_STEPS)
        t.stop_measure()
        solve_ms = t.get_duration()
        check(int(info.iterations) == MINRES_STEPS and bool(torch.isfinite(info.rnorm_history).all()),
              f"fused MINRES {label}: {int(info.iterations)} steps, history finite "
              f"{bool(torch.isfinite(info.rnorm_history).all())}")
        check(torch.equal(info.rnorm_history.view(torch.int32), state.hist.view(torch.int32)),
              f"fused MINRES {label}: stepping and solving gave different history bits")
        streamed = a.tile_bytes() + 14 * n * 4
        run64 = lambda: fused_minres_solve(a, b, tol=-1.0, maxiter=64)
        t = Timer(dev).start_measure()
        run64()
        t.stop_measure()
        busy = device_ms(run64, reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
        _, info2 = fused_minres_solve(a, b, tol=-1.0, maxiter=MINRES_STEPS)
        check(torch.equal(info.rnorm_history.view(torch.int32), info2.rnorm_history.view(torch.int32)),
              f"fused MINRES {label}: two runs gave different history bits")
        minres_solve(a, b, tol=-1.0, maxiter=8, fused="never")
        t = Timer(dev).start_measure()
        _, pinfo = minres_solve(a, b, tol=-1.0, maxiter=32, fused="never")
        t.stop_measure()
        port_ms_it = t.get_duration() / 32
        print(f"  fused MINRES n={n} {label}: {ms_it:.5f} ms/it (whole solve {solve_ms:.3f} ms for "
              f"{MINRES_STEPS} steps), effective {eff / ms_it / 1e6:.1f} "
              f"GB/s on {eff / 1e6:.1f} MB/it (full layout), streamed {streamed / ms_it / 1e6:.1f} "
              f"GB/s ({streamed / 1e6:.1f} MB/it), {streamed / ms_it / 1e6 / copy_gbps:.3f} of the "
              f"{copy_gbps:.1f} GB/s copy rate; 64 steps: device busy {busy_s}; bitwise repeat ok; "
              f"portable MINRES loop {port_ms_it:.5f} ms/it  [{card}]")

    # (c) fused against the portable loop on the card (the plain torch
    # recurrence; on full storage its SpMV is kernel 5), and repeatability
    for label, a, M in (("tridiag", big, None), ("tridiag full", big_full, None),
                        ("poisson3d_48", p3d, None), ("poisson3d_48 jacobi", p3d, "jacobi"),
                        ("poisson3d_48 full", p3d_full, None),
                        ("poisson3d_48 full jacobi", p3d_full, "jacobi")):
        bb = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
        tt = TOL_SOLVE_REL * float(bb.double().norm())
        Mf = jacobi_preconditioner(a) if M else None
        _, fin = minres_solve(a, bb, tol=tt, M=Mf)
        with count_steps(minres_mod, "minres_step") as counter:
            _, pin = minres_solve(a, bb, tol=tt, M=Mf, fused="never")
        _, f25 = minres_solve(a, bb, tol=0.0, maxiter=25, M=Mf)
        _, p25 = minres_solve(a, bb, tol=0.0, maxiter=25, M=Mf, fused="never")
        hf, hp = f25.rnorm_history.double().cpu().numpy(), p25.rnorm_history.double().cpu().numpy()
        keep = np.isfinite(hp) & (hp > 1e-5 * hp[0])  # above the float32 floor
        check(np.allclose(hf[keep], hp[keep], rtol=MINRES_TRAJ_RTOL, atol=0),
              f"MINRES {label}: fused vs portable history differ beyond rtol {MINRES_TRAJ_RTOL}")
        check(bool(fin.converged) and bool(pin.converged), f"MINRES {label}: a solve did not converge")
        di = abs(int(fin.iterations) - int(pin.iterations))
        check(di <= ITER_SLACK, f"MINRES {label}: iterations {int(fin.iterations)} vs {int(pin.iterations)}")
        _, fin2 = minres_solve(a, bb, tol=tt, M=Mf)
        check(torch.equal(fin.rnorm_history.view(torch.int32), fin2.rnorm_history.view(torch.int32)),
              f"MINRES {label}: fused history not bitwise repeatable")
        print(f"  MINRES {label}: fused {int(fin.iterations)} its vs portable {int(pin.iterations)}; "
              f"25-step history agrees on {int(keep.sum())} entries; bitwise repeat ok")
        check_stops_at_done(f"portable MINRES {label}", counter.calls, int(pin.iterations))

    # (d) an indefinite solve in both storages: shift between the Ritz extremes
    sym, full = load_symbell(MATRICES[1], dev), load_bell(MATRICES[1], dev)
    shift, lo, hi = ritz_shift(sym, 0.01)
    be = torch.arange(1, sym.n + 1, dtype=torch.float32, device=dev)
    tt = MINRES_INDEF_TOL_REL * float(be.double().norm())
    for label, a in (("symmetric", sym), ("full", full)):
        x, info = minres_solve(a, be, tol=tt, shift=shift, maxiter=4 * a.n)
        k = int(info.iterations)
        h = info.rnorm_history.double().cpu().numpy()[: k + 1]
        true_r = float((be - (a.matvec(x) - shift * x)).double().norm())
        check(bool(info.converged), f"indefinite MINRES {label}: not converged in {k}")
        check(bool(np.all(np.diff(h) <= 0)), f"indefinite MINRES {label}: the history increases")
        check(abs(float(info.rnorm_true) - true_r) <= 1e-3 * true_r
              and true_r <= MINRES_TRUE_FACTOR * max(float(info.rnorm), tt),
              f"indefinite MINRES {label}: rnorm_true {float(info.rnorm_true)}, ||b - (A - sI)x|| "
              f"{true_r}, estimate {float(info.rnorm)}")
        print(f"  indefinite MINRES elasticity3d_16 {label}, shift {shift:.4f} (Ritz extremes "
              f"{lo:.4f}, {hi:.4f}): {k} its to {MINRES_INDEF_TOL_REL:g} ||b||, history "
              f"non-increasing, rnorm_true / rnorm = {float(info.rnorm_true) / float(info.rnorm):.2f} "
              f"(at most {MINRES_TRUE_FACTOR:g})")

    # (e) caps of 1, 2 and 7 steps: the pending update is flushed
    bb = torch.arange(1, p3d.n + 1, dtype=torch.float32, device=dev) / p3d.n
    for a, label in ((p3d, "symmetric"), (p3d_full, "full")):
        for cap in (1, 2, 7):
            xf, fi = fused_minres_solve(a, bb, tol=0.0, maxiter=cap)
            xp, _ = minres_solve(a, bb, tol=0.0, maxiter=cap, fused="never")
            e, m = rel_max_err(xf, xp)
            check(int(fi.iterations) == cap and e <= 1e-4 * m,
                  f"MINRES cap {cap} {label}: {int(fi.iterations)} steps, x differs by {e} (max {m})")
    print("  fused MINRES capped at 1, 2, 7 steps (both storages): x equals the portable "
          "loop's to 1e-4 of max|x|")
    # (f) b = 0, and an x0 warm start (r0 through kernel 5 on full storage)
    x, info = minres_solve(p3d, torch.zeros_like(bb), tol=1e-30)
    check(int(info.iterations) == 0 and bool(info.converged) and not bool(x.any()),
          f"MINRES b = 0: {int(info.iterations)} iterations")
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(p3d_full.n),
                         dtype=torch.float32, device=dev)
    bb = torch.arange(1, p3d_full.n + 1, dtype=torch.float32, device=dev)
    before = _common.LAUNCHES["bell_spmv"]
    x, info = minres_solve(p3d_full, bb, x0, tol=tol)
    r0 = (bb.cpu() - p3d_full.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rnorm_history[0]) / float(r0.norm()) - 1)
    true_rel = float((bb - p3d_full.matvec(x)).double().norm()) / float(bb.double().norm())
    check(_common.LAUNCHES["bell_spmv"] >= before + 2, "MINRES x0 warm start did not launch kernel 5")
    check(bool(info.converged) and e0 <= TOL_DOT and true_rel < 1e-3,
          f"MINRES x0 warm start: converged {bool(info.converged)}, ||r0|| off by {e0}, true "
          f"relative residual {true_rel}")
    print(f"  MINRES b = 0: 0 its; x0 warm start poisson3d_48 full: {int(info.iterations)} its, "
          f"||r0|| rel diff {e0:.3g}, true relative residual {true_rel:.3e}")
    torch.cuda.synchronize()


F32_EPS = float(np.finfo(np.float32).eps)


def residual_norm(host, x) -> float:
    """||b - A x|| in float64 on the host, b = 1..n as the tester's."""
    data, indices, indptr, shape = host
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    ax = np.bincount(rows, weights=data * x[indices], minlength=shape[0])
    return float(np.linalg.norm(np.arange(1, shape[0] + 1) - ax))


def rel_error(host, x) -> float:
    return residual_norm(host, x) ** 2 / float(x @ x)


def bicg_tester_rerun(path, layout, precond, tol, device):
    """The tester's float32 BiCGStab solve (b = 1..n, its default 128 x 128
    tiles) run again through bicgstab_solve on ``device``: the history as
    the tester prints it (norms through their float32 squares; None for
    NaN) and x as float64 on the host."""
    import torch

    from conjugategradient_tpu_torch import bicgstab_solve, jacobi_preconditioner, load_matrix

    a = load_matrix(os.path.join(ROOT, path), layout=layout, dtype=np.float32, bm=128, bn=128,
                    device=device)
    b = torch.arange(1, a.shape[0] + 1, dtype=torch.float32, device=device)
    m = jacobi_preconditioner(a) if precond == "jacobi" else None
    x, info = bicgstab_solve(a, b, tol=tol, M=m)
    k = int(info.iterations)
    sq = np.sqrt((info.rnorm_history * info.rnorm_history).double().cpu().numpy()[:k + 1])
    return [float(h) if np.isfinite(h) else None for h in sq], x.double().cpu().numpy()


def bicg_gap_sweep(host, tol, seeds):
    """BiCGStab's float32 residual gap on the host: the system with its
    unknowns renumbered ``seeds`` ways (every dot and row sum then rounds
    another way), each solved without and with Jacobi.  Returns the gap
    ||b - Ax|| / (eps max_k ||r_k||) and max_k ||r_k|| / ||b|| of every
    converged solve, and the count of those that broke down."""
    import torch

    from conjugategradient_tpu_torch import CSRMatrix, bicgstab_solve, jacobi_preconditioner

    data, indices, indptr, shape = host
    n = shape[0]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    b0 = np.arange(1, n + 1, dtype=np.float64)
    ks, peaks, broke = [], [], 0
    for seed in range(seeds):
        perm = np.random.default_rng(seed).permutation(n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        a = CSRMatrix.from_coo(inv[rows], inv[indices], data, shape, dtype=torch.float32,
                               device="cpu")
        b = torch.from_numpy(b0[perm].astype(np.float32))
        for m in (None, jacobi_preconditioner(a)):
            x, info = bicgstab_solve(a, b, tol=tol, M=m)
            if not bool(info.converged):  # a breakdown: no converged x to read
                broke += 1
                continue
            peak = float(info.rnorm_history[:int(info.iterations) + 1].max())
            ks.append(residual_norm(host, x.double().numpy()[inv]) / (F32_EPS * peak))
            peaks.append(peak / float(np.linalg.norm(b0)))
    return ks, peaks, broke


def phase_bicgstab_path(dev, bic_ops, card):
    """The BiCGStab path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (bicgstab_solve, fused_bicgstab_solve,
                                             jacobi_preconditioner)
    from conjugategradient_tpu_torch.io import loader
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.solver import bicgstab as bicgstab_mod
    from conjugategradient_tpu_torch.solver.fused_bicgstab import (fused_bicgstab_init,
                                                                   fused_bicgstab_step)
    from conjugategradient_tpu_torch.types import BlockedEllMatrix, DIAMatrix
    from conjugategradient_tpu_torch.utils import Timer

    # (a) the tester with --method bicgstab on the general convdiff_34.mtx;
    # each float32 line is run again through bicgstab_solve on the card (the
    # same history, and x for the true residual) and on the host (where the
    # two trajectories part)
    path, nb = CONVDIFF, bnorm(1156)
    tol = TOL_SOLVE_REL * nb
    host = loader.read_csr_host(os.path.join(ROOT, path))  # float64 CSR
    ks, peaks, broke = bicg_gap_sweep(host, tol, GAP_SEEDS)
    check(len(ks) >= GAP_SEEDS and max(ks) <= GAP_ULPS, f"BiCGStab float32 on the host: ||b - Ax|| up to {max(ks):.1f} "
          f"eps max_k ||r_k||, above GAP_ULPS = {GAP_ULPS}")
    print(f"  BiCGStab float32 residual gap on the host, convdiff_34 renumbered {GAP_SEEDS} ways "
          f"x (none, jacobi), {broke} breakdowns: ||b - Ax|| = {min(ks):.1f}-{max(ks):.1f} eps "
          f"max_k ||r_k|| (GAP_ULPS {GAP_ULPS}), max_k ||r_k|| = {min(peaks):.3g}-{max(peaks):.3g} "
          f"||b||")
    bicg = ("--method", "bicgstab")
    for layout, precond, kernel in (("bell", "none", "bell_spmv"), ("dia", "jacobi", "dia_spmv"),
                                    ("auto", "none", "dia_spmv")):
        before = _common.LAUNCHES[kernel]
        dim, nnz, ms, rel, summ, lines = run_tester(path, layout, precond, tol,
                                                    extra=bicg + ("--history",))
        it = summ["iterations"][0]
        printed = json.loads(lines[2])["residual_norms"]
        launched = _common.LAUNCHES[kernel] - before
        what = f"tester {path} --method bicgstab --layout {layout} --precond {precond}"
        hist, x = bicg_tester_rerun(path, layout, precond, tol, dev)
        check(hist == printed, f"{what}: bicgstab_solve on the same inputs gave another history")
        hist_host, x_host = bicg_tester_rerun(path, layout, precond, tol, "cpu")
        peak, true_r = max(h for h in hist if h is not None), residual_norm(host, x)
        gap = true_r / (F32_EPS * peak)
        bound_ = max(REL_ERROR_BOUND, ((tol + GAP_ULPS * F32_EPS * peak) / np.linalg.norm(x)) ** 2)
        check(summ["converged"][0] and math.isfinite(rel) and rel < bound_,
              f"{what}: converged {summ['converged'][0]} in {it}, rel_error {rel} >= {bound_:.3g}")
        check(gap <= GAP_ULPS, f"{what}: ||b - Ax|| = {gap:.1f} eps max_k ||r_k||")
        check(launched >= 2 * 2 * it, f"{what}: {launched} {kernel} launches for 2 solves of {it}")
        peak_host = max(h for h in hist_host if h is not None)
        part = next((k for k, (c, h) in enumerate(zip(hist, hist_host))
                     if c is None or h is None or abs(c - h) > 1e-3 * h), None)
        print(f"  {what}: dim {dim} nnz {nnz} {ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} ms/it), "
              f"rel_error {rel:.3e} (bound {bound_:.3g}), largest ||r_k|| {peak / nb:.3g} ||b|| at "
              f"step {hist.index(peak)}, ||b - Ax|| {true_r / nb:.3g} ||b|| = {gap:.1f} eps "
              f"max_k ||r_k||; on the host {len(hist_host) - 1} its, largest ||r_k|| "
              f"{peak_host / nb:.3g} ||b||, rel_error {rel_error(host, x_host):.3e}; the card's "
              f"history parts from the host's by 1e-3 at step {part}  [{card}]")
    runs = [run_tester(path, "csr", "none", 1e-8 * nb, dtype="float64", extra=bicg + ("--history",))
            for _ in range(2)]
    check(runs[0][4]["converged"][0] and runs[0][3] < REL_ERROR_BOUND,
          f"tester --method bicgstab csr f64: rel_error {runs[0][3]}")
    check(runs[0][5][0].split()[3] == runs[1][5][0].split()[3] and runs[0][5][2] == runs[1][5][2],
          "tester --method bicgstab csr f64: the two runs differ")
    print(f"  tester {path} --method bicgstab --layout csr --dtype float64 twice: "
          f"{runs[0][4]['iterations'][0]} its, {runs[0][2]:.3f} ms, rel_error {runs[0][3]:.3e}, "
          f"history bitwise repeat ok  [{card}]")

    # (b) fused="always" on bench.py:1367's operator, b = arange(1, n+1)/n:
    # diagonally dominant (kappa ~ 1.015), so a few steps
    a = bic_ops["bench_bell"]
    n = a.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    bn_ = float(b.double().norm())
    for tol in (TOL_SOLVE_REL * bn_, 0.0):
        before = _common.LAUNCHES["bicgstab_dir_spmv_dot"]
        xf, fi = bicgstab_solve(a, b, tol=tol, maxiter=64, fused="always")
        launched = _common.LAUNCHES["bicgstab_dir_spmv_dot"] - before
        xp, pi = bicgstab_solve(a, b, tol=tol, maxiter=64)
        true_r = float((b - a.matvec(xf)).double().norm())
        k = int(fi.iterations)
        check(launched >= k and torch.isfinite(xf).all(), f"fused BiCGStab tol={tol}: {launched} launches, x finite "
              f"{bool(torch.isfinite(xf).all())}")
        check(k <= BICG_BENCH_MAX_K and true_r <= TOL_SOLVE_REL * bn_
              and abs(float(fi.rnorm_true) - true_r) <= 1e-3 * true_r + 1e-7 * bn_,
              f"fused BiCGStab tol={tol}: {k} its, ||b - Ax|| {true_r}, rnorm_true {float(fi.rnorm_true)}")
        check(bool(fi.converged) == bool(pi.converged) and bool(fi.breakdown) == bool(pi.breakdown),
              f"fused BiCGStab tol={tol}: converged/breakdown {bool(fi.converged)}/{bool(fi.breakdown)}, "
              f"portable {bool(pi.converged)}/{bool(pi.breakdown)}")
        e, m = rel_max_err(xf, xp)
        check(e <= 1e-4 * m, f"fused BiCGStab tol={tol}: x differs from the portable loop's by {e}")
        print(f"  fused BiCGStab bicgstab-bell n={n}, tol {tol:.3g}: {k} its (portable "
              f"{int(pi.iterations)}), converged {bool(fi.converged)}, breakdown {bool(fi.breakdown)} "
              f"as the portable loop; history {[float(h) for h in fi.rnorm_history[:k + 1]]}; "
              f"rnorm_true {float(fi.rnorm_true):.4g} = ||b - Ax||")

    # (c) the steady-state timing: bench.py's bicgstab-bell lane times 128
    # steps that its operator does not have (it ends in ~4), so the timed
    # operator is bench.py:1113's convection-diffusion at n = 262,144 (nx =
    # 512) as full blocked-ELL 128 x 128.  Its right-hand side is a seeded
    # standard normal: with b = arange(1, n+1)/n (or ones) the shadow
    # residual decorrelates and rho = r^.r comes out exactly 0 in float32 after
    # 90-202 steps, a Lanczos breakdown, while with this b every one of the
    # 256 steps at tol = 0 stays live (checked below)
    cd = bic_ops["convdiff"]
    n = cd.n
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=torch.float32,
                        device=dev)
    eff = 2 * cd.tile_bytes() + 17 * n * 4
    fused_bicgstab_solve(cd, b, tol=0.0, maxiter=8)
    t = Timer(dev).start_measure()
    state = fused_bicgstab_init(cd, b, None, BICG_STEPS)
    for _ in range(BICG_STEPS):
        fused_bicgstab_step(cd, state)
    t.stop_measure()
    k = int(state.k)
    check(k == BICG_STEPS and not bool(state.done),
          f"fused BiCGStab convdiff: {k} of {BICG_STEPS} steps live, done {bool(state.done)}")
    ms_it = t.get_duration() / BICG_STEPS
    t = Timer(dev).start_measure()
    _, info = fused_bicgstab_solve(cd, b, tol=0.0, maxiter=BICG_STEPS)
    t.stop_measure()
    solve_ms = t.get_duration()
    check(int(info.iterations) == BICG_STEPS and not bool(info.breakdown)
          and bool(torch.isfinite(info.rnorm_history).all()),
          f"fused BiCGStab convdiff solve: {int(info.iterations)} its, breakdown {bool(info.breakdown)}")
    check(torch.equal(info.rnorm_history.view(torch.int32), state.hist.view(torch.int32)),
          "fused BiCGStab convdiff: stepping and solving gave different history bits")
    run64 = lambda: fused_bicgstab_solve(cd, b, tol=0.0, maxiter=64)
    t = Timer(dev).start_measure()
    run64()
    t.stop_measure()
    busy = device_ms(run64, reps=1)
    busy_s = "not measured" if busy is None else \
        f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
    prof = kernel_profile(lambda: fused_bicgstab_solve(cd, b, tol=0.0, maxiter=32), top=12)
    per_kernel = "not measured"
    if prof is not None:
        got = {}
        for key, ms, count in prof[2]:
            for short, tag in (("K18", "bicg_dir_kernel"), ("K19", "bicg_s_kernel"),
                               ("K20", "bicg_update_kernel")):
                if tag in key:
                    got[short] = ms / 32
        per_kernel = ", ".join(f"{k_} {v_:.5f}" for k_, v_ in sorted(got.items())) + " ms/it"
    bicgstab_solve(cd, b, tol=0.0, maxiter=8)
    with count_steps(bicgstab_mod, "bicgstab_step") as counter:
        t = Timer(dev).start_measure()
        _, pinfo = bicgstab_solve(cd, b, tol=0.0, maxiter=BICG_STEPS)
        t.stop_measure()
    check(int(pinfo.iterations) == BICG_STEPS and counter.calls == BICG_STEPS,
          f"portable BiCGStab convdiff: {int(pinfo.iterations)} its in {counter.calls} steps")
    port_ms_it = t.get_duration() / BICG_STEPS
    print(f"  fused BiCGStab convdiff nx=512 (n={n}, 128x128, kmax 5, {cd.tile_bytes() / 1e6:.1f} MB "
          f"of tiles): {k} steps all live, {ms_it:.5f} ms/it (init + {BICG_STEPS} steps; whole solve "
          f"{solve_ms:.3f} ms), effective {eff / ms_it / 1e6:.1f} GB/s on {eff / 1e6:.1f} MB/it "
          f"(2 tile streams + 17 vectors); 64 steps: device busy {busy_s}; kernels' device time "
          f"{per_kernel}; bitwise step/solve ok; portable loop {port_ms_it:.5f} ms/it "
          f"({port_ms_it / ms_it:.1f}x the fused)  [{card}]")

    # (d) the portable loop on bench.py:1141's DIA lane (n = 4,194,304)
    dia = DIAMatrix.from_csr_host(*convdiff_csr(2048), device=dev)
    bd = torch.arange(1, dia.n + 1, dtype=torch.float32, device=dev) / dia.n
    bicgstab_solve(dia, bd, tol=0.0, maxiter=4)
    before = _common.LAUNCHES["dia_spmv"]
    t = Timer(dev).start_measure()
    _, dinfo = bicgstab_solve(dia, bd, tol=0.0, maxiter=BICG_DIA_STEPS)
    t.stop_measure()
    check(int(dinfo.iterations) == BICG_DIA_STEPS and _common.LAUNCHES["dia_spmv"] - before
          >= 2 * BICG_DIA_STEPS, f"portable BiCGStab DIA: {int(dinfo.iterations)} its")
    print(f"  portable BiCGStab DIA convdiff nx=2048 (n={dia.n}, {len(dia.offsets)} diagonals): "
          f"{BICG_DIA_STEPS} steps, {t.get_duration() / BICG_DIA_STEPS:.5f} ms/it  [{card}]")
    del dia, bd

    # (e) fused against the portable loop, and twice against itself
    small = convdiff_bell(64, dev)
    bs = torch.arange(1, small.n + 1, dtype=torch.float32, device=dev) / small.n
    for label, op, rhs, M in (("convdiff nx=512", cd, b, None),
                              ("convdiff nx=512 jacobi", cd, b, jacobi_preconditioner(cd)),
                              ("convdiff nx=64", small, bs, None)):
        _, f25 = bicgstab_solve(op, rhs, tol=0.0, maxiter=25, M=M, fused="always")
        _, p25 = bicgstab_solve(op, rhs, tol=0.0, maxiter=25, M=M)
        _, f25b = bicgstab_solve(op, rhs, tol=0.0, maxiter=25, M=M, fused="always")
        hf, hp = f25.rnorm_history.double().cpu().numpy(), p25.rnorm_history.double().cpu().numpy()
        check(np.allclose(hf[:11], hp[:11], rtol=BICG_TRAJ_RTOL, atol=0)
              and np.allclose(hf[11:16], hp[11:16], rtol=BICG_TRAJ_MID_RTOL, atol=0)
              and np.isfinite(hf).all() and np.isfinite(hp).all(),
              f"BiCGStab {label}: fused vs portable history {hf.tolist()} vs {hp.tolist()}")
        check(torch.equal(f25.rnorm_history.view(torch.int32), f25b.rnorm_history.view(torch.int32)),
              f"BiCGStab {label}: fused history not bitwise repeatable")
        print(f"  BiCGStab {label}: fused vs portable 25-step history within {BICG_TRAJ_RTOL:g} over "
              f"10 steps, {BICG_TRAJ_MID_RTOL:g} to step 15 (largest difference there "
              f"{np.abs(hf[:16] / hp[:16] - 1).max():.2g}, to step 25 "
              f"{np.abs(hf / hp - 1).max():.2g}), finite after; bitwise repeat ok")

    # (f) a breakdown: the skew matrix [[0, 1], [-1, 0]] as blocked-ELL
    skew = BlockedEllMatrix.from_csr_host(np.array([1.0, -1.0], np.float32), np.array([1, 0]),
                                          np.array([0, 1, 2]), (2, 2), bm=32, bn=32, device=dev)
    b2 = torch.tensor([1.0, 0.0], device=dev)
    xf, fi = bicgstab_solve(skew, b2, tol=1e-12, maxiter=10, fused="always")
    xp, pi = bicgstab_solve(skew, b2, tol=1e-12, maxiter=10)
    check(bool(fi.breakdown) and bool(pi.breakdown) and not bool(fi.converged)
          and int(fi.iterations) == int(pi.iterations) == 1 and torch.equal(xf, xp)
          and bool(torch.isfinite(xf).all()),
          f"BiCGStab skew breakdown: fused {bool(fi.breakdown)} {int(fi.iterations)} {xf.tolist()}, "
          f"portable {bool(pi.breakdown)} {int(pi.iterations)} {xp.tolist()}")
    print(f"  BiCGStab skew breakdown: 1 step, breakdown flagged, the last finite iterate "
          f"{xf.tolist()} returned (as the portable loop)")

    # (g) the half-step exit: the first step whose ||s|| undercuts every
    # norm before it, with tol just above it
    st = fused_bicgstab_init(small, bs, None, 40)
    seen, j = [float(st.rnorm)], None
    for step in range(1, 41):
        fused_bicgstab_step(small, st)
        snorm = float(torch.sqrt(st.work.scal[fb.B_SS]))
        if snorm < 0.999 * min(seen) and float(st.rnorm) < snorm:
            j = step
            break
        seen += [snorm, float(st.rnorm)]
    check(j is not None, "BiCGStab half-step exit: no step to exit at")
    tol = snorm * (1 + 1e-6)
    _, hf_ = bicgstab_solve(small, bs, tol=tol, maxiter=40, fused="always")
    _, hp_ = bicgstab_solve(small, bs, tol=tol, maxiter=40)
    check(int(hf_.iterations) == j and bool(hf_.converged) and abs(float(hf_.rnorm) - snorm)
          <= 1e-5 * snorm and int(hp_.iterations) == j,
          f"BiCGStab half-step exit at {j}: fused {int(hf_.iterations)} its rnorm {float(hf_.rnorm)}, "
          f"portable {int(hp_.iterations)}, ||s|| {snorm}")
    print(f"  BiCGStab half-step exit: step {j} ends at its half step (rnorm = ||s|| = {snorm:.5g}), "
          f"fused and portable")

    # (h) caps of 1, 2 and 7 steps; b = 0; an x0 warm start (r0 through kernel 5)
    for cap in (1, 2, 7):
        xf, fi = bicgstab_solve(small, bs, tol=0.0, maxiter=cap, fused="always")
        xp, _ = bicgstab_solve(small, bs, tol=0.0, maxiter=cap)
        e, m = rel_max_err(xf, xp)
        check(int(fi.iterations) == cap and e <= 1e-4 * m,
              f"BiCGStab cap {cap}: {int(fi.iterations)} steps, x differs by {e} (max {m})")
    x, info = bicgstab_solve(small, torch.zeros_like(bs), tol=1e-30, fused="always")
    check(int(info.iterations) == 0 and bool(info.converged) and not bool(x.any()),
          f"BiCGStab b = 0: {int(info.iterations)} iterations")
    x0 = torch.as_tensor(0.01 * np.random.default_rng(5).standard_normal(small.n),
                         dtype=torch.float32, device=dev)
    before = _common.LAUNCHES["bell_spmv"]
    tw = TOL_SOLVE_REL * float(bs.double().norm())
    x, info = bicgstab_solve(small, bs, x0, tol=tw, maxiter=400, fused="always")
    r0 = (bs.cpu() - small.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rnorm_history[0]) / float(r0.norm()) - 1)
    true_rel = float((bs - small.matvec(x)).double().norm()) / float(bs.double().norm())
    check(_common.LAUNCHES["bell_spmv"] >= before + 2, "BiCGStab x0 warm start did not launch kernel 5")
    check(bool(info.converged) and e0 <= TOL_DOT and true_rel < 1e-3,
          f"BiCGStab x0 warm start: converged {bool(info.converged)}, ||r0|| off by {e0}, true "
          f"relative residual {true_rel}")
    print(f"  BiCGStab caps 1, 2, 7: x equals the portable loop's to 1e-4 of max|x|; b = 0: 0 its; "
          f"x0 warm start: {int(info.iterations)} its, ||r0|| rel diff {e0:.3g}, true relative "
          f"residual {true_rel:.3e}")

    # (i) the portable loop ends at convergence
    with count_steps(bicgstab_mod, "bicgstab_step") as counter:
        _, pin = bicgstab_solve(small, bs, tol=tw, maxiter=400)
    check(bool(pin.converged), "portable BiCGStab convdiff nx=64: not converged")
    check_stops_at_done("portable BiCGStab convdiff nx=64", counter.calls, int(pin.iterations))
    torch.cuda.synchronize()


def fused_cg_only(dev, card) -> None:
    """The fused CG loops alone (``--fused-cg-only``): ms/it over 256 steps
    and a hash of each history, for comparing two trees on one card."""
    import torch

    from conjugategradient_tpu_torch import StencilOperator, fused_bell_cg_solve, fused_stencil_cg_solve
    from conjugategradient_tpu_torch.utils import Timer

    big_full, big = block_tridiag_ops(N_BIG, 128, dev)
    b = torch.arange(1, N_BIG + 1, dtype=torch.float32, device=dev)
    op = StencilOperator.poisson(STENCIL_GRID, device=dev)
    bs = stencil_rhs(op.shape[0], dev, scale=op.shape[0])
    for label, solve, a, rhs in (("n=262144 symmetric", fused_bell_cg_solve, big, b),
                                 ("n=262144 full", fused_bell_cg_solve, big_full, b),
                                 ("stencil 256^3", fused_stencil_cg_solve, op, bs)):
        solve(a, rhs, tol=-1.0, maxiter=32)
        best = float("inf")
        for _ in range(3):
            t = Timer(dev).start_measure()
            _, info = solve(a, rhs, tol=-1.0, maxiter=256)
            t.stop_measure()
            best = min(best, t.get_duration() / 256)
        digest = hashlib.sha256(info.rho_history.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"  fused CG {label}: {best:.5f} ms/it (best of 3 runs of 256 steps), "
              f"rho_history sha256 {digest}  [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from conjugategradient_tpu_torch.ops.cuda import _build
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    dev = torch.device(DEVICE)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"phase 1: built {os.path.relpath(str(lib), ROOT)} in {time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] == ["--fused-cg-only"]:
        fused_cg_only(dev, card)
        return 0

    print("phase 2: kernels vs plain versions")
    big_full, big = block_tridiag_ops(N_BIG, 128, dev)
    errs, times, extra, ops = phase_kernels(dev, big, big_full)
    dia_ops = phase_dia_kernels(dev, errs, times, extra)
    phase_stencil_kernels(dev, errs, times, extra)
    phase_minres_kernels(dev, big, big_full, ops, errs, times, extra)
    bic_ops = phase_bicgstab_kernels(dev, errs, times, extra)
    for name, t in list(times.items()) + list(extra.items()):
        more = ""
        if "bound_ms" in t:
            more = f"; bound {t['bound_ms']:.5f} ({t['bound_by']})"
        if t.get("library_ms") is not None:
            lib = "conv3d" if name.startswith("stencil7") else "cuSPARSE"
            more += f"; {lib} {t['library_ms']:.5f}"
        print(f"  time {name:<28} kernel {fmt_ms(t['device_ms'])} device / "
              f"{t['event_ms']:.5f} per call; plain {fmt_ms(t['plain_device_ms'])} "
              f"device / {t['plain_event_ms']:.5f} per call{more} (ms)  [{card}]")

    # phase 3: each path with the counters set to 0 just before it and read
    # just after; a kernel's launches are those of its own path
    launches = {}
    for label, kernels, run in (
        ("blocked-ELL", BLOCKED_KERNELS,
         lambda: phase_main_path(dev, big, big_full, ops, card)),
        ("DIA / SELL", DIA_KERNELS, lambda: phase_dia_path(dev, dia_ops, card)),
        ("stencil", STENCIL_KERNELS, lambda: phase_stencil_path(dev, card)),
        ("MINRES", MINRES_KERNELS, lambda: phase_minres_path(dev, big, big_full, ops, card)),
        ("BiCGStab", BICGSTAB_KERNELS, lambda: phase_bicgstab_path(dev, bic_ops, card)),
    ):
        print(f"phase 3: main path, {label}")
        fc.reset_counts()
        run()
        counts, plain_on_cuda = dict(fc.LAUNCHES), dict(fc.PLAIN_ON_CUDA)
        print(f"  {label} path: launches {counts}, plain on CUDA {plain_on_cuda}")
        for name in kernels:
            check(counts[name] > 0, f"kernel {name} never launched on the {label} path")
            launches[name] = launches.get(name, 0) + counts[name]  # summed over its paths
        for name, count in plain_on_cuda.items():
            check(count == 0, f"plain {name} ran on CUDA tensors in the {label} path")

    print(f"phase 4: launches {launches}; {time.perf_counter() - t0:.1f} s since the build began")
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name in fc.LAUNCHES
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
