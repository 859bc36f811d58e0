#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``conjugategradient_tpu_torch``)
on one NVIDIA GPU.

Usage, from the repository root: ``python3 chip_smoke.py``

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``conjugategradient_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel).
2. Hold each of the twenty-three kernels against its plain-torch version on the
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
   ``TAIL_ULPS``.  The row-sharded kernels 6 (``bell_spmv_dot``) and 17
   (``minres_shard_spmv_dot``), on shards 0 and 3 of the n = 262,144
   operator split into 4 (``split_tridiag_tiles``) and at a ragged nrb = 13
   with bn = 32 and 64 at a row offset that is not 0 (kernel 17 also with a
   shift, with su = 0 and with a Jacobi-scaled v): q within TOL_Q, w and x'
   bit-equal (also written over w-2 and x), the dots within TOL_DOT, two
   launches bit-identical; kernels 2, 3 and 16 in the sharded loop's
   partials-only mode bit-equal to their full-tail launches; kernels 6 and
   17 timed on a shard of P = 4 (and P = 8).  Kernels 5 and 4 on the packed
   nonzeros of sparse tiles (``bell_spmv_packed``,
   ``fused_dir_spmv_dot_packed``) on poisson3d_48 (kernel 5 at 128 x 128
   and 8 x 128, kernel 4 at 128 x 128 with and without the Jacobi
   diagonal, beta 0 and not 0) and on its 8 x 8 tiles, a float32 width
   the dense kernels do not take: y and q within TOL_Q of the plain
   versions (built to agree bit for bit, which is printed) and of the
   dense tiles' plain products, p_new bit-equal, pap within TOL_DOT,
   repeats bit-identical; both timed beside the dense kernels on the same
   operator, cuSPARSE and their bound on the bytes the nonzeros need, and
   the one-time pack timed; the two designs against each other on the
   n = 262,144 tiles with entries zeroed down to a fill of 0.05 (the
   crossover).  Kernels 18 and 19 on the packed nonzeros
   (``bicgstab_dir_spmv_dot_packed``, ``bicgstab_s_spmv_dot_packed``) on
   the convection-diffusion operators at nx = 512 and 64 (128 x 128) and
   at nx = 37 with bn = 32 (n not a multiple of 32), with and without the
   Jacobi diagonal, with alpha, beta and omega 0 and with a NaN alpha and
   omega: p', p^, v', s, s^, x_h and t bit-equal to the plain versions,
   the dots within TOL_DOT, the tails within ``TAIL_ULPS``; both timed on
   nx = 512 beside the dense kernels 18 and 19 on the same operator, with
   their bound on the bytes the nonzeros need.  Kernels 14 and 15 on the
   packed nonzeros (``minres_dir_spmv_dot_packed``: one kernel on full
   storage's view or on symmetric storage's view of D + U + U^T) on
   poisson3d_48 at 128 x 128 in both storages and on a ragged 2-D Poisson
   nx = 37 at bn = 32, with and without the Jacobi diagonal, shift 0 and
   not 0, a first step and NaN scalars: v, q, w and x' bit-equal to the
   plain versions, the dots within TOL_DOT, the tail 0 ulps from torch's,
   a launch with live = 0 a no-op; timed on poisson3d_48 beside the dense
   kernel 14 (full) and the dense kernel 15's general landing, with the
   bound on the bytes the storage's nonzeros need.
3. Drive the blocked-ELL path through its entry points, with the launch
   counters reset just before and read just after: the tester on
   ``problems/poisson3d_48.mtx`` and ``problems/elasticity3d_16.mtx`` in
   both blocked layouts (symbell and bell, float32, plain CG and Jacobi
   PCG); fused CG and Jacobi PCG on poisson3d_48 in full storage once on
   the dense-tile route and once on the packed route (iterations,
   rel_error, ms/it, the kernels launched, the two trajectories); the
   n = 262,144 operator in both storages for 256 timed steps, its dense
   tiles held to the dense kernels;
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
   256 timed steps (bench.py's minres protocol, b = arange(1, n+1)/n; the
   dense tiles, no packed launch), the busy share over 64, and the
   portable MINRES loop beside it; poisson3d_48 in both storages on its
   own route (the packed kernel 1) and forced onto the dense tiles:
   ms/it over 256 steps, the busy share over 64, the kernels launched and
   the two routes' 25-step histories; the fused
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
   ends in a few steps (dense tiles: the dense kernels 18 and 19), against
   the portable loop's flags; the steady-state timing on bench.py's
   convection-diffusion operator at nx = 512 (n = 262,144) as full 128 x
   128 blocked-ELL (sparse tiles: the packed kernels 18 and 19), 256 live
   steps at tol = 0, fused and portable, with the busy share and the three
   kernels' device times; the fused solve there on each route
   (``forced_route``), unpreconditioned and with Jacobi: ms/it, the kernels
   launched, and the two routes' 25-step histories;
   the portable loop on bench.py's DIA lane (nx = 2048, n = 4,194,304) for
   64 steps; fused against portable over 25 steps and twice against itself
   (bitwise); the skew breakdown; the half-step exit; caps of 1, 2 and 7;
   b = 0; one x0 warm start.
   Then the sharded path, with its own reset and read: ``sharded_cg_solve``
   on the n = 262,144 operator split into 4 and 8 shards on the card (the
   in-process shard group): the fused CG for 256 steps at each P beside the
   single-card fused CG (ms/it, effective GB/s on the same 413.1 MB/it, the
   busy share over 64 steps and each kernel's device ms/it), the fused
   Jacobi PCG and the fused MINRES at P = 4, the portable sharded CG at P = 4;
   the fused sharded CG against the single-card one over 25 steps and twice
   against itself (bitwise); the float64 portable sharded CG on poisson3d_48
   (``partition_csr_rows``, P = 4) against ``cg_solve`` (equal iterations, x
   to 1e-11); sharded MINRES on indefinite operators against
   ``minres_solve``; caps of 1, 2 and 7; b = 0; one x0 warm start.
   The portable loops end at convergence: the steps launched are counted
   against the iterations for MG-PCG at 256^3, a portable DIA solve, a
   portable BiCGStab solve and a portable sharded CG solve.
4. Check that every kernel launched during its path and that no plain
   version was given a CUDA tensor there; print the kernel table as JSON
   (a kernel's launches summed over the paths that run it).

``python3 chip_smoke.py --fused-cg-only`` runs nothing but the fused CG
loops at n = 262,144 (both storages) and at 256^3 and prints their ms/it
and a hash of each history, then a hash of the fused MINRES's history and
x at n = 262,144 in both storages and of the fused BiCGStab's on the
bicgstab-bell operator (dense tiles all): for comparing two trees on one
card.

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
    "bell_spmv_dot": FUSED_SOURCE,
    "minres_shard_spmv_dot": MINRES_SOURCE,
    "bell_spmv_packed": "conjugategradient_tpu_torch/csrc/bell_spmv.cu",
    "fused_dir_spmv_dot_packed": FUSED_SOURCE,
    "bicgstab_dir_spmv_dot_packed": BICGSTAB_SOURCE,
    "bicgstab_s_spmv_dot_packed": BICGSTAB_SOURCE,
    "minres_dir_spmv_dot_packed": MINRES_SOURCE,
    "sym_minres_dir_spmv_dot_packed": MINRES_SOURCE,
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
    "bell_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:467",
    "minres_shard_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_minres.py:528",
    # the packed kernels compute the same functions as 5, 4, 18, 19, 14 and
    # 15 on sparse tiles (14 and 15: one kernel on either storage's view)
    "bell_spmv_packed": "conjugategradient_tpu/ops/pallas/ell_spmv.py:57",
    "fused_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_cg.py:111",
    "bicgstab_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:84",
    "bicgstab_s_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_bicgstab.py:200",
    "minres_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_minres.py:113",
    "sym_minres_dir_spmv_dot_packed": "conjugategradient_tpu/ops/pallas/fused_minres.py:298",
}
BLOCKED_KERNELS = ("sym_fused_dir_spmv_dot", "fused_dir_spmv_dot", "fused_update_dot",
                   "fused_update_dot_pcg", "bell_spmv", "bell_spmv_packed",
                   "fused_dir_spmv_dot_packed")
DIA_KERNELS = ("dia_spmv", "sym_dia_spmv")
STENCIL_KERNELS = ("stencil7", "fused_stencil_dir_dot", "fused_update_dot")
MINRES_KERNELS = ("minres_dir_spmv_dot", "sym_minres_dir_spmv_dot", "minres_update_dot",
                  "bell_spmv", "bell_spmv_packed", "minres_dir_spmv_dot_packed",
                  "sym_minres_dir_spmv_dot_packed")
BICGSTAB_KERNELS = ("bicgstab_dir_spmv_dot", "bicgstab_s_spmv_dot", "bicgstab_update_dot",
                    "bell_spmv", "dia_spmv", "bell_spmv_packed", "bicgstab_dir_spmv_dot_packed",
                    "bicgstab_s_spmv_dot_packed")
SHARDED_KERNELS = ("bell_spmv_dot", "minres_shard_spmv_dot", "fused_update_dot",
                   "fused_update_dot_pcg", "minres_update_dot", "bell_spmv")
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
PARITY_MIN_USED = 10  # sharded vs one card: entries above the float32 floor
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


def needed_bound(nnz: int, vec_bytes: int) -> float:
    """The least time for a sparse-tile kernel's function on what its
    inputs need: a 4-byte value and a 4-byte int32 column per nonzero, and
    the vectors it reads and writes, each once, over the HBM rate (ms)."""
    return (8 * nnz + vec_bytes) / PEAK_BYTES_PER_S * 1e3


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


def split_tridiag_tiles(n, n_shards, bn=128, seed=0):
    """``problems.block_tridiag_tiles(n)`` split by block-rows into shards:
    (n_shards, nrb / n_shards, 3, bn, bn) tiles and (n_shards, nrb /
    n_shards, 3) GLOBAL column blocks (numpy views, no copy).  The sharded
    path's operator: building the CSR of ~100 M nonzeros to partition it
    would take most of a minute on the host, and the CPU tests hold this
    split equal, as an operator, to ``partition_csr_rows`` on that CSR."""
    from conjugategradient_tpu_torch.problems import block_tridiag_tiles

    blocks, cols, _ = block_tridiag_tiles(n, bn, bn, seed=seed)
    nrb = blocks.shape[0]
    if nrb % n_shards:
        raise ValueError(f"{nrb} block-rows do not split into {n_shards} shards")
    return (blocks.reshape(n_shards, nrb // n_shards, 3, bn, bn),
            cols.reshape(n_shards, nrb // n_shards, 3))


def cut_tridiag_ops(blocks4, cols4, nnz, seed=11):
    """The sharded path's operator with its diagonal tiles cut to
    rho_off * (2.05 + 0.5 u) I, u uniform per row (seeded), rho_off the
    coupling tile's spectral radius: SPD (the couplings add at most
    2 rho_off) with a condition number of at most 91 and a diagonal that
    varies by row, so CG and Jacobi PCG stay above the float32 floor for
    about 20 of 25 steps (the original diagonal, ~1000 times the coupling,
    ends CG in two).  Returns the one-card full-storage matrix, the P = 4
    and P = 8 shard views of the same tiles, and 1/diag."""
    import torch

    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    n_shards, nrb, _, bn, _ = blocks4.shape
    n = n_shards * nrb * bn
    rho_off = float(np.abs(np.linalg.eigvalsh(blocks4[0, 0, 1].double().cpu().numpy())).max())
    d = torch.as_tensor(rho_off * (2.05 + 0.5 * np.random.default_rng(seed).random(n)),
                        dtype=torch.float32, device=blocks4.device)
    cut = blocks4.clone()
    cut[:, :, 0] = torch.diag_embed(d.view(n_shards, nrb, bn))
    full = BlockedEllMatrix(cut.view(-1, 3, bn, bn), cols4.reshape(-1, 3), (n, n), nnz)
    ops = {4: (cut, cols4), 8: (cut.view(8, -1, 3, bn, bn), cols4.view(8, -1, 3))}
    return full, ops, 1.0 / d


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


def load_bell(path, device, bm=128, bn=128):
    from conjugategradient_tpu_torch import load_matrix

    return load_matrix(os.path.join(ROOT, path), layout="bell",
                       dtype=np.float32, bm=bm, bn=bn, device=device)


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


def check_k5_packed(a, rng, errs, label):
    """Packed kernel 5 against its plain version (built to agree bit for
    bit; held to TOL_Q) and against the dense tiles' plain product, a
    repeat bit-identical.  Returns the operand."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb

    pk = a.packed()
    x = torch.as_tensor(rng.standard_normal(pk.ncols), dtype=torch.float32, device=a.device)
    yk = kb.bell_spmv_packed(pk, x)
    yk2 = kb.bell_spmv_packed(pk, x)
    yp = kb.packed_apply(pk, x)
    yd = kb._bell_plain(a.blocks, a.block_cols, x.view(-1, a.bn))
    torch.cuda.synchronize()
    e, m = rel_max_err(yk, yp)
    ed, md = rel_max_err(yk, yd)
    check(e <= TOL_Q * m, f"K5 packed {label}: y err {e} vs max|y| {m}")
    check(ed <= TOL_Q * md, f"K5 packed {label}: y vs the dense tiles err {ed} vs {md}")
    check(torch.equal(yk, yk2), f"K5 packed {label}: a repeat is not bit-identical")
    errs["bell_spmv_packed"] = max(errs["bell_spmv_packed"], e)
    print(f"  K5 packed {label:<31} |dy|={e:.3g} (bit-equal {torch.equal(yk, yp)}), "
          f"vs dense tiles {ed:.3g}; view {pk.nbytes() / 1e6:.2f} MB for {pk.nnz} "
          f"nonzeros ({pk.vals.numel() / max(pk.nnz, 1):.4f} slots each), tiles "
          f"{a.tile_bytes() / 1e6:.1f} MB")
    return x


def check_k4_packed(a, rng, with_d, beta_v, errs, label):
    """Packed kernel 4 against its plain version: p_new bit for bit, q to
    TOL_Q (built to agree bit for bit), pap to TOL_DOT; a repeat
    bit-identical; q against the dense tiles' plain version to TOL_Q."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    pk = a.packed()
    nrb, bn = a.nrb, a.bn

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32,
                               device=a.device)

    r, pold = vec(), vec()
    d = padded_inv_diag(a, nrb * bn).reshape(nrb, bn) if with_d else None
    beta = torch.tensor([[beta_v]], dtype=torch.float32, device=a.device)
    k = fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, d)
    k2 = fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, d)
    pl = fc._packed_dir_plain(pk, r, pold, beta, d, None, None)
    qd = fc._full_dir_plain(a.blocks, a.block_cols, r, pold, beta, d, None, None)[1]
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(k[1], pl[1])
    e_d, _ = rel_max_err(k[1], qd)
    e_pap = abs(float(k[2]) - float(pl[2]))
    check(torch.equal(k[0], pl[0]), f"K4 packed {label}: p_new not bit-equal to the plain version")
    check(e_q <= TOL_Q * m_q, f"K4 packed {label}: q err {e_q} vs max|q| {m_q}")
    check(e_d <= TOL_Q * m_q, f"K4 packed {label}: q vs the dense tiles err {e_d}")
    check(e_pap <= TOL_DOT * abs(float(pl[2])), f"K4 packed {label}: pap {float(k[2])} vs {float(pl[2])}")
    check(all(torch.equal(u, v) for u, v in zip(k, k2)),
          f"K4 packed {label}: a repeat is not bit-identical")
    errs["fused_dir_spmv_dot_packed"] = max(errs["fused_dir_spmv_dot_packed"], e_q, e_pap)
    print(f"  K4 packed {label:<31} p_new bit-equal |dq|={e_q:.3g} (bit-equal "
          f"{torch.equal(k[1], pl[1])}, max|q| {m_q:.4g}) vs dense tiles {e_d:.3g} "
          f"|dpap|={e_pap:.3g}")
    return r, pold, beta, d


def crossover(big_full, rng):
    """Packed against dense kernels 4 and 5 on the n = 262,144
    block-tridiagonal tiles with entries zeroed at random, at falling
    fills: where the packed kernels start to win (CUDA-event ms a launch,
    inputs as one solve step has them)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    dev = big_full.device
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    x = torch.randn(big_full.padded_shape[1], device=dev, generator=gen)
    r, pold = x.view(-1, big_full.bn), torch.randn_like(x).view(-1, big_full.bn)
    beta = torch.full((1, 1), 0.37, device=dev)
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    out = (torch.empty_like(r), torch.empty_like(r))
    rows = []
    for fill in (1.0, 0.5, 0.4, 0.3, 0.25, 0.15, 0.05):
        keep = torch.rand(big_full.blocks.shape, device=dev, generator=gen) < fill
        blocks = torch.where(keep, big_full.blocks, 0.0) if fill < 1 else big_full.blocks
        nnz = int(torch.count_nonzero(blocks))
        a = BlockedEllMatrix(blocks, big_full.block_cols, big_full.shape, nnz)
        pk = a.packed()
        t5d = cuda_ms(lambda: kb.bell_spmv_tiles(a.blocks, a.block_cols, r))
        t5p = cuda_ms(lambda: kb.bell_spmv_packed(pk, x))
        t4d = cuda_ms(lambda: fc.fused_dir_spmv_dot(a.blocks, a.block_cols, r, pold, beta,
                                                    out=out, work=work))
        t4p = cuda_ms(lambda: fc.fused_dir_spmv_dot_packed(pk, r, pold, beta, out=out,
                                                           work=work))
        rows.append((fill, nnz / big_full.blocks.numel(), t5d, t5p, t4d, t4p,
                     bell_packed_route(a)))
        del a, pk, blocks, keep
    torch.cuda.synchronize()
    return rows


# The design the packed view was weighed against: CSR, one warp per row,
# lanes striding over the row's nonzeros.  A yardstick built and timed
# here only; the port does not carry it.
CSR_YARDSTICK = r"""
extern "C" __global__ void csr_warp_row(const int* __restrict__ ptr,
                                        const int* __restrict__ cols,
                                        const float* __restrict__ vals,
                                        const float* __restrict__ x,
                                        float* __restrict__ y, int rows) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int e = ptr[row] + lane; e < ptr[row + 1]; e += 32)
    acc = fmaf(__ldg(vals + e), __ldg(x + __ldg(cols + e)), acc);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) y[row] = acc;
}
extern "C" int csr_warp_row_launch(const int* ptr, const int* cols, const float* vals,
                                   const float* x, float* y, int rows, void* stream) {
  const long long threads = 256, total = (long long)rows * 32;
  csr_warp_row<<<(unsigned)((total + threads - 1) / threads), (unsigned)threads, 0,
                 (cudaStream_t)stream>>>(ptr, cols, vals, x, y, rows);
  return (int)cudaGetLastError();
}
"""


def csr_yardstick(pk, x):
    """The CSR warp-per-row SpMV on the packed view's nonzeros (put in row
    order here), checked against packed kernel 5 to TOL_Q: its device ms a
    launch."""
    import ctypes

    import torch

    from conjugategradient_tpu_torch.ops.cuda import _build
    from conjugategradient_tpu_torch.ops.cuda import bell_spmv as kb

    out = _build.BUILD_DIR / "csr_yardstick.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / "csr_yardstick.cu"
        src.write_text(CSR_YARDSTICK)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).csr_warp_row_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = x.device
    lens = pk.row_len.long()
    ptr = torch.zeros(pk.rows + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.cumsum(0)
    row = torch.repeat_interleave(torch.arange(pk.rows, device=dev), lens)
    k = torch.arange(row.numel(), device=dev) - ptr[row]
    at = pk.chunk_off[row // 32] + 32 * k + row % 32
    vals, cols, ptr32 = pk.vals[at].contiguous(), pk.cols[at].contiguous(), ptr.int()
    y = torch.empty(pk.rows, device=dev)

    def launch():
        return fn(ptr32.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                  pk.rows, torch.cuda.current_stream(dev).cuda_stream)

    check(launch() == 0, "CSR yardstick: launch failed")
    e, m = rel_max_err(y, kb.bell_spmv_packed(pk, x))
    check(e <= TOL_Q * m, f"CSR yardstick: y differs from packed kernel 5 by {e} (max {m})")
    return library_ms(launch)


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
    from conjugategradient_tpu_torch.types.bell import pack_nonzeros

    rng = np.random.default_rng(0)
    errs = dict.fromkeys(SOURCES, 0.0)
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

    # kernels 4 and 5 on the packed nonzeros of sparse tiles: poisson3d_48
    # (both tile shapes of the main path) and a float32 operator of bn = 8,
    # which had no kernel before
    pk_ms = {}
    for label, a in (("poisson3d_48 128x128", p3d_full), ("poisson3d_48 8x128", p3d_8)):
        pk_ms[label] = cuda_ms(lambda: pack_nonzeros(a.blocks, a.block_cols, a.padded_shape[1]),
                               reps=3, warm=1)
    p3d_bn8 = load_bell(MATRICES[0], dev, bm=8, bn=8)
    xk5 = {}
    for label, a in (("poisson3d_48 128x128", p3d_full), ("poisson3d_48 8x128", p3d_8),
                     ("poisson3d_48 8x8", p3d_bn8)):
        xk5[label] = check_k5_packed(a, rng, errs, label)
    before = fc.LAUNCHES["bell_spmv_packed"]
    y8 = p3d_bn8.matvec(xk5["poisson3d_48 8x8"][:p3d_bn8.n])
    check(fc.LAUNCHES["bell_spmv_packed"] == before + 1 and bool(torch.isfinite(y8).all()),
          "bn = 8 float32 operator: matvec did not take the packed kernel")
    for with_d in (False, True):
        for beta_v in (0.0, 0.37):
            tag = f"{'+d' if with_d else ''} beta={beta_v}"
            k4p_args = check_k4_packed(p3d_full, rng, with_d, beta_v, errs,
                                       f"poisson3d_48{tag}")
    check_k4_packed(p3d_bn8, rng, True, 0.37, errs, "poisson3d_48 8x8+d beta=0.37")
    r4, pold4, beta4, d4 = k4p_args
    pk = p3d_full.packed()
    out_p = (torch.empty_like(r4), torch.empty_like(r4))
    vec_b = p3d_full.nrb * 128 * 4
    times["fused_dir_spmv_dot_packed"] = time_pair(
        lambda: fc.fused_dir_spmv_dot_packed(pk, r4, pold4, beta4, out=out_p, work=work),
        lambda: fc._packed_dir_plain(pk, r4, pold4, beta4, None, None, None))
    times["fused_dir_spmv_dot_packed"].update(bound(8 * pk.nnz + 4 * vec_b, 2 * pk.nnz + 4 * p3d_full.n))
    times["fused_dir_spmv_dot_packed"]["library_ms"] = None  # as kernel 4: no one call
    extra["K4 packed poisson3d_48 +d"] = time_pair(
        lambda: fc.fused_dir_spmv_dot_packed(pk, r4, pold4, beta4, d4, out=out_p, work=work),
        lambda: fc._packed_dir_plain(pk, r4, pold4, beta4, d4, None, None))
    extra["K4 packed poisson3d_48 +d"].update(bound(8 * pk.nnz + 5 * vec_b, 2 * pk.nnz + 6 * p3d_full.n))
    for label, a in (("poisson3d_48 128x128", p3d_full), ("poisson3d_48 8x128", p3d_8)):
        pka, x = a.packed(), xk5[label]
        key = "bell_spmv_packed" if a is p3d_full else f"K5 packed {label}"
        table = times if a is p3d_full else extra
        table[key] = time_pair(lambda: kb.bell_spmv_packed(pka, x),
                               lambda: kb.packed_apply(pka, x))
        table[key].update(bound(8 * pka.nnz + 4 * (pka.ncols + a.n), 2 * pka.nnz))
        table[key]["library_ms"] = library_spmv(
            csr_from_bell(a), x[:a.shape[1]], kb.bell_spmv_packed(pka, x)[:a.n], label)
        if a is p3d_full:
            print(f"  CSR, one warp per row, on the same nonzeros: {csr_yardstick(pka, x):.5f} ms "
                  f"a launch; packed (SELL-32) kernel 5 {table[key]['ms']:.5f}  [{card_line()}]")
        print(f"  pack {label}: {pk_ms[label]:.4f} ms once per operator; view "
              f"{pka.nbytes() / 1e6:.3f} MB ({pka.nnz} nonzeros), tiles "
              f"{a.tile_bytes() / 1e6:.1f} MB")
    for fill, got, t5d, t5p, t4d, t4p, route in crossover(big_full, rng):
        print(f"  crossover, n=262144 tiles at fill {fill:.2f} ({got:.4f} of the slots): "
              f"K5 dense {t5d:.5f} packed {t5p:.5f}; K4 dense {t4d:.5f} packed {t4p:.5f} "
              f"(ms, events); the route picks {'packed' if route else 'dense'}  [{card_line()}]")

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
    # the sparse-tile rows' bounds on what these inputs need (the nonzeros
    # and the vectors), beside the tile-stream bounds above
    extra["K4 poisson3d_48"]["needed_ms"] = needed_bound(pk.nnz, 4 * vec_b)
    extra["K1 general poisson3d_48"]["needed_ms"] = needed_bound(
        int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks)),
        4 * vec_b)
    for label, a in (("K5 poisson3d_48 128x128", p3d_full), ("K5 poisson3d_48 8x128", p3d_8)):
        extra[label]["needed_ms"] = needed_bound(a.packed().nnz, 4 * (a.padded_shape[1] + a.n))
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
    return errs, times, extra, {"p3d": p3d, "p3d_full": p3d_full, "p3d_8": p3d_8,
                                "p3d_bn8": p3d_bn8}


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


def minres_dir_pair(a, mirror, row_group=None, packed=False):
    """(name, kernel wrapper, plain version) of MINRES kernel 1 on ``a``:
    kernel 14 on full storage, kernel 15 (with ``mirror``) on symmetric;
    ``packed``: the packed kernel on ``a.packed()`` (either storage)."""
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm
    from conjugategradient_tpu_torch.ops.cuda.bell_spmv import packed_product
    from conjugategradient_tpu_torch.ops.spmv import bell_apply, sym_bell_apply
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    if packed:
        pk = a.packed()
        name = "sym_minres_dir_spmv_dot_packed" if pk.symmetric else "minres_dir_spmv_dot_packed"
        kern = lambda vecs, su, d, **kw: fm.minres_dir_spmv_dot_packed(pk, *vecs, su, d, **kw)
        apply = packed_product(pk)
    elif isinstance(a, BlockedEllMatrix):
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


def same_bits(a, b) -> bool:
    """Equal, NaN where the other is NaN (a NaN's payload aside)."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_minres_dir(a, rng, mirror, with_d, shift, errs, label, first=False, row_group=None,
                     packed=False, nan=False):
    """MINRES kernel 1 against its plain version: v, w_new, x_new bit for
    bit (``packed``: q too, which the packed kernel is built to match), q
    within TOL_Q of max|q|, v.q within TOL_DOT and v.r1 within TOL_DOT of
    ||v|| ||r1|| (a dot of unrelated vectors can cancel); two launches
    bit-identical; the last CTA's scalar step (c1, alpha, alpha/beta)
    within TAIL_ULPS of torch's on the kernel's own dots (``packed``: 0
    ulps).  ``nan``: 1/beta and phi NaN, so every output is NaN exactly
    where the plain version's is."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    name, kern, plain = minres_dir_pair(a, mirror, row_group, packed)
    vecs, su, d = minres_operands(a.nrb, a.bn, rng, a.device, with_d, shift, first)
    if nan:
        su[0, fm.SU_INV_BETA] = su[0, fm.SU_PHI] = float("nan")
    wk = fm.MinresWork.new(a.device, maxiter=4)
    wk.scal[fm.M_OLDB] = 1.7
    wk.start(torch.tensor(2.3, device=a.device))
    wp_scal = wk.scal.clone()
    k = kern(vecs, su, d, work=wk)
    k2 = kern(vecs, su, d)
    p = plain(vecs, su, d)
    torch.cuda.synchronize()
    bitwise = ((0, "v"), (1, "q"), (2, "w_new"), (3, "x_new")) if packed else \
        ((0, "v"), (2, "w_new"), (3, "x_new"))
    for i, what in bitwise:
        check(same_bits(k[i], p[i]), f"{name} {label}: {what} not bit-equal to the plain version")
    check(all(same_bits(x, y) for x, y in zip(k, k2)), f"{name} {label}: two launches differ")
    if nan:
        check(bool(torch.isnan(k[0]).all()) and math.isnan(float(k[4])),
              f"{name} {label}: a NaN 1/beta left finite entries")
        print(f"  {name} {label:<34} v, q, w, x' bit-equal with NaN 1/beta and phi; repeat ok")
        return vecs, su, d
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
    check(ulps <= (0 if packed else TAIL_ULPS), f"{name} {label}: scalar step {ulps} ulps from "
          "torch's")
    errs[name] = max(errs[name], e_q, e_vq, e_vr1)
    print(f"  {name} {label:<34} v, {'q, ' if packed else ''}w, x' bit-equal; |dq|={e_q:.3g} "
          f"(max|q| {m_q:.4g}) |dvq|={e_vq:.3g} |dvr1|={e_vr1:.3g}; repeat ok; scalar step "
          f"{ulps} ulp")
    return vecs, su, d


def check_minres_idle(a, rng, label):
    """The packed kernel 1 on a solve that is no longer live: no output and
    no scalar written."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    name, kern, _ = minres_dir_pair(a, None, packed=True)
    vecs, su, d = minres_operands(a.nrb, a.bn, rng, a.device, True, 0.07)
    wk = fm.MinresWork.new(a.device, maxiter=4)
    wk.start(torch.tensor(2.3, device=a.device))
    wk.ctl[fc.C_LIVE] = 0
    kept = wk.scal.clone()
    out = tuple(torch.full_like(vecs[0], 7.0) for _ in range(4))
    kern(vecs, su, d, out=out, work=wk)
    torch.cuda.synchronize()
    check(all(bool((o == 7.0).all()) for o in out)
          and torch.equal(wk.scal.view(torch.int32), kept.view(torch.int32)),
          f"{name} {label}: a launch with live = 0 wrote something")
    print(f"  {name} {label:<34} live = 0: nothing written")


def poisson2d_ops(nx, bn, dev):
    """The 5-point 2-D Poisson operator on an nx x nx grid as float32 full
    and symmetric blocked-ELL with bn x bn tiles (sparse tiles)."""
    from conjugategradient_tpu_torch.problems import poisson2d_coo
    from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix

    rows, cols, vals, shape = poisson2d_coo(nx)
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=shape[0]))])
    full = BlockedEllMatrix.from_csr_host(vals[order].astype(np.float32), cols[order], indptr,
                                          shape, bm=bn, bn=bn, device=dev)
    return full, SymBellMatrix.from_bell(full)


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
    # the packed kernel, the route of fused MINRES on sparse tiles, on both
    # storages' views: poisson3d_48 at 128 x 128 (the main path) and a
    # ragged 2-D Poisson nx = 37 at bn = 32 (n = 1369); with and without d,
    # shift 0 and not 0, a first step, NaN scalars, live = 0
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

    p3f = ops["p3d_full"]
    dense_full_args = check_minres_dir(p3f, rng, None, False, 0.07, errs,
                                       "poisson3d_48 full (dense route)")
    rag_full, rag_sym = poisson2d_ops(37, 32, dev)
    packed_args = {}
    for a, label in ((p3f, "poisson3d_48 full"), (p3d, "poisson3d_48 sym"),
                     (rag_full, "ragged poisson2d-37 bn=32 full"),
                     (rag_sym, "ragged poisson2d-37 bn=32 sym")):
        check(bell_packed_route(a), f"{label}: the route does not take the packed view")
        for with_d in (False, True):
            for shift in (0.0, 0.07):
                got = check_minres_dir(a, rng, None, with_d, shift, errs,
                                       f"{label}{'+d' if with_d else ''} shift={shift}",
                                       packed=True)
                if not with_d and shift:
                    packed_args[label] = got
        check_minres_dir(a, rng, None, True, 0.07, errs, f"{label}+d first step", first=True,
                         packed=True)
        check_minres_dir(a, rng, None, False, 0.07, errs, f"{label} NaN", packed=True, nan=True)
        check_minres_idle(a, rng, label)
    stored = int(torch.count_nonzero(p3d.diag_blocks)) + int(torch.count_nonzero(p3d.off_blocks))
    check(p3f.packed().nnz == p3d.packed().nnz == int(torch.count_nonzero(p3f.blocks)),
          f"poisson3d_48: views hold {p3f.packed().nnz} and {p3d.packed().nnz} nonzeros")
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
    for key, a, mirror, args, table, packed in (
        ("minres_dir_spmv_dot", big_full, None, full_args, times, False),
        ("sym_minres_dir_spmv_dot", big, "banded", band_args, times, False),
        ("sym_minres_dir_spmv_dot general poisson3d_48", p3d, "scatter", gen_args, extra, False),
        ("minres_dir_spmv_dot poisson3d_48 full", p3f, None, dense_full_args, extra, False),
        ("minres_dir_spmv_dot_packed", p3f, None, packed_args["poisson3d_48 full"], times, True),
        ("sym_minres_dir_spmv_dot_packed", p3d, None, packed_args["poisson3d_48 sym"], times,
         True),
    ):
        _, kern, plain = minres_dir_pair(a, mirror, packed=packed)
        vecs, su, _ = args
        vecs = [t.clone() for t in vecs]
        out = (vecs[2], torch.empty_like(vecs[0]), vecs[4], vecs[5])
        su0 = su.clone()
        su0[0, fm.SU_PHI] = 0.0  # x stays put over the timed launches
        t = time_pair(lambda: kern(vecs, su0, None, out=out, work=work),
                      lambda: plain(vecs, su0, None))
        vb = 10 * a.nrb * a.bn * 4  # r2 r1 v_prev w-1 w-2 x in; v q w x' out
        if packed:
            # the function's own nonzeros: full storage's tiles', or the
            # stored diagonal and upper ones (the view holds the upper
            # ones twice)
            nnz = stored if a.packed().symmetric else a.packed().nnz
            t.update(bound(8 * nnz + vb, 2 * a.packed().nnz + 14 * a.nrb * a.bn),
                     library_ms=None)
            t["needed_ms"] = needed_bound(nnz, vb)
            t["view_ms"] = needed_bound(a.packed().nnz, vb)
        else:
            tiles = nbytes(a.blocks, a.block_cols) if mirror is None else \
                nbytes(a.diag_blocks, a.off_blocks, a.off_cols)
            flops = 2 * a.blocks.numel() if mirror is None else \
                2 * a.diag_blocks.numel() + 4 * a.off_blocks.numel()
            t.update(bound(tiles + vb, flops + 14 * a.nrb * a.bn),
                     library_ms=None)  # an SpMV fused with updates and two dots: no one call
        if a is p3d and not packed:  # sparse tiles: the bound on the stored nonzeros too
            t["needed_ms"] = needed_bound(stored, vb)
        if a is p3f and not packed:
            t["needed_ms"] = needed_bound(p3f.packed().nnz, vb)
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


def convdiff_bell(nx, dev, bn=128):
    from conjugategradient_tpu_torch.types import BlockedEllMatrix

    return BlockedEllMatrix.from_csr_host(*convdiff_csr(nx), bm=bn, bn=bn, device=dev)


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


def bicg_forms(a, packed, row_group=None):
    """Kernels 18 and 19 on ``a`` in one form, the dense tiles or the packed
    nonzeros: (kernel 18, its plain version, kernel 19, its plain version),
    each taking the vector operands of the dense wrappers."""
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    if packed:
        pk = a.packed()
        return (lambda *v, **kw: fb.bicgstab_dir_spmv_dot_packed(pk, *v, **kw),
                lambda *v: fb._packed_dir_plain(pk, *v),
                lambda *v, **kw: fb.bicgstab_s_spmv_dot_packed(pk, *v, **kw),
                lambda *v: fb._packed_s_plain(pk, *v))
    return (lambda *v, **kw: fb.bicgstab_dir_spmv_dot(a.blocks, a.block_cols, *v,
                                                      row_group=row_group, **kw),
            lambda *v: fb._tile_dir_plain(a.blocks, a.block_cols, *v),
            lambda *v, **kw: fb.bicgstab_s_spmv_dot(a.blocks, a.block_cols, *v,
                                                    row_group=row_group, **kw),
            lambda *v: fb._tile_s_plain(a.blocks, a.block_cols, *v))


def check_bicg_tiles(a, rng, with_d, beta_v, omega_v, alpha_v, errs, label, row_group=None,
                     nan=False, packed=False):
    """Kernels 18 and 19 (``packed``: their packed forms) against their
    plain versions: p', p^, s, s^, x_h bit for bit, v' and t within TOL_Q of
    their largest entry (packed: bit for bit, which they are built to be),
    the dots within TOL_DOT of the product of their operands' norms (dots of
    unrelated vectors can cancel), two launches bit-identical, and the last
    CTAs' scalar steps within TAIL_ULPS of torch's on the kernels' own dots.
    ``nan``: r^ = 0 and rho_k = 0 make alpha = 0/0 in kernel 18's tail, and
    r = v' = 0 make omega = 0/0 in kernel 19's: both are clamped to 0, and
    the next kernel's update is an exact no-op."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb

    dev, nrb, bn = a.device, a.nrb, a.bn
    k18, p18, k19, p19 = bicg_forms(a, packed, row_group)
    tag = "K18p/K19p" if packed else "K18/K19"
    suffix = "_packed" if packed else ""

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
    k1 = k18(r, p, v, rhat, beta, omega, d, work=wk)
    k1b = k18(r, p, v, rhat, beta, omega, d)
    p1 = p18(r, p, v, rhat, beta, omega, d, None, None)
    torch.cuda.synchronize()
    check(torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1]),
          f"K18 {label}: p' or p^ not bit-equal to the plain version")
    check(not packed or torch.equal(k1[2], p1[2]),
          f"K18 packed {label}: v' not bit-equal to the plain version")
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
    k2 = k19(r, vn, x, k1[1], alpha, d, work=wk)
    k2b = k19(r, vn, x, k1[1], alpha, d)
    p2 = p19(r, vn, x, k1[1], alpha, d, None, None)
    torch.cuda.synchronize()
    check(all(torch.equal(k2[i], p2[i]) for i in range(3)),
          f"K19 {label}: s, s^ or x_h not bit-equal to the plain version")
    check(not packed or torch.equal(k2[3], p2[3]),
          f"K19 packed {label}: t not bit-equal to the plain version")
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
    for name, e in ((f"bicgstab_dir_spmv_dot{suffix}", max(e_v, e_rv)),
                    (f"bicgstab_s_spmv_dot{suffix}", max(e_t, e_d))):
        errs[name] = max(errs[name], e)
    bits = "p', p^, v', s, s^, x_h, t" if packed else "p', p^, s, s^, x_h"
    print(f"  {tag} {label:<38} {bits} bit-equal; |dv'|={e_v:.3g} (max {m_v:.4g}) "
          f"|dt|={e_t:.3g} (max {m_t:.4g}) |drv|={e_rv:.3g} |ddots|={e_d:.3g}; repeat ok; "
          f"scalar steps {u1}, {u2} ulp{'; NaN alpha and omega clamped, updates no-ops' if nan else ''}")
    return r, p, v, rhat, x, k1, beta, omega, alpha, d


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


def time_bicg_tiles(a, args, work, packed=False, with_d=False) -> tuple:
    """Kernels 18 and 19 (``packed``: their packed forms) timed against
    their plain versions on the operands ``check_bicg_tiles`` returned,
    launched as the solver launches them (outputs made once, ``work``
    live), each with its bound: each input read once, each output written
    once (the dense forms' tiles; the packed forms' 8 bytes a nonzero)."""
    import torch

    r, p, v, rhat, x, k1, beta, omega, alpha, d = args
    d = d if with_d else None
    k18, p18, k19, p19 = bicg_forms(a, packed)
    out1 = tuple(torch.empty_like(r) for _ in range(3))
    out2 = tuple(torch.empty_like(r) for _ in range(4))
    t1 = time_pair(lambda: k18(r, p, v, rhat, beta, omega, d, out=out1, work=work),
                   lambda: p18(r, p, v, rhat, beta, omega, d, None, None))
    t2 = time_pair(lambda: k19(r, k1[2], x, k1[1], alpha, d, out=out2, work=work),
                   lambda: p19(r, k1[2], x, k1[1], alpha, d, None, None))
    n, vb = r.numel(), r.numel() * 4
    nd = int(d is not None)
    if packed:
        nnz = a.packed().nnz
        t1.update(bound(8 * nnz + (7 + nd) * vb, 2 * nnz + 6 * n))
        t2.update(bound(8 * nnz + (8 + nd) * vb, 2 * nnz + 10 * n))
    else:
        tiles = nbytes(a.blocks, a.block_cols)
        t1.update(bound(tiles + (7 + nd) * vb, 2 * a.blocks.numel() + 6 * n))
        t2.update(bound(tiles + (8 + nd) * vb, 2 * a.blocks.numel() + 10 * n))
    for t in (t1, t2):
        # an SpMV fused with updates and dots: no one call
        t["library_ms"] = None
    return t1, t2


def phase_bicgstab_kernels(dev, errs, times, extra):
    """Kernels 18-20 against their plain versions and timed, on bench.py's
    bicgstab-bell operator (n = 262,144, 128 x 128), on the timed main
    path's convection-diffusion operator and at ragged shapes; kernels 18
    and 19 in their packed forms on convection-diffusion operators, timed
    beside the dense forms on nx = 512."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route

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
    cd_args = check_bicg_tiles(cd, rng, False, 0.4, 0.25, 0.6, errs, "convdiff-512 dense")
    cd_args_d = check_bicg_tiles(cd, rng, True, 0.4, 0.25, 0.6, errs, "convdiff-512+d dense")
    # the packed forms, which the main path takes on these sparse tiles: on
    # the same operator, on nx = 64, and on nx = 37 at bn = 32 (n = 1369, not
    # a multiple of 32); with and without d, with the scalars 0, and with a
    # NaN alpha and omega
    cd_packed = {}
    for op, name in ((cd, "convdiff-512 (main path)"), (convdiff_bell(64, dev), "convdiff-64"),
                     (convdiff_bell(37, dev, bn=32), "ragged convdiff-37 bn=32")):
        check(bell_packed_route(op), f"{name}: the route does not take the packed view")
        for with_d in (False, True):
            tag = "+d" if with_d else ""
            got = check_bicg_tiles(op, rng, with_d, 0.4, 0.25, 0.6, errs, f"{name}{tag}",
                                   packed=True)
            if op is cd:
                cd_packed[with_d] = got
            check_bicg_tiles(op, rng, with_d, 0.0, 0.0, 0.0, errs,
                             f"{name}{tag} beta=omega=alpha=0", packed=True)
        check_bicg_tiles(op, rng, True, 0.4, 0.25, 0.6, errs, f"{name} NaN alpha, omega",
                         nan=True, packed=True)
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
    # convdiff-512, both forms side by side (the packed ones are the main
    # path's); sparse tiles: the dense forms' bound on the nonzeros too (7
    # and 8 vectors, 8 and 9 with d, as the packed forms' bound_ms counts)
    extra["K18 convdiff-512"], extra["K19 convdiff-512"] = time_bicg_tiles(cd, cd_args, work)
    extra["K18 convdiff-512 +d"], extra["K19 convdiff-512 +d"] = time_bicg_tiles(
        cd, cd_args_d, work, with_d=True)
    times["bicgstab_dir_spmv_dot_packed"], times["bicgstab_s_spmv_dot_packed"] = \
        time_bicg_tiles(cd, cd_packed[False], work, packed=True)
    extra["K18 packed convdiff-512 +d"], extra["K19 packed convdiff-512 +d"] = time_bicg_tiles(
        cd, cd_packed[True], work, packed=True, with_d=True)
    cd_nnz, vb = cd.packed().nnz, N_BIG * 4
    check(cd_nnz == int(torch.count_nonzero(cd.blocks)), "convdiff-512: the view lost nonzeros")
    for key, nvec in (("K18 convdiff-512", 7), ("K19 convdiff-512", 8),
                      ("K18 convdiff-512 +d", 8), ("K19 convdiff-512 +d", 9)):
        extra[key]["needed_ms"] = needed_bound(cd_nnz, nvec * vb)
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


@contextlib.contextmanager
def forced_route(packed: bool):
    """Send every float32 full blocked-ELL operator (and symmetric one in
    the fused MINRES step) down one route, the packed nonzeros or the dense
    tiles, to compare the two on one operator (the port itself picks by
    tile fill and has no switch for it)."""
    import torch

    from conjugategradient_tpu_torch.ops import spmv
    from conjugategradient_tpu_torch.solver import fused, fused_bicgstab, fused_minres

    users = (spmv, fused, fused_bicgstab, fused_minres)
    saved = spmv.bell_packed_route
    for mod in users:
        mod.bell_packed_route = lambda a: packed and a.dtype == torch.float32
    try:
        yield
    finally:
        for mod in users:
            mod.bell_packed_route = saved


def kernel5_launches() -> int:
    """Launches of kernel 5 in either form (dense tiles or packed)."""
    from conjugategradient_tpu_torch.ops.cuda import _common

    return _common.LAUNCHES["bell_spmv"] + _common.LAUNCHES["bell_spmv_packed"]


ROUTE_KERNELS = ("fused_dir_spmv_dot", "fused_dir_spmv_dot_packed", "bell_spmv",
                 "bell_spmv_packed")


def route_comparison(dev, a, card):
    """Fused CG and Jacobi PCG on poisson3d_48 in full 128 x 128 storage,
    the tester's protocol (b = 1..n, tol 1e-5 ||b||), once on the dense
    route and once on the packed route in this process: iterations,
    rel_error, ms/it, the kernels each launched, and the two 25-step
    trajectories against each other.  Returns {(precond, route): ms/it}."""
    import torch

    from conjugategradient_tpu_torch import accuracy, cg_solve, jacobi_preconditioner
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.utils import Timer

    bb = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(a.n)
    out = {}
    for precond in ("none", "jacobi"):
        M = jacobi_preconditioner(a) if precond == "jacobi" else None
        runs = {}
        for route in ("dense", "packed"):
            with forced_route(route == "packed"):
                cg_solve(a, bb, tol=tt, M=M, maxiter=8)
                before = {k: fc.LAUNCHES[k] for k in ROUTE_KERNELS}
                t = Timer(dev).start_measure()
                x, info = cg_solve(a, bb, tol=tt, M=M)
                t.stop_measure()
                rel = float(accuracy(a, bb, x))
                _, h25 = cg_solve(a, bb, tol=0.0, maxiter=25, M=M)
                used = {k: fc.LAUNCHES[k] - before[k] for k in ROUTE_KERNELS}
            k = int(info.iterations)
            what = f"poisson3d_48 bell 128x128 precond {precond}, {route} route"
            check(bool(info.converged) and rel < REL_ERROR_BOUND,
                  f"{what}: converged {bool(info.converged)}, rel_error {rel}")
            mine = [n for n in ROUTE_KERNELS if n.endswith("_packed") == (route == "packed")]
            check(used[mine[0]] >= k + 25 and used[mine[1]] >= 1
                  and all(used[n] == 0 for n in ROUTE_KERNELS if n not in mine),
                  f"{what}: launches {used}")
            ms_it = t.get_duration() / k
            runs[route] = (k, h25)
            out[(precond, route)] = ms_it
            print(f"  {what}: {k} its, {ms_it:.5f} ms/it, rel_error {rel:.3e}, "
                  f"launches {used}  [{card}]")
        ok, n_used = trajectory_ok(runs["packed"][1].rho_history, runs["dense"][1].rho_history, 25)
        check(ok, f"poisson3d_48 {precond}: packed vs dense rho_history beyond rtol {TRAJ_RTOL}")
        check(abs(runs["packed"][0] - runs["dense"][0]) <= ITER_SLACK,
              f"poisson3d_48 {precond}: iterations packed {runs['packed'][0]} vs dense "
              f"{runs['dense'][0]}")
        print(f"  poisson3d_48 {precond}: the two routes' 25-step trajectories agree on "
              f"{n_used} entries")
    return out


def phase_main_path(dev, big, big_full, ops, card):
    import torch

    from conjugategradient_tpu_torch import (accuracy, cg_solve, fused_bell_cg_solve,
                                             jacobi_preconditioner)
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
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
    # (a') full storage on poisson3d_48: the dense route against the packed
    results["routes"] = route_comparison(dev, ops["p3d_full"], card)

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
    # dense tiles keep the dense kernels: 8 steps and rel_error's SpMV
    before = dict(fc.LAUNCHES)
    xf, _ = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=8)
    accuracy(big_full, b, xf)
    used = {k: fc.LAUNCHES[k] - before[k] for k in ROUTE_KERNELS + ("bell_pack",)}
    check(used == {"fused_dir_spmv_dot": 8, "fused_dir_spmv_dot_packed": 0, "bell_spmv": 1,
                   "bell_spmv_packed": 0, "bell_pack": 0},
          f"n={n} full storage (dense tiles): launches {used}")
    print(f"  fused CG n={n} full storage, dense tiles: the dense kernels ({used})")
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

    # (c) the portable loop on full storage with bm != bn: packed kernel 5
    # once a step (sparse tiles)
    p8 = ops["p3d_8"]
    check((p8.bm, p8.bn) == (8, 128), f"load_matrix default tiles {p8.bm}x{p8.bn}")
    bb = torch.arange(1, p8.n + 1, dtype=torch.float32, device=dev)
    tt = TOL_SOLVE_REL * bnorm(p8.n)
    cg_solve(p8, bb, tol=tt, maxiter=8)
    before = fc.LAUNCHES["bell_spmv_packed"]
    t = Timer(dev).start_measure()
    x, info = cg_solve(p8, bb, tol=tt)
    t.stop_measure()
    k = int(info.iterations)
    launched = fc.LAUNCHES["bell_spmv_packed"] - before
    rel = float(accuracy(p8, bb, x))
    check(bool(info.converged), f"portable bell 8x128: not converged in {k}")
    check(launched >= k + 1, f"portable bell 8x128: {launched} SpMV launches for {k} steps")
    check(rel < REL_ERROR_BOUND, f"portable bell 8x128: rel_error {rel}")
    print(f"  portable loop poisson3d_48 bell 8x128: {k} its, {launched} packed kernel-5 launches, "
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

    # (e) x0 warm start: r0 = b - A x0 through packed kernel 5
    p3f = ops["p3d_full"]
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(p3f.n),
                         dtype=torch.float32, device=dev)
    bb = torch.arange(1, p3f.n + 1, dtype=torch.float32, device=dev)
    before = fc.LAUNCHES["bell_spmv_packed"]
    x, info = fused_bell_cg_solve(p3f, bb, x0, tol=TOL_SOLVE_REL * bnorm(p3f.n))
    r0 = (bb.cpu() - p3f.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rho_history[0]) / float(r0 @ r0) - 1)
    rel = float(accuracy(p3f, bb, x))
    check(fc.LAUNCHES["bell_spmv_packed"] > before, "x0 warm start did not launch packed kernel 5")
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


MINRES_DENSE_K1 = ("minres_dir_spmv_dot", "sym_minres_dir_spmv_dot")
MINRES_PACKED_K1 = ("minres_dir_spmv_dot_packed", "sym_minres_dir_spmv_dot_packed")


def minres_route_comparison(dev, p3d, p3d_full, copy_gbps, card):
    """The fused MINRES on poisson3d_48 in both storages, once on the route
    the port picks (the packed kernel 1) and once forced onto the dense
    tiles (``forced_route``): ms/it over MINRES_STEPS steps at tol = -1
    (bench.py's protocol: the init and the steps), the device's busy share
    over 64 steps, the kernels each launched, and the two routes' 25-step
    histories against each other (``trajectory_ok``)."""
    import torch

    from conjugategradient_tpu_torch import fused_minres_solve
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
    from conjugategradient_tpu_torch.solver.fused_minres import fused_minres_init, fused_minres_step
    from conjugategradient_tpu_torch.utils import Timer

    n = p3d.n
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n
    watched = MINRES_DENSE_K1 + MINRES_PACKED_K1 + ("minres_update_dot",)
    for label, a in (("full", p3d_full), ("symmetric", p3d)):
        check(bell_packed_route(a), f"poisson3d_48 {label}: not on the packed route")
        hist = {}
        for route in ("packed", "dense"):
            what = f"fused MINRES poisson3d_48 {label}, {route} route"
            with (contextlib.nullcontext() if route == "packed" else forced_route(False)):
                fused_minres_solve(a, b, tol=-1.0, maxiter=8)
                before = {k: _common.LAUNCHES[k] for k in watched}
                t = Timer(dev).start_measure()
                state = fused_minres_init(a, b, None, MINRES_STEPS, tol=-1.0)
                for _ in range(MINRES_STEPS):
                    fused_minres_step(a, state)
                t.stop_measure()
                used = {k: _common.LAUNCHES[k] - before[k] for k in watched}
                check(int(state.k) == MINRES_STEPS, f"{what}: {int(state.k)} steps stepped")
                ms_it = t.get_duration() / MINRES_STEPS
                run64 = lambda: fused_minres_solve(a, b, tol=-1.0, maxiter=64)
                t = Timer(dev).start_measure()
                run64()
                t.stop_measure()
                busy = device_ms(run64, reps=1)
                _, h25 = fused_minres_solve(a, b, tol=0.0, maxiter=25)
            mine = [k for k in MINRES_DENSE_K1 + MINRES_PACKED_K1 if used[k]]
            check(len(mine) == 1 and used[mine[0]] == MINRES_STEPS
                  and used["minres_update_dot"] == MINRES_STEPS
                  and mine[0].endswith("_packed") == (route == "packed"),
                  f"{what}: launches {used}")
            hist[route] = h25.rnorm_history
            busy_s = "not measured" if busy is None else \
                f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
            print(f"  {what}: {ms_it:.5f} ms/it over {MINRES_STEPS} steps; 64 steps: device busy "
                  f"{busy_s}; launches {used}  [{card}]")
        ok, n_used = trajectory_ok(hist["packed"], hist["dense"], 25)
        check(ok and n_used >= PARITY_MIN_USED,
              f"fused MINRES poisson3d_48 {label}: packed vs dense history beyond rtol "
              f"{TRAJ_RTOL} ({n_used} entries above the floor)")
        hp, hd = (hist[r][1:26].double().cpu().numpy() for r in ("packed", "dense"))
        print(f"  fused MINRES poisson3d_48 {label}: the two routes' 25-step histories agree on "
              f"{n_used} entries (largest relative difference {np.abs(hp / hd - 1).max():.2g})")
    torch.cuda.synchronize()


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
    # (a) the tester with --method minres, both blocked layouts: sparse
    # tiles, so the packed kernel 1 in both
    for layout, kernel in (("symbell", "sym_minres_dir_spmv_dot_packed"),
                           ("bell", "minres_dir_spmv_dot_packed")):
        for precond in ("none", "jacobi"):
            before = dict(_common.LAUNCHES)
            dim, nnz, ms, rel, summ, _ = run_tester(path, layout, precond, tol, extra=minres)
            it = summ["iterations"][0]
            launched = _common.LAUNCHES[kernel] - before[kernel]
            dense = sum(_common.LAUNCHES[k] - before[k] for k in MINRES_DENSE_K1)
            what = f"tester {path} --method minres --layout {layout} --precond {precond}"
            check(summ["converged"][0], f"{what}: not converged in {it}")
            check(math.isfinite(rel) and rel < REL_ERROR_BOUND, f"{what}: rel_error {rel}")
            check(launched >= 2 * it and dense == 0,
                  f"{what}: {launched} {kernel} launches for 2 solves of {it}, {dense} dense")
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
    before = dict(_common.LAUNCHES)
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
    packed_used = sum(_common.LAUNCHES[k] - before[k] for k in MINRES_PACKED_K1)
    check(packed_used == 0, f"fused MINRES n={n}: the dense tiles took the packed kernel "
          f"{packed_used} times")

    # (b2) poisson3d_48 (sparse tiles) in both storages on its own route,
    # the packed kernel, and forced onto the dense tiles
    minres_route_comparison(dev, p3d, p3d_full, copy_gbps, card)

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
    before = kernel5_launches()
    x, info = minres_solve(p3d_full, bb, x0, tol=tol)
    r0 = (bb.cpu() - p3d_full.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rnorm_history[0]) / float(r0.norm()) - 1)
    true_rel = float((bb - p3d_full.matvec(x)).double().norm()) / float(bb.double().norm())
    check(kernel5_launches() >= before + 2, "MINRES x0 warm start did not launch kernel 5")
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


BICG_ROUTE_KERNELS = ("bicgstab_dir_spmv_dot", "bicgstab_s_spmv_dot",
                      "bicgstab_dir_spmv_dot_packed", "bicgstab_s_spmv_dot_packed")


def bicg_route_comparison(dev, cd, b, card):
    """The fused BiCGStab on convdiff-512 once on the dense route and once
    on the packed route (``forced_route``), unpreconditioned and with
    Jacobi: ms/it over BICG_STEPS steps at tol = 0 (init included), the
    kernels each launched, and the two 25-step histories against each
    other (section (e)'s bounds)."""
    import torch

    from conjugategradient_tpu_torch import fused_bicgstab_solve, jacobi_preconditioner
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.utils import Timer

    for precond in ("none", "jacobi"):
        inv = jacobi_preconditioner(cd).inv_diag if precond == "jacobi" else None
        hist = {}
        for route in ("dense", "packed"):
            what = f"fused BiCGStab convdiff nx=512 precond {precond}, {route} route"
            with forced_route(route == "packed"):
                fused_bicgstab_solve(cd, b, tol=0.0, maxiter=8, inv_diag=inv)
                before = {k: _common.LAUNCHES[k] for k in BICG_ROUTE_KERNELS}
                t = Timer(dev).start_measure()
                _, info = fused_bicgstab_solve(cd, b, tol=0.0, maxiter=BICG_STEPS, inv_diag=inv)
                t.stop_measure()
                used = {k: _common.LAUNCHES[k] - before[k] for k in BICG_ROUTE_KERNELS}
                _, h25 = fused_bicgstab_solve(cd, b, tol=0.0, maxiter=25, inv_diag=inv)
            k = int(info.iterations)
            check(k == BICG_STEPS and not bool(info.breakdown),
                  f"{what}: {k} of {BICG_STEPS} steps, breakdown {bool(info.breakdown)}")
            check(all(used[n] == (BICG_STEPS if n.endswith("_packed") == (route == "packed") else 0)
                      for n in BICG_ROUTE_KERNELS), f"{what}: launches {used}")
            hist[route] = h25.rnorm_history.double().cpu().numpy()
            print(f"  {what}: {t.get_duration() / BICG_STEPS:.5f} ms/it over {BICG_STEPS} steps, "
                  f"launches {used}  [{card}]")
        hd, hp = hist["dense"], hist["packed"]
        check(np.allclose(hp[:11], hd[:11], rtol=BICG_TRAJ_RTOL, atol=0)
              and np.isfinite(hp).all() and np.isfinite(hd).all(),
              f"fused BiCGStab convdiff nx=512 {precond}: packed vs dense history {hp.tolist()} vs "
              f"{hd.tolist()}")
        print(f"  fused BiCGStab convdiff nx=512 {precond}: the two routes' 25-step histories agree "
              f"within {BICG_TRAJ_RTOL:g} over 10 steps (largest difference there "
              f"{np.abs(hp[:11] / hd[:11] - 1).max():.2g}, to step 25 {np.abs(hp / hd - 1).max():.2g})")
    torch.cuda.synchronize()


def phase_bicgstab_path(dev, bic_ops, card):
    """The BiCGStab path through its entry points (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (bicgstab_solve, fused_bicgstab_solve,
                                             jacobi_preconditioner)
    from conjugategradient_tpu_torch.io import loader
    from conjugategradient_tpu_torch.ops.cuda import _common
    from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as fb
    from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
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
    for layout, precond, kernel in (("bell", "none", "bell_spmv_packed"), ("dia", "jacobi", "dia_spmv"),
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
        before = {k: _common.LAUNCHES[k] for k in BICG_ROUTE_KERNELS}
        xf, fi = bicgstab_solve(a, b, tol=tol, maxiter=64, fused="always")
        used = {k: _common.LAUNCHES[k] - before[k] for k in BICG_ROUTE_KERNELS}
        launched = used["bicgstab_dir_spmv_dot"]
        check(used["bicgstab_s_spmv_dot"] == launched and not bell_packed_route(a)
              and all(used[k] == 0 for k in BICG_ROUTE_KERNELS if k.endswith("_packed")),
              f"fused BiCGStab bicgstab-bell (dense tiles): launches {used}")
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
    # the operator's sparse tiles take the packed kernels 18 and 19.  The
    # effective rate keeps bench.py's convention (the full layout's bytes:
    # 2 tile streams + 17 vectors), which is not a stream rate on this
    # route; the needed-bytes rate counts the nonzeros the two products
    # read (8 bytes each) and the same 17 vectors
    check(bell_packed_route(cd), "convdiff-512: the route does not take the packed view")
    eff = 2 * cd.tile_bytes() + 17 * n * 4
    needed = 2 * 8 * cd.packed().nnz + 17 * n * 4
    fused_bicgstab_solve(cd, b, tol=0.0, maxiter=8)
    before = {k_: _common.LAUNCHES[k_] for k_ in BICG_ROUTE_KERNELS}
    t = Timer(dev).start_measure()
    state = fused_bicgstab_init(cd, b, None, BICG_STEPS)
    for _ in range(BICG_STEPS):
        fused_bicgstab_step(cd, state)
    t.stop_measure()
    used = {k_: _common.LAUNCHES[k_] - before[k_] for k_ in BICG_ROUTE_KERNELS}
    check(used == {"bicgstab_dir_spmv_dot": 0, "bicgstab_s_spmv_dot": 0,
                   "bicgstab_dir_spmv_dot_packed": BICG_STEPS,
                   "bicgstab_s_spmv_dot_packed": BICG_STEPS},
          f"fused BiCGStab convdiff: launches {used} in {BICG_STEPS} steps")
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
                               ("K18 packed", "bicg_dir_packed_kernel"),
                               ("K19 packed", "bicg_s_packed_kernel"),
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
          f"of tiles, packed route): {k} steps all live, {ms_it:.5f} ms/it (init + {BICG_STEPS} "
          f"steps; whole solve {solve_ms:.3f} ms), effective {eff / ms_it / 1e6:.1f} GB/s on "
          f"{eff / 1e6:.1f} MB/it (2 tile streams + 17 vectors: bench.py's convention, not a "
          f"stream rate here), needed-bytes rate {needed / ms_it / 1e6:.1f} GB/s on "
          f"{needed / 1e6:.1f} MB/it (2 x 8 bytes a nonzero + 17 vectors); 64 steps: device busy "
          f"{busy_s}; kernels' device time {per_kernel}; bitwise step/solve ok; portable loop "
          f"{port_ms_it:.5f} ms/it ({port_ms_it / ms_it:.1f}x the fused)  [{card}]")
    bicg_route_comparison(dev, cd, b, card)

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
    before = kernel5_launches()
    tw = TOL_SOLVE_REL * float(bs.double().norm())
    x, info = bicgstab_solve(small, bs, x0, tol=tw, maxiter=400, fused="always")
    r0 = (bs.cpu() - small.to("cpu").matvec(x0.cpu())).double()
    e0 = abs(float(info.rnorm_history[0]) / float(r0.norm()) - 1)
    true_rel = float((bs - small.matvec(x)).double().norm()) / float(bs.double().norm())
    check(kernel5_launches() >= before + 2, "BiCGStab x0 warm start did not launch kernel 5")
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


# ---- phase 2, sharded: kernels 6 and 17 against their plain versions ------------

def sharded_ops(dev, n_shards):
    """The n = 262,144 block-tridiagonal operator split into ``n_shards``
    row shards on the card (split_tridiag_tiles)."""
    import torch

    blocks, cols = split_tridiag_tiles(N_BIG, n_shards, 128)
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev)


def random_shard(rng, nrb, bn, n_shards, shard, dev):
    """A ragged random shard: tiles with GLOBAL column blocks over
    ``n_shards * nrb`` block-rows, and its row offset."""
    import torch

    ncb = n_shards * nrb
    blocks = torch.as_tensor(rng.standard_normal((nrb, 3, bn, bn)), dtype=torch.float32,
                             device=dev)
    cols = torch.as_tensor(rng.integers(0, ncb, (nrb, 3)), dtype=torch.int32, device=dev)
    return blocks, cols, ncb, shard * nrb * bn


def check_k6(blocks, cols, full, off, errs, label):
    """Kernel 6 against its plain version: q within TOL_Q of max|q|, pap
    within TOL_DOT, two launches bit-identical."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    qk, pk = fc.bell_spmv_dot(blocks, cols, full, off)
    qk2, pk2 = fc.bell_spmv_dot(blocks, cols, full, off)
    qp, pp = fc._spmv_dot_plain(blocks, cols, full, off, None, None)
    torch.cuda.synchronize()
    e_q, m_q = rel_max_err(qk, qp)
    e_pap = abs(float(pk) - float(pp))
    check(e_q <= TOL_Q * m_q, f"K6 {label}: q err {e_q} vs max|q| {m_q}")
    check(e_pap <= TOL_DOT * abs(float(pp)), f"K6 {label}: pap {float(pk)} vs {float(pp)}")
    check(torch.equal(qk, qk2) and torch.equal(pk, pk2), f"K6 {label}: two launches differ")
    errs["bell_spmv_dot"] = max(errs["bell_spmv_dot"], e_q, e_pap)
    print(f"  K6 {label:<40} |dq|={e_q:.3g} (max|q| {m_q:.4g}) |dpap|={e_pap:.3g} "
          f"(pap {float(pp):.6g}); repeat ok")


def check_k17(blocks, cols, full, off, rng, errs, label, shift=0.07, first=False, jacobi=False):
    """Kernel 17 against its plain version: w and x' bit for bit (also
    written over w-2 and x), q within TOL_Q of max|q|, v.q within TOL_DOT
    and v.r1 within TOL_DOT of ||v_win|| ||r1||; two launches bit-identical.
    ``first``: su = 0 (no pending update: w = 0, x unchanged); ``jacobi``: v
    scaled as the loop scales it, (d * r2) / beta."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    nrb, bn = blocks.shape[0], blocks.shape[3]
    dev = blocks.device

    def vec(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    if jacobi:
        full = (torch.as_tensor(0.5 + rng.random(full.shape), dtype=torch.float32, device=dev)
                * full) * 0.31
    vecs = [vec((nrb, bn)) for _ in range(5)]
    su = torch.zeros(1, 8, device=dev)
    su[0, fm.SU_SHIFT] = shift
    if not first:
        su[0, fm.SU_OLDEPS:fm.SU_PHI + 1] = torch.tensor([0.11, 0.23, 0.57, 0.83])
    k = fm.minres_shard_spmv_dot(blocks, cols, full, *vecs, su, off)
    k2 = fm.minres_shard_spmv_dot(blocks, cols, full, *vecs, su, off)
    p = fm._shard_plain(blocks, cols, full, tuple(vecs), su, off, None, None)
    w_in, x_in = vecs[3].clone(), vecs[4].clone()
    q_o, dots = torch.empty_like(w_in), torch.empty(2, device=dev)
    k3 = fm.minres_shard_spmv_dot(blocks, cols, full, *vecs[:3], w_in, x_in, su, off,
                                  out=(q_o, w_in, x_in, dots))
    torch.cuda.synchronize()
    check(torch.equal(k[1], p[1]) and torch.equal(k[2], p[2]),
          f"K17 {label}: w or x' not bit-equal to the plain version")
    check(torch.equal(k3[1], p[1]) and torch.equal(k3[2], p[2]),
          f"K17 {label}: w or x' written over w-2 and x differ")
    check(all(torch.equal(a, b) for a, b in zip(k, k2)), f"K17 {label}: two launches differ")
    if first:
        check(not bool(k[1].any()) and torch.equal(k[2], vecs[4]),
              f"K17 {label}: a first step (su = 0) changed x or w")
    e_q, m_q = rel_max_err(k[0], p[0])
    check(e_q <= TOL_Q * m_q, f"K17 {label}: q err {e_q} vs max|q| {m_q}")
    e_vq = abs(float(k[3]) - float(p[3]))
    e_vr1 = abs(float(k[4]) - float(p[4]))
    vwin = full[off // bn:off // bn + nrb]
    check(e_vq <= TOL_DOT * abs(float(p[3])), f"K17 {label}: vq {float(k[3])} vs {float(p[3])}")
    check(e_vr1 <= TOL_DOT * float(vwin.norm() * vecs[0].norm()),
          f"K17 {label}: vr1 {float(k[4])} vs {float(p[4])}")
    errs["minres_shard_spmv_dot"] = max(errs["minres_shard_spmv_dot"], e_q, e_vq, e_vr1)
    print(f"  K17 {label:<39} w, x' bit-equal (also in place); |dq|={e_q:.3g} "
          f"(max|q| {m_q:.4g}) |dvq|={e_vq:.3g} |dvr1|={e_vr1:.3g}; repeat ok")
    return vecs, su


def check_partials_only(shape, rng, dev, label):
    """Kernels 2, 3 and 16 in the sharded loop's partials-only mode against
    their full-tail launches: x', r' and r2' bit-equal, the same partial
    sums, and the solve's scalars and control words untouched."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    x, p, r, q = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                  for _ in range(4))
    d = torch.as_tensor(0.5 + rng.random(shape), dtype=torch.float32, device=dev)
    alpha = torch.full((1, 1), 0.61, device=dev)
    for name, kern in (
        ("fused_update_dot", lambda **kw: fc.fused_update_dot(x, p, r, q, alpha, **kw)),
        ("fused_update_dot_pcg", lambda **kw: fc.fused_update_dot_pcg(x, p, r, q, d, alpha, **kw)),
    ):
        full = kern(work=fc.FusedWork.new(dev, maxiter=4))
        work = fc.FusedWork.new(dev, maxiter=4)
        before = (work.scal.clone(), work.ctl.clone(), work.hist.clone())
        part = kern(work=work, partials_only=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(full, part)),
              f"{name} {label}: partials-only launch differs from the full-tail one")
        check(torch.equal(work.scal, before[0]) and torch.equal(work.ctl, before[1])
              and torch.equal(work.hist.isnan(), before[2].isnan()),
              f"{name} {label}: partials-only launch changed the solve's scalars")
    c1, ia = torch.full((1, 1), 0.4, device=dev), torch.full((1, 1), 0.9, device=dev)
    for dd in (None, d):
        wf, wp = fm.MinresWork.new(dev, maxiter=4), fm.MinresWork.new(dev, maxiter=4)
        for w in (wf, wp):
            w.start(torch.tensor(2.3, device=dev))
        before = (wp.scal.clone(), wp.ctl.clone())
        yf, bf = fm.minres_update_dot(q, r, p, c1, ia, dd, work=wf)
        yp, bp = fm.minres_update_dot(q, r, p, c1, ia, dd, work=wp, partials_only=True)
        torch.cuda.synchronize()
        check(torch.equal(yf, yp) and torch.equal(bf, bp),
              f"minres_update_dot {label}: partials-only launch differs from the full-tail one")
        check(torch.equal(wp.scal, before[0]) and torch.equal(wp.ctl, before[1]),
              f"minres_update_dot {label}: partials-only launch changed the solve's scalars")
    print(f"  partials-only kernels 2, 3, 16 {label:<12} x', r', r2' and partials bit-equal "
          "to the full-tail launches; scalars untouched")


def phase_sharded_kernels(dev, errs, times, extra):
    """Kernels 6 and 17 against their plain versions and timed on the
    sharded path's shards (the n = 262,144 operator in 4 and 8 shards), at
    a ragged nrb = 13, and the partials-only modes of kernels 2, 3 and 16.
    Returns the split operator."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc
    from conjugategradient_tpu_torch.ops.cuda import fused_minres as fm

    rng = np.random.default_rng(17)
    blocks4, cols4 = sharded_ops(dev, 4)
    m4 = N_BIG // 4
    full = torch.as_tensor(rng.standard_normal((N_BIG // 128, 128)), dtype=torch.float32,
                           device=dev)
    for s in (0, 3):
        check_k6(blocks4[s], cols4[s], full, s * m4, errs, f"tridiag n=262144 P=4 shard {s}")
    for bn in (32, 64):
        b13, c13, ncb, off = random_shard(rng, 13, bn, 3, 2, dev)
        full13 = torch.as_tensor(rng.standard_normal((ncb, bn)), dtype=torch.float32, device=dev)
        check_k6(b13, c13, full13, off, errs, f"ragged nrb=13 bn={bn} offset {off}")
    for s in (0, 3):
        args4 = check_k17(blocks4[s], cols4[s], full, s * m4, rng, errs,
                          f"tridiag n=262144 P=4 shard {s}")
    check_k17(blocks4[1], cols4[1], full, m4, rng, errs, "tridiag P=4 shard 1 first step",
              first=True)
    check_k17(blocks4[2], cols4[2], full, 2 * m4, rng, errs, "tridiag P=4 shard 2 jacobi v",
              shift=0.0, jacobi=True)
    for bn in (32, 64):
        b13, c13, ncb, off = random_shard(rng, 13, bn, 3, 1, dev)
        full13 = torch.as_tensor(rng.standard_normal((ncb, bn)), dtype=torch.float32, device=dev)
        for first, jacobi in ((False, False), (True, False), (False, True)):
            tag = " first step" if first else (" jacobi v" if jacobi else "")
            check_k17(b13, c13, full13, off, rng, errs, f"ragged nrb=13 bn={bn}{tag}",
                      first=first, jacobi=jacobi)
    check_partials_only((N_BIG // 128, 128), rng, dev, "(2048, 128)")
    check_partials_only((13, 32), rng, dev, "(13, 32)")

    # timing at the path's shapes, launched as the loop launches them: into
    # its buffers, on a solve's work that never finishes
    work = fc.FusedWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork = fm.MinresWork.new(dev, maxiter=1 << 20, tol=-1.0)
    mwork.start(torch.tensor(2.3, device=dev))
    blocks8, cols8 = blocks4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3)
    for n_shards, bl, cl, table, k6, k17 in (
        (4, blocks4, cols4, times, "bell_spmv_dot", "minres_shard_spmv_dot"),
        (8, blocks8, cols8, extra, "K6 tridiag P=8", "K17 tridiag P=8"),
    ):
        m = N_BIG // n_shards
        q, pap = torch.empty(m // 128, 128, device=dev), torch.empty(1, 1, device=dev)
        b0, c0 = bl[0], cl[0]
        t = time_pair(lambda: fc.bell_spmv_dot(b0, c0, full, 0, out=(q, pap), work=work),
                      lambda: fc._spmv_dot_plain(b0, c0, full, 0, None, None))
        # tiles and columns of the shard, the gathered operand, q
        t.update(bound(nbytes(b0, c0, full) + m * 4, 2 * b0.numel() + 2 * m),
                 library_ms=None)  # an SpMV fused with a window dot: no one call
        table[k6] = t
        vecs = [torch.as_tensor(rng.standard_normal((m // 128, 128)), dtype=torch.float32,
                                device=dev) for _ in range(5)]
        su = args4[1].clone()
        su[0, fm.SU_PHI] = 0.0  # x stays put over the timed launches
        dots = torch.empty(2, device=dev)
        out = (torch.empty_like(vecs[0]), vecs[3], vecs[4], dots)
        t = time_pair(lambda: fm.minres_shard_spmv_dot(b0, c0, full, *vecs, su, 0, out=out,
                                                       work=mwork),
                      lambda: fm._shard_plain(b0, c0, full, tuple(vecs), su, 0, None, None))
        # the shard's tiles, v, five local vectors in and three out
        t.update(bound(nbytes(b0, c0, full, su) + 8 * m * 4, 2 * b0.numel() + 12 * m),
                 library_ms=None)  # an SpMV fused with two axpys, a shift, two dots
        table[k17] = t
    torch.cuda.synchronize()
    print(f"  kernels 6 / 17 at P = 4: bound {times['bell_spmv_dot']['bound_ms']:.5f} / "
          f"{times['minres_shard_spmv_dot']['bound_ms']:.5f} ms per launch "
          f"(x{4}: {4 * times['bell_spmv_dot']['bound_ms']:.5f} / "
          f"{4 * times['minres_shard_spmv_dot']['bound_ms']:.5f} per iteration)")
    return blocks4, cols4


# ---- phase 3, sharded: the row-sharded solve ------------------------------------------

def kernel_rows(fn, steps, top=6):
    """The device ms and CUDA kernel launches per step over one call of
    ``fn`` (a solve of ``steps`` steps), and the ``top`` kernels' device ms
    per step, or 'not measured'."""
    prof = kernel_profile(fn, top=top)
    if prof is None:
        return "not measured"
    total, launched, rows = prof
    short = []
    for name, ms, _ in rows:
        name = name.replace("void ", "").replace("(anonymous namespace)::", "")
        short.append((name.split("<")[0].split("(")[0].split("::")[-1][:24], ms / steps))
    return (f"device {total / steps:.5f} ms/it in {launched / steps:.1f} launches/it; top: "
            + ", ".join(f"{n} {ms:.5f}" for n, ms in short))


def phase_sharded_path(dev, big_full, shard_ops, card):
    """The row-sharded path through ``sharded_cg_solve`` (module doc, phase 3)."""
    import torch

    from conjugategradient_tpu_torch import (CSRMatrix, cg_solve, fused_bell_cg_solve,
                                             fused_bell_pcg_solve, load_matrix, minres_solve)
    from conjugategradient_tpu_torch.io import read_csr_host
    from conjugategradient_tpu_torch.parallel import loops, make_row_mesh, partition_csr_rows
    from conjugategradient_tpu_torch.parallel import sharded_cg_solve
    from conjugategradient_tpu_torch.problems import poisson2d_coo
    from conjugategradient_tpu_torch.utils import Timer

    blocks4, cols4 = shard_ops
    n = N_BIG
    b = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    bm = b / n  # bench.py's minres right-hand side
    eff = big_full.tile_bytes() + 10 * n * 4  # the single-card fused CG's 413.1 MB/it
    ops = {4: (blocks4, cols4), 8: (blocks4.view(8, -1, 3, 128, 128), cols4.view(8, -1, 3))}
    inv_diag = 1.0 / big_full.diagonal()

    def solve(n_shards, rhs, steps, **kw):
        bl, cl = ops[n_shards]
        return sharded_cg_solve(bl, cl, rhs, mesh=make_row_mesh(n_shards, dev), tol=-1.0,
                                maxiter=steps, **kw)

    def timed(label, n_shards, rhs, steps, **kw):
        """ms per live step; every step must be live, except for MINRES,
        whose Lanczos beta may reach 0 (done): then the live steps are
        counted and the time is over those."""
        solve(n_shards, rhs, 16, **kw)
        t = Timer(dev).start_measure()
        x, info = solve(n_shards, rhs, steps, **kw)
        t.stop_measure()
        k = int(info.iterations)
        check(k == steps or (kw.get("method") == "minres" and k > 0),
              f"sharded {label} P={n_shards}: {k} of {steps} steps live")
        ms_it = t.get_duration() / k
        run64 = lambda: solve(n_shards, rhs, 64, **kw)
        t = Timer(dev).start_measure()
        run64()
        t.stop_measure()
        busy = device_ms(run64, reps=1)
        busy_s = "not measured" if busy is None else \
            f"{busy:.4f} of {t.get_duration():.4f} ms ({100 * busy / t.get_duration():.1f}%)"
        print(f"  sharded {label} n={n} P={n_shards}: k = {k} of {steps}, {ms_it:.5f} ms/it, effective "
              f"{eff / ms_it / 1e6:.1f} GB/s on {eff / 1e6:.1f} MB/it; 64 steps: device busy "
              f"{busy_s}; {kernel_rows(run64, 64)}  [{card}]")
        return x, info, ms_it

    # (a) the fused sharded CG at P = 4 and 8, the single-card fused CG beside
    fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=32)
    t = Timer(dev).start_measure()
    _, info1 = fused_bell_cg_solve(big_full, b, tol=-1.0, maxiter=256)
    t.stop_measure()
    one_ms = t.get_duration() / 256
    print(f"  single-card fused CG n={n} full storage: {one_ms:.5f} ms/it, effective "
          f"{eff / one_ms / 1e6:.1f} GB/s  [{card}]")
    for n_shards in (4, 8):
        timed("fused CG", n_shards, b, 256)
    # (b) fused Jacobi PCG and fused MINRES at P = 4, the portable CG beside
    timed("fused Jacobi PCG", 4, b, 256, inv_diag=inv_diag)
    timed("fused MINRES", 4, bm, 256, method="minres")
    solve(4, b, 8, use_fused="never")
    t = Timer(dev).start_measure()
    _, ip = solve(4, b, 64, use_fused="never")
    t.stop_measure()
    check(int(ip.iterations) == 64, f"portable sharded CG: {int(ip.iterations)} steps")
    print(f"  portable sharded CG n={n} P=4: {t.get_duration() / 64:.5f} ms/it  [{card}]")

    # (c) against the single-card fused CG and Jacobi PCG at P = 4 and 8: the
    # 25-step trajectory on the cut operator (cut_tridiag_ops), at least
    # PARITY_MIN_USED entries above the float32 floor; then twice, bitwise
    cut_full, cut_ops, cut_inv = cut_tridiag_ops(blocks4, cols4, big_full.nnz)
    rhs = torch.as_tensor(np.random.default_rng(9).standard_normal(n), dtype=torch.float32,
                          device=dev)
    used_all = []
    for n_shards in (4, 8):
        for jac in (None, cut_inv):
            what = f"sharded fused {'Jacobi PCG' if jac is not None else 'CG'} P={n_shards}"
            _, i25 = sharded_cg_solve(*cut_ops[n_shards], rhs, mesh=make_row_mesh(n_shards, dev),
                                      tol=-1.0, maxiter=25, inv_diag=jac)
            if jac is None:
                _, o25 = fused_bell_cg_solve(cut_full, rhs, tol=-1.0, maxiter=25)
            else:
                _, o25 = fused_bell_pcg_solve(cut_full, rhs, jac, tol=-1.0, maxiter=25)
            ok, used = trajectory_ok(i25.rho_history, o25.rho_history, 25)
            check(ok and used >= PARITY_MIN_USED,
                  f"{what} vs the single card: rho_history beyond rtol {TRAJ_RTOL} or only "
                  f"{used} entries above the float32 floor")
            hs, ho = (h[1:26].double().cpu().numpy() for h in (i25.rho_history,
                                                              o25.rho_history))
            keep = ho > 1e-10 * float(o25.rho_history[0])
            used_all.append(f"{used} ({np.abs(hs[keep] / ho[keep] - 1).max():.2g})")
    for n_shards in (4, 8):
        x1, r1 = solve(n_shards, b, 256)
        x2, r2 = solve(n_shards, b, 256)
        check(torch.equal(x1, x2) and torch.equal(r1.rho_history.view(torch.int32),
                                                  r2.rho_history.view(torch.int32)),
              f"sharded fused CG P={n_shards}: two runs differ")
    print(f"  sharded vs single-card fused CG and Jacobi PCG, P=4 and 8, cut operator: 25-step "
          f"rho_history agrees on {', '.join(used_all)} entries above the float32 floor (largest "
          f"relative difference); P=4 and P=8 "
          f"repeat bit for bit")

    # (d) float64 portable sharded CG on poisson3d_48 at P = 4 against cg_solve
    path = os.path.join(ROOT, MATRICES[0])
    data, indices, indptr, shape = read_csr_host(path)
    blocks, bcols, n_pad = partition_csr_rows(data, indices, indptr, shape, 4, bm=8, bn=8)
    np3 = shape[0]
    b64 = torch.zeros(n_pad, dtype=torch.float64, device=dev)
    b64[:np3] = torch.arange(1, np3 + 1, dtype=torch.float64, device=dev)
    tol64 = 1e-8 * bnorm(np3)
    with count_steps(loops, "_pcg_body_fn") as counter:
        xs, is_ = sharded_cg_solve(blocks, bcols, b64, mesh=make_row_mesh(4, dev), tol=tol64)
    csr = load_matrix(path, layout="csr", dtype=np.float64, device=dev)
    x1, i1 = cg_solve(csr, b64[:np3], tol=tol64)
    e, m = rel_max_err(xs[:np3], x1)
    check(bool(is_.converged) and int(is_.iterations) == int(i1.iterations) and e <= 1e-11 * m,
          f"float64 sharded CG poisson3d_48: {int(is_.iterations)} vs {int(i1.iterations)} its, "
          f"x differs by {e} (max {m})")
    print(f"  float64 portable sharded CG poisson3d_48 P=4 (8 x 8 tiles): {int(is_.iterations)} "
          f"its as cg_solve, x to {e / m:.3g} of max|x|")
    check_stops_at_done("portable sharded CG poisson3d_48", counter.calls, int(is_.iterations))

    # (e) sharded MINRES on indefinite operators against the single-card
    # minres_solve, fused (128 x 128 tiles) and portable (32 x 32: a float32
    # SpMV on the card is kernel 5, which takes bn in CUDA_BN): poisson2d(24)
    # - 3I (__graft_entry__.py:481; singular, so only its first three phibars,
    # as there) and poisson2d(20) - 3I (tests/test_sharded_minres.py:38) to
    # MINRES_INDEF_TOL_REL ||b||
    import scipy.sparse as sp

    for nx, steps in ((24, 3), (20, None)):
        rows, cols, vals, shp = poisson2d_coo(nx)
        vals = np.asarray(vals, np.float64).copy()
        vals[np.asarray(rows) == np.asarray(cols)] -= 3.0
        a = sp.csr_matrix((vals.astype(np.float32), (rows, cols)), shape=shp)
        a.sort_indices()
        na = shp[0]
        one = CSRMatrix.from_arrays(a.data, a.indices, a.indptr, shp, device=dev)
        bb = torch.ones(na, dtype=torch.float32, device=dev)
        tt = 0.0 if steps else MINRES_INDEF_TOL_REL * float(bb.norm())
        _, i_one = minres_solve(one, bb, tol=tt, maxiter=steps or 4 * na)
        for tile, fused in ((128, "always"), (32, "never")):
            bl, bc, npd = partition_csr_rows(a.data, a.indices, a.indptr, shp, 4, bm=tile, bn=tile)
            bp = torch.zeros(npd, dtype=torch.float32, device=dev)
            bp[:na] = 1.0
            x, info = sharded_cg_solve(bl, bc, bp, mesh=make_row_mesh(4, dev), tol=tt,
                                       maxiter=steps or 4 * na, method="minres", use_fused=fused)
            k, k1 = int(info.iterations), int(i_one.iterations)
            h = np.sqrt(info.rho_history.double().cpu().numpy()[:4])
            h1 = i_one.rnorm_history.double().cpu().numpy()[:4]
            true_r = float((bb - one.matvec(x[:na])).double().norm())
            what = (f"indefinite sharded MINRES poisson2d({nx}) - 3I P=4 {tile}x{tile} "
                    f"use_fused={fused}")
            check(np.allclose(h, h1, rtol=1e-3), f"{what}: phibar {h} vs {h1}")
            if steps:
                check(k == steps, f"{what}: {k} of {steps} steps")
                print(f"  {what}: {k} steps, the first phibars to 1e-3 of the single card's")
                continue
            check(bool(info.converged) and abs(k - k1) <= ITER_SLACK
                  and true_r <= MINRES_TRUE_FACTOR * tt,
                  f"{what}: {k} its against {k1}, ||b - Ax|| {true_r}")
            print(f"  {what}: {k} its (single card {k1}), ||b - Ax|| = {true_r:.3e} "
                  f"({tt:.3e} asked)")

    # (f) caps of 1, 2 and 7 against the portable loop (cut operator, P = 4
    # and 8, with and without Jacobi); b = 0; an x0 warm start (fused, P = 4)
    for n_shards in (4, 8):
        for jac in (None, cut_inv):
            for method in ("standard", "minres"):
                for cap in (1, 2, 7):
                    kw = dict(mesh=make_row_mesh(n_shards, dev), tol=-1.0, maxiter=cap,
                              method=method, inv_diag=jac)
                    xf, fi = sharded_cg_solve(*cut_ops[n_shards], rhs, **kw)
                    xp, _ = sharded_cg_solve(*cut_ops[n_shards], rhs, use_fused="never", **kw)
                    e, m = rel_max_err(xf, xp)
                    check(int(fi.iterations) == cap and e <= 1e-4 * m,
                          f"sharded {method} P={n_shards} jacobi={jac is not None} cap {cap}: "
                          f"{int(fi.iterations)} steps, x differs by {e}")
    del cut_full, cut_ops
    for method in ("standard", "minres"):
        x, info = sharded_cg_solve(*ops[4], torch.zeros_like(b), mesh=make_row_mesh(4, dev),
                                   tol=1e-30, method=method)
        check(not bool(x.any()) and bool(info.converged) and int(info.iterations) <= 1,
              f"sharded {method} b = 0: {int(info.iterations)} its")
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(n), dtype=torch.float32,
                         device=dev)
    x, info = sharded_cg_solve(*ops[4], b, x0, mesh=make_row_mesh(4, dev),
                               tol=TOL_SOLVE_REL * bnorm(n))
    r0 = b - big_full.matvec(x0)
    e0 = abs(float(info.rho_history[0]) / float(r0.double() @ r0.double()) - 1)
    true_rel = float((b - big_full.matvec(x)).double().norm()) / bnorm(n)
    check(bool(info.converged) and e0 <= TOL_DOT and true_rel < 1e-4,
          f"sharded x0 warm start: converged {bool(info.converged)}, ||r0||^2 off by {e0}, "
          f"true relative residual {true_rel}")
    print(f"  sharded CG and MINRES capped at 1, 2, 7 steps, P=4 and 8, with and without "
          f"Jacobi: x equals the portable loop's to 1e-4 of max|x|; b = 0 ends at once; x0 warm start {int(info.iterations)} its, "
          f"||r0||^2 rel diff {e0:.3g}, true relative residual {true_rel:.3e}")
    torch.cuda.synchronize()


def fused_cg_only(dev, card) -> None:
    """The fused CG loops alone (``--fused-cg-only``): ms/it over 256 steps
    and a hash of each history; then the fused MINRES at n = 262,144 in
    both storages (dense tiles; bench.py's protocol, 256 steps at tol = -1)
    and the fused BiCGStab on bench.py's bicgstab-bell operator (dense
    tiles), a hash of each one's history and x.  For comparing the dense
    routes of two trees on one card (this file run beside another tree's
    package gives that tree's hashes)."""
    import torch

    from conjugategradient_tpu_torch import (StencilOperator, bicgstab_solve, fused_bell_cg_solve,
                                             fused_minres_solve, fused_stencil_cg_solve)
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
    bm = b / N_BIG  # bench.py's minres protocol
    for label, a in (("n=262144 symmetric", big), ("n=262144 full", big_full)):
        x, info = fused_minres_solve(a, bm, tol=-1.0, maxiter=MINRES_STEPS)
        digest = hashlib.sha256(info.rnorm_history.cpu().numpy().tobytes()
                                + x.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"  fused MINRES {label}: {int(info.iterations)} its, rnorm_history and x "
              f"sha256 {digest}  [{card}]")
    a = nonsym_tridiag(N_BIG, 128, dev, seed=0)
    b = torch.arange(1, a.n + 1, dtype=torch.float32, device=dev) / a.n
    for tol in (TOL_SOLVE_REL * float(b.double().norm()), 0.0):
        x, info = bicgstab_solve(a, b, tol=tol, maxiter=64, fused="always")
        digest = hashlib.sha256(info.rnorm_history.cpu().numpy().tobytes()
                                + x.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"  fused BiCGStab bicgstab-bell tol {tol:.3g}: {int(info.iterations)} its, "
              f"rnorm_history and x sha256 {digest}  [{card}]")


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
    shard_ops = phase_sharded_kernels(dev, errs, times, extra)
    for name, t in list(times.items()) + list(extra.items()):
        more = ""
        if "bound_ms" in t:
            more = f"; bound {t['bound_ms']:.5f} ({t['bound_by']}, {t['bound_ms'] / t['ms']:.3f} of it)"
        if "needed_ms" in t:
            more += (f"; needed-bytes bound {t['needed_ms']:.5f} "
                     f"({t['needed_ms'] / t['ms']:.4f} of it)")
        if "view_ms" in t:
            more += f"; the view's own bound {t['view_ms']:.5f}"
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
        ("sharded", SHARDED_KERNELS, lambda: phase_sharded_path(dev, big_full, shard_ops, card)),
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
        for name in SOURCES
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
