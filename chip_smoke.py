#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``conjugategradient_tpu_torch``)
on one NVIDIA GPU.

Usage, from the repository root: ``python3 chip_smoke.py``

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``conjugategradient_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel).
2. Hold each of the five kernels against its plain-torch version on the
   card, at the main path's shapes (128 x 128 tiles on the n = 262,144
   block-tridiagonal operator and on poisson3d_48; 8 x 128 tiles on
   poisson3d_48 for the SpMV) and at small ragged shapes, and time both.
3. Drive the main path through its entry points, with the launch counters
   reset just before: the tester on ``problems/poisson3d_48.mtx`` and
   ``problems/elasticity3d_16.mtx`` in both blocked layouts (symbell and
   bell, float32, plain CG and Jacobi PCG); the n = 262,144 operator in
   both storages for 256 timed steps; the fused solves against the
   plain-torch loop on the same card, and twice against themselves
   (bitwise); the portable loop on ``load_matrix(layout="bell")`` (8 x 128
   tiles); residual replacement every 8 steps on the fused symmetric and
   full solves and the portable loop, against the same solves run by the
   plain versions on the CPU; one x0 warm start; the tester's default CSR
   float64 path twice (bitwise).
4. Check that every kernel launched during phase 3 and that no plain
   version was given a CUDA tensor there; print the kernel table as JSON.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result.  Times are CUDA-event times, and kernel device times from
torch.profiler, on this card.
"""

from __future__ import annotations

import contextlib
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
SOURCES = {
    "sym_fused_dir_spmv_dot": FUSED_SOURCE,
    "fused_dir_spmv_dot": FUSED_SOURCE,
    "fused_update_dot": FUSED_SOURCE,
    "fused_update_dot_pcg": FUSED_SOURCE,
    "bell_spmv": "conjugategradient_tpu_torch/csrc/bell_spmv.cu",
}
REPLACES = {
    "sym_fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:338",
    "fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:111",
    "fused_update_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:608",
    "fused_update_dot_pcg": "conjugategradient_tpu/ops/pallas/fused_cg.py:555",
    "bell_spmv": "conjugategradient_tpu/ops/pallas/ell_spmv.py:57",
}
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
    worst = 0.0
    for i, what in enumerate(("x'", "r'")):
        e, m = rel_max_err(ok[i], op[i])
        check(e <= TOL_ELEMWISE * m, f"{name} {label}: {what} err {e}")
        worst = max(worst, e)
    for i, what in ((2, "rnorm"), (3, "rho"))[: 2 if pcg else 1]:
        e = abs(float(ok[i]) - float(op[i]))
        check(e <= TOL_DOT * abs(float(op[i])), f"{name} {label}: {what} {float(ok[i])} vs {float(op[i])}")
        worst = max(worst, e)
    errs[name] = max(errs[name], worst)
    print(f"  {name:<21}{label:<14} max abs err {worst:.3g}")
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
    torch.cuda.synchronize()
    return errs, times, extra, {"p3d": p3d, "p3d_full": p3d_full, "p3d_8": p3d_8}


# ---- phase 3: the main path ------------------------------------------------

def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


def bnorm(n: int) -> float:
    return math.sqrt(n * (n + 1) * (2 * n + 1) / 6.0)


def run_tester(path, layout, precond, tol):
    from conjugategradient_tpu_torch import tester

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tester.main([os.path.join(ROOT, path), "--layout", layout,
                          "--dtype", "float32", "--precond", precond,
                          "--tol", repr(tol), "--summary",
                          "--device", str(DEVICE)])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0, f"tester {path} {layout} {precond}: rc={rc}")
    dim, nnz, ms, rel = lines[0].split()
    summ = json.loads(lines[1])
    return int(dim), int(nnz), float(ms), float(rel), summ


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
                dim, nnz, ms, rel, summ = run_tester(path, layout, precond, tol)
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

    print("phase 2: kernels vs plain versions")
    big_full, big = block_tridiag_ops(N_BIG, 128, dev)
    errs, times, extra, ops = phase_kernels(dev, big, big_full)
    for name, t in list(times.items()) + list(extra.items()):
        print(f"  time {name:<24} kernel {fmt_ms(t['device_ms'])} device / "
              f"{t['event_ms']:.5f} per call; plain {fmt_ms(t['plain_device_ms'])} "
              f"device / {t['plain_event_ms']:.5f} per call (ms)  [{card}]")

    print("phase 3: main path")
    fc.reset_counts()
    results = phase_main_path(dev, big, big_full, ops, card)
    launches = dict(fc.LAUNCHES)
    plain_on_cuda = dict(fc.PLAIN_ON_CUDA)

    print(f"phase 4: launches {launches}, plain on CUDA {plain_on_cuda}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the main path")
    for name, count in plain_on_cuda.items():
        check(count == 0, f"plain {name} ran on CUDA tensors in the main path")

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"]}
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
