#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``conjugategradient_tpu_torch``)
on one NVIDIA GPU.

Usage, from the repository root: ``python3 chip_smoke.py``

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``conjugategradient_tpu_torch/csrc``.
2. Hold each kernel against its plain-torch version on the card, at the
   main path's shapes (bm = bn = 128) and at small ragged shapes.
3. Drive the main path through its entry points, with the launch counters
   reset just before: the tester on ``problems/poisson3d_48.mtx`` and
   ``problems/elasticity3d_16.mtx`` (symbell, float32, plain CG and Jacobi
   PCG); the n = 262,144 block-tridiagonal operator for 256 timed steps and
   one solve to tolerance; the fused solves against the plain-torch loop on
   the same card, and twice against themselves (bitwise); the tester's
   default CSR float64 path twice (bitwise).
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
KERNEL_SOURCE = "conjugategradient_tpu_torch/csrc/fused_cg.cu"
REPLACES = {
    "sym_fused_dir_spmv_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:338",
    "fused_update_dot": "conjugategradient_tpu/ops/pallas/fused_cg.py:608",
    "fused_update_dot_pcg": "conjugategradient_tpu/ops/pallas/fused_cg.py:555",
}
# stated tolerances (f32 sum order differs between kernel and plain version)
TOL_ELEMWISE = 1e-6  # p_new, x', r': rtol of max|plain|
TOL_Q = 1e-5  # q: of max|q|
TOL_DOT = 1e-5  # pap, rnorm, rho: relative
TOL_SOLVE_REL = 1e-5  # solve tolerance: 1e-5 * ||b||
REL_ERROR_BOUND = 1e-8  # tester rel_error = ||b - Ax||^2 / ||x||^2
TRAJ_RTOL = 5e-2  # fused vs plain rho_history over 25 steps
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

def block_tridiag_sym(n, bn, device):
    from conjugategradient_tpu_torch.problems import block_tridiag_tiles
    from conjugategradient_tpu_torch.types import SymBellMatrix

    blocks, cols, nnz = block_tridiag_tiles(n, bn, bn, seed=0)
    a = SymBellMatrix._pack_np(blocks, cols.astype(np.int64), (n, n), (n, n),
                               nnz, check=False, device=device)
    return a


def random_block_sym(rng, nrb, bn, per_row, device):
    """Random block-sparse SPD operator (the shape of tests/test_symbell.py's
    _random_block_sym) packed symmetric."""
    from conjugategradient_tpu_torch.types import SymBellMatrix
    from conjugategradient_tpu_torch.types.bell import pack_host_arrays

    n = nrb * bn
    A = np.zeros((n, n), np.float32)
    for i in range(nrb):
        D = rng.standard_normal((bn, bn)).astype(np.float32)
        A[i * bn:(i + 1) * bn, i * bn:(i + 1) * bn] = D + D.T + 4 * bn * np.eye(bn, dtype=np.float32)
        hi = np.arange(i + 1, nrb)
        for c in rng.choice(hi, size=min(per_row, len(hi)), replace=False):
            B = rng.standard_normal((bn, bn)).astype(np.float32)
            A[i * bn:(i + 1) * bn, c * bn:(c + 1) * bn] = B
            A[c * bn:(c + 1) * bn, i * bn:(i + 1) * bn] = B.T
    rows, cols = np.nonzero(A)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    blocks, bcols, nnz = pack_host_arrays(A[rows, cols], cols, indptr, (n, n), bn, bn)
    return SymBellMatrix._pack_np(blocks, bcols.astype(np.int64), (n, n), (n, n),
                                  nnz, check=True, device=device)


def load_symbell(path, device):
    from conjugategradient_tpu_torch import load_matrix

    return load_matrix(os.path.join(ROOT, path), layout="symbell",
                       dtype=np.float32, bn=128, device=device)


def check_k1(a, rng, mirror, with_d, row_group, errs, label):
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    nrb, bn = a.nrb, a.bn
    dev = a.device

    def vec():
        return torch.as_tensor(rng.standard_normal((nrb, bn)), dtype=torch.float32, device=dev)

    r, pold = vec(), vec()
    d = (1.0 / a.diagonal()).reshape(-1)
    d = torch.nn.functional.pad(d, (0, nrb * bn - d.numel()), value=1.0).reshape(nrb, bn) if with_d else None
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


def phase_kernels(dev, big):
    """Kernels against plain versions; returns (errs, times)."""
    import torch

    from conjugategradient_tpu_torch.ops.cuda import fused_cg as fc

    rng = np.random.default_rng(0)
    errs = dict.fromkeys(fc.LAUNCHES, 0.0)
    times = {}
    p3d = load_symbell(MATRICES[0], dev)
    for with_d in (False, True):
        tag = "+d" if with_d else ""
        args = check_k1(big, rng, "banded", with_d, 8, errs, f"tridiag n=262144 banded{tag}")
        check_k1(big, rng, "scatter", with_d, 8, errs, f"tridiag n=262144 general{tag}")
        check_k1(p3d, rng, "scatter", with_d, 8, errs, f"poisson3d_48 general{tag}")
    small_t = block_tridiag_sym(13 * 64, 64, dev)
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
    k1_general = time_pair(
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
    torch.cuda.synchronize()
    return errs, times, k1_general, p3d


# ---- phase 3: the main path ------------------------------------------------

def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


def bnorm(n: int) -> float:
    return math.sqrt(n * (n + 1) * (2 * n + 1) / 6.0)


def run_tester(path, precond, tol):
    from conjugategradient_tpu_torch import tester

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tester.main([os.path.join(ROOT, path), "--layout", "symbell",
                          "--dtype", "float32", "--precond", precond,
                          "--tol", repr(tol), "--summary",
                          "--device", str(DEVICE)])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0, f"tester {path} {precond}: rc={rc}")
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


def phase_main_path(dev, big, p3d, card):
    import torch

    from conjugategradient_tpu_torch import cg_solve, fused_bell_cg_solve, jacobi_preconditioner
    from conjugategradient_tpu_torch.utils import Timer

    results = {}
    # (a) the tester, the reference protocol's entry point
    for path in MATRICES:
        for precond in ("none", "jacobi"):
            from conjugategradient_tpu_torch.io import read_csr_host

            n = read_csr_host(os.path.join(ROOT, path))[3][0]
            tol = TOL_SOLVE_REL * bnorm(n)
            dim, nnz, ms, rel, summ = run_tester(path, precond, tol)
            it = summ["iterations"][0]
            check(summ["converged"][0], f"tester {path} {precond}: not converged in {it}")
            check(math.isfinite(rel) and rel < REL_ERROR_BOUND,
                  f"tester {path} {precond}: rel_error {rel} >= {REL_ERROR_BOUND}")
            print(f"  tester {path} --precond {precond}: dim {dim} nnz {nnz} "
                  f"{ms:.3f} ms, {it} its ({ms / max(it, 1):.4f} ms/it), "
                  f"rel_error {rel:.3e}  [{card}]")
            results[(path, precond)] = (ms, it)

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

    cg_solve(big, b, tol=-1.0, maxiter=32, fused="never")
    t = Timer(dev).start_measure()
    cg_solve(big, b, tol=-1.0, maxiter=64, fused="never")
    t.stop_measure()
    plain_ms_it = t.get_duration() / 64
    print(f"  plain-torch CG n={n}: {plain_ms_it:.5f} ms/it, effective "
          f"{eff / plain_ms_it / 1e6:.1f} GB/s  [{card}]")
    results["big"] = (ms_it, plain_ms_it, eff, streamed)

    for label, a, M in (
        ("tridiag", big, None),
        ("poisson3d_48", p3d, None),
        ("poisson3d_48 jacobi", p3d, "jacobi"),
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
    big = block_tridiag_sym(N_BIG, 128, dev)
    errs, times, k1_general, p3d = phase_kernels(dev, big)
    for name, t in list(times.items()) + [("K1 general poisson3d_48", k1_general)]:
        print(f"  time {name:<24} kernel {fmt_ms(t['device_ms'])} device / "
              f"{t['event_ms']:.5f} per call; plain {fmt_ms(t['plain_device_ms'])} "
              f"device / {t['plain_event_ms']:.5f} per call (ms)  [{card}]")

    print("phase 3: main path")
    fc.reset_counts()
    results = phase_main_path(dev, big, p3d, card)
    launches = dict(fc.LAUNCHES)
    plain_on_cuda = dict(fc.PLAIN_ON_CUDA)

    print(f"phase 4: launches {launches}, plain on CUDA {plain_on_cuda}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the main path")
    for name, count in plain_on_cuda.items():
        check(count == 0, f"plain {name} ran on CUDA tensors in the main path")

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
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
