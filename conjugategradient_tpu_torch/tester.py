"""End-to-end harness of the port — the reference's ``tester`` protocol
(test/Tester.cpp:12-57), as the JAX package's ``tester.py`` runs it:

* load the MatrixMarket matrix (symmetric storage expanded), or build the
  matrix-free 7-point Poisson operator of a ``stencil:<nx>[x<ny>x<nz>]``
  input (BASELINE config 4; nnz is the logical count);
* b[i] = i + 1 (with ``--reorder``, permuted as the matrix is: b[perm]);
* solve with absolute tolerance ``--tol`` (default 1e-24: run to the cap),
  after one untimed warm-up solve (which also builds the CUDA kernels);
* print ``dim NNZ time_ms rel_error`` with rel_error = |Σ(b−Ax)²/Σx²|.

Usage: ``python -m conjugategradient_tpu_torch.tester <file.mtx | stencil:N> [options]``
(or ``cgtorch-tester``).  ``--device cuda`` (the default) needs a GPU and
exits non-zero without one.  Flags of the JAX harness that this package has
not ported yet exit with code 2 and "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_LAYOUTS = ("auto", "csr", "sell", "bell", "symbell", "dia", "symdia")
_DTYPES = ("float32", "float64")
_PRECONDS = ("none", "jacobi", "amg")
_METHODS = ("standard", "minres")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("mtx", help="MatrixMarket .mtx file (SPD), or the matrix-free "
                    "pseudo-input 'stencil:<nx>[x<ny>x<nz>]' (7-point 3-D "
                    "Poisson operator; no matrix is formed)")
    ap.add_argument("--tol", type=float, default=1e-24,
                    help="absolute tolerance on ||r||2 (reference: 1e-24)")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="iteration cap (reference: N+1)")
    ap.add_argument("--layout", default="csr",
                    help="auto picks by sparsity pattern (with --bm/--bn); "
                         "csr; sell = degree-bucketed ELL; bell = full "
                         "blocked-ELL; symbell = symmetric blocked-ELL (both "
                         "blocked layouts run fused CUDA kernels for float32 "
                         "on a GPU); dia = diagonal storage; symdia = "
                         "symmetric DIA (offsets >= 0 stored once; both DIA "
                         "layouts run a CUDA SpMV kernel for float32 on a GPU)")
    ap.add_argument("--reorder", action="store_true",
                    help="RCM-reorder the system first (bandwidth reduction; "
                         "the printed metrics are permutation-invariant)")
    ap.add_argument("--recompute", type=int, default=0, metavar="N",
                    help="residual-replacement full restart every N "
                         "iterations (0: never)")
    ap.add_argument("--dtype", default="float64", help="float32 or float64")
    ap.add_argument("--precond", default="none",
                    help="none, jacobi, or amg (the geometric multigrid "
                         "V-cycle; stencil: inputs only)")
    ap.add_argument("--smoother", choices=("jacobi", "chebyshev"), default="jacobi",
                    help="multigrid smoother (with --precond amg): nu "
                         "damped-Jacobi sweeps or the degree-nu Chebyshev "
                         "semi-iteration")
    ap.add_argument("--method", default="standard",
                    help="standard = CG; minres = Paige-Saunders MINRES for "
                         "symmetric INDEFINITE systems (monotone residual "
                         "norms; takes an SPD --precond; float32 blocked "
                         "layouts run fused CUDA kernels on a GPU)")
    ap.add_argument("--shift", type=float, default=0.0,
                    help="solve (A - shift*I) x = b (with --method minres: "
                         "the Paige-Saunders spectral shift)")
    ap.add_argument("--bm", type=int, default=128,
                    help="blocked-ELL row tile (also read by --layout auto)")
    ap.add_argument("--bn", type=int, default=128,
                    help="blocked-ELL col tile (also read by --layout auto)")
    ap.add_argument("--history", action="store_true",
                    help="also print the residual-norm history as JSON")
    ap.add_argument("--summary", action="store_true",
                    help="also print {iterations, converged, final_rnorm}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _not_ported(what: str) -> int:
    print(f"error: {what} is not yet ported to conjugategradient_tpu_torch",
          file=sys.stderr)
    return 2


def _stencil_dims(args):
    """The grid of a ``stencil:<nx>[x<ny>x<nz>]`` input, or None after
    printing why it is refused (the JAX tester's parsing and messages)."""
    if args.layout != "csr" or args.reorder:
        print("error: stencil: input is matrix-free (no --layout/--reorder)",
              file=sys.stderr)
        return None
    try:
        dims = tuple(int(t) for t in args.mtx[len("stencil:"):].split("x"))
        if len(dims) == 1:
            dims = dims * 3
        if len(dims) != 3 or min(dims) < 2:
            raise ValueError(args.mtx)
    except ValueError:
        print(f"error: cannot parse {args.mtx!r} (want stencil:<nx>[x<ny>x<nz>])",
              file=sys.stderr)
        return None
    return dims


def main(argv=None) -> int:
    args, unknown = _parser().parse_known_args(argv)
    if unknown:
        return _not_ported(" ".join(unknown))
    for flag, value, ported in (("--layout", args.layout, _LAYOUTS),
                                ("--dtype", args.dtype, _DTYPES),
                                ("--precond", args.precond, _PRECONDS),
                                ("--method", args.method, _METHODS)):
        if value not in ported:
            return _not_ported(f"{flag} {value}")

    import torch

    from . import (CGInfo, StencilOperator, accuracy, cg_solve, jacobi_preconditioner,
                   load_matrix, minres_solve, multigrid_preconditioner)
    from .utils import Timer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(use --device cpu)", file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    if args.recompute < 0:
        print("error: --recompute must be >= 0", file=sys.stderr)
        return 2
    if args.shift and args.method != "minres":
        print("error: --shift drives --method minres (the Paige-Saunders "
              "shifted solve)", file=sys.stderr)
        return 2
    if args.recompute > 0 and args.method != "standard":
        print("error: --recompute drives the standard or pipelined "
              "single-RHS loop", file=sys.stderr)
        return 2
    perm = None
    if args.mtx.startswith("stencil:"):
        dims = _stencil_dims(args)
        if dims is None:
            return 2
        A = StencilOperator.poisson(dims, dtype=dtype, device=device)
    else:
        if args.precond == "amg":
            return _not_ported("--precond amg on a matrix file (smoothed-aggregation AMG)")
        try:
            A = load_matrix(args.mtx, layout=args.layout, dtype=np.dtype(args.dtype),
                            bm=args.bm, bn=args.bn, reorder=args.reorder,
                            device=device)
            if args.reorder:
                A, perm = A
        except OSError as e:
            print(f"error: cannot read {args.mtx}: {e}", file=sys.stderr)
            return 2
        except (ValueError, NotImplementedError) as e:
            print(f"error: cannot parse {args.mtx}: {e}", file=sys.stderr)
            return 2
    n, nnz = A.shape[0], A.nnz

    b = torch.arange(1, n + 1, dtype=dtype, device=device)
    if perm is not None:
        b = b[torch.from_numpy(perm).to(device)]
    if args.precond == "jacobi":
        M = jacobi_preconditioner(A)
    elif args.precond == "amg":
        M = multigrid_preconditioner(A, smoother=args.smoother)
    else:
        M = None

    def solve():
        if args.method == "minres":
            x, ninfo = minres_solve(A, b, tol=args.tol, maxiter=args.maxiter, M=M,
                                    shift=args.shift)
            # the printing below reads a CGInfo, whose history holds squared
            # norms; MINRES carries norm estimates
            sq = ninfo.rnorm * ninfo.rnorm
            return x, CGInfo(iterations=ninfo.iterations, converged=ninfo.converged,
                             rho=sq, rnorm_sq=sq,
                             rho_history=ninfo.rnorm_history * ninfo.rnorm_history)
        return cg_solve(A, b, tol=args.tol, maxiter=args.maxiter, M=M,
                        recompute_r_every=args.recompute)

    solve()  # warm-up: kernel build and first-launch costs stay untimed
    t = Timer(device).start_measure()
    x, info = solve()
    t.stop_measure()

    # with --reorder the solve runs in RCM ordering; the printed metrics are
    # permutation-invariant, so x is not mapped back
    if args.shift:
        # the shifted solve's operator is A − σI: rel_error must use it
        res = b - (A.matvec(x) - args.shift * x)
        rel_err = float(torch.abs(torch.sum(res * res) / torch.sum(x * x)))
    else:
        rel_err = float(accuracy(A, b, x))
    print(f"{n} {nnz} {t.get_duration()} {rel_err}")
    hist_all = info.rho_history.double().cpu().numpy()
    k = int(info.iterations)
    conv = bool(info.converged)
    if args.summary:
        print(json.dumps({
            "iterations": [k],
            "converged": [conv],
            "final_rnorm": [float(np.sqrt(abs(float(info.rnorm_sq))))],
        }))
    if args.history:
        hist = np.sqrt(hist_all[: k + 1])
        print(json.dumps({
            "iterations": k,
            "converged": conv,
            # NaN entries (breakdown iterations) are not valid JSON -> null
            "residual_norms": [None if not np.isfinite(v) else float(v)
                               for v in hist],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
