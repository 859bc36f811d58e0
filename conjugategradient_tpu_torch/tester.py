"""End-to-end harness of the port — the reference's ``tester`` protocol
(test/Tester.cpp:12-57), as the JAX package's ``tester.py`` runs it:

* load the MatrixMarket matrix (symmetric storage expanded);
* b[i] = i + 1 (with ``--reorder``, permuted as the matrix is: b[perm]);
* solve with absolute tolerance ``--tol`` (default 1e-24: run to the cap),
  after one untimed warm-up solve (which also builds the CUDA kernels);
* print ``dim NNZ time_ms rel_error`` with rel_error = |Σ(b−Ax)²/Σx²|.

Usage: ``python -m conjugategradient_tpu_torch.tester <file.mtx> [options]``
(or ``cgtorch-tester``).  ``--device cuda`` (the default) needs a GPU and
exits non-zero without one.  Flags of the JAX harness that this package has
not ported yet exit with code 2 and "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_LAYOUTS = ("csr", "bell", "symbell")
_DTYPES = ("float32", "float64")
_PRECONDS = ("none", "jacobi")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("mtx", help="MatrixMarket .mtx file (SPD)")
    ap.add_argument("--tol", type=float, default=1e-24,
                    help="absolute tolerance on ||r||2 (reference: 1e-24)")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="iteration cap (reference: N+1)")
    ap.add_argument("--layout", default="csr",
                    help="csr, bell = full blocked-ELL, or symbell = "
                         "symmetric blocked-ELL (both blocked layouts run "
                         "fused CUDA kernels for float32 on a GPU)")
    ap.add_argument("--reorder", action="store_true",
                    help="RCM-reorder the system first (bandwidth reduction; "
                         "the printed metrics are permutation-invariant)")
    ap.add_argument("--recompute", type=int, default=0, metavar="N",
                    help="residual-replacement full restart every N "
                         "iterations (0: never)")
    ap.add_argument("--dtype", default="float64", help="float32 or float64")
    ap.add_argument("--precond", default="none", help="none or jacobi")
    ap.add_argument("--bm", type=int, default=128, help="blocked-ELL row tile")
    ap.add_argument("--bn", type=int, default=128, help="blocked-ELL col tile")
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


def main(argv=None) -> int:
    args, unknown = _parser().parse_known_args(argv)
    if unknown:
        return _not_ported(" ".join(unknown))
    for flag, value, ported in (("--layout", args.layout, _LAYOUTS),
                                ("--dtype", args.dtype, _DTYPES),
                                ("--precond", args.precond, _PRECONDS)):
        if value not in ported:
            return _not_ported(f"{flag} {value}")

    import torch

    from . import accuracy, cg_solve, jacobi_preconditioner, load_matrix
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
    perm = None
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
    M = jacobi_preconditioner(A) if args.precond == "jacobi" else None

    def solve():
        return cg_solve(A, b, tol=args.tol, maxiter=args.maxiter, M=M,
                        recompute_r_every=args.recompute)

    solve()  # warm-up: kernel build and first-launch costs stay untimed
    t = Timer(device).start_measure()
    x, info = solve()
    t.stop_measure()

    # with --reorder the solve runs in RCM ordering; the printed metrics are
    # permutation-invariant, so x is not mapped back
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
