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
exits non-zero without one.  ``--method
pipelined|sstep|minres|bicgstab|gmres|block`` (``--sstep-s``, ``--shift``,
``--restart``), ``--nrhs R`` (lane j solves roll(b, j): the
lockstep multi-RHS loops, block CG with ``--method block``; the line
reports lane 0 and the wall for all lanes, then a per-lane JSON line),
``--precond jacobi|blockjacobi|chebyshev|amg|fsai`` (``--block-size``,
``--cheb-degree``, ``--smoother``, ``--fsai-power``; amg is
smoothed-aggregation AMG on a ``--layout csr`` matrix and the geometric
V-cycle on a stencil), ``--layout``, ``--reorder``,
``--recompute N``, ``--progress N``, ``--estimate-steps``, ``--history``,
``--summary`` and ``--verbose`` behave as in the JAX harness.  ``--deflate K``
(``--deflate-m M``) harvests a deflation basis from a plain-CG pass outside
the timed region, then times the deflated solve; ``--eigs K``
(``--eigs-method lobpcg|lanczos``, ``--eigs-which``, ``--eigs-iters``,
``--eigs-tol``) computes K extreme eigenpairs instead of solving and prints
``dim NNZ time_ms max_rel_residual`` and a JSON line.  ``--refine
bfloat16|float32`` solves with mixed-precision iterative refinement (inner
CG on a copy of the operator stored in that dtype, true residuals in
``--dtype``), and ``--dtype bfloat16`` solves in bfloat16 (on ``--device
cuda`` each bf16 product that has a kernel runs its bf16 form, the
stencil's included).
Flags of the JAX harness that this package has not ported yet exit with
code 2 and "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_LAYOUTS = ("auto", "csr", "sell", "bell", "symbell", "dia", "symdia")
_DTYPES = ("float32", "float64", "bfloat16")
_PRECONDS = ("none", "jacobi", "blockjacobi", "chebyshev", "amg", "fsai")
_METHODS = ("standard", "pipelined", "sstep", "block", "minres", "bicgstab", "gmres")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("mtx", help="MatrixMarket .mtx file (SPD; general with "
                    "--method bicgstab), or the matrix-free "
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
                         "iterations (0: never; standard and pipelined "
                         "methods, the pipelined recurrences drift faster)")
    ap.add_argument("--dtype", default="float64",
                    help="float32, float64 (the reference's double) or bfloat16")
    ap.add_argument("--precond", default="none",
                    help="none, jacobi, blockjacobi (--block-size), chebyshev "
                         "(--cheb-degree; interval from a Lanczos estimate), "
                         "amg (smoothed-aggregation AMG on --layout csr "
                         "inputs, the geometric V-cycle on stencil: inputs), "
                         "or fsai (factorized sparse approximate inverse: "
                         "apply = two SpMVs; --layout csr inputs)")
    ap.add_argument("--block-size", type=int, default=8, dest="block_size",
                    help="diagonal-block size (with --precond blockjacobi)")
    ap.add_argument("--cheb-degree", type=int, default=8,
                    help="Chebyshev polynomial degree (with --precond chebyshev)")
    ap.add_argument("--fsai-power", type=int, default=1, dest="fsai_power",
                    help="FSAI pattern power: G's sparsity = "
                         "tril(pattern(|A|^power)) (with --precond fsai)")
    ap.add_argument("--smoother", choices=("jacobi", "chebyshev"), default="jacobi",
                    help="multigrid smoother (with --precond amg): nu "
                         "damped-Jacobi sweeps or the degree-nu Chebyshev "
                         "semi-iteration")
    ap.add_argument("--method", default="standard",
                    help="standard = CG; pipelined = single-synchronization "
                         "CG (one pass of dots per iteration; Chronopoulos-Gear, "
                         "or Ghysels-Vanroose with --precond); sstep = s-step CG "
                         "(one Gram reduction per --sstep-s iterations; "
                         "unpreconditioned); minres = Paige-Saunders MINRES for "
                         "symmetric INDEFINITE systems (monotone residual "
                         "norms; takes an SPD --precond; float32 blocked "
                         "layouts run fused CUDA kernels on a GPU); bicgstab "
                         "= van der Vorst BiCGStab for NONSYMMETRIC systems "
                         "(general .mtx inputs; 2 SpMVs/iteration; takes "
                         "--precond; the portable loop); gmres = restarted "
                         "GMRES(m) for NONSYMMETRIC systems (--restart sets m; "
                         "right --precond); block = block CG (with --nrhs R: one "
                         "shared Krylov space, fewer iterations per lane than "
                         "the lockstep loop)")
    ap.add_argument("--restart", type=int, default=30,
                    help="GMRES restart length m (with --method gmres): the "
                         "(m+1, n) Krylov basis held on the device")
    ap.add_argument("--sstep-s", type=int, default=4, dest="sstep_s",
                    help="s-step block size (with --method sstep; the "
                         "monomial basis conditions like kappa(A)^s: 2..4 is "
                         "the usable range)")
    ap.add_argument("--shift", type=float, default=0.0,
                    help="solve (A - shift*I) x = b (with --method minres: "
                         "the Paige-Saunders spectral shift)")
    ap.add_argument("--refine", choices=("off", "bfloat16", "float32"), default="off",
                    help="mixed-precision iterative refinement: store a "
                         "low-precision copy of the operator for the inner "
                         "CG solves and correct with --dtype true residuals "
                         "(Carson-Higham CG-IR; single-RHS standard method)")
    ap.add_argument("--bm", type=int, default=128,
                    help="blocked-ELL row tile (also read by --layout auto)")
    ap.add_argument("--bn", type=int, default=128,
                    help="blocked-ELL col tile (also read by --layout auto)")
    ap.add_argument("--deflate", type=int, default=0, metavar="K",
                    help="deflate the K lowest Ritz modes: harvests the basis "
                         "from a plain-CG pass on this system "
                         "(solver/deflated.py, the recycling workflow) outside "
                         "the timed region, then times the deflated solve")
    ap.add_argument("--deflate-m", type=int, default=None, dest="deflate_m", metavar="M",
                    help="harvest-pass length (default max(4K, 2K+20)); basis "
                         "quality, and the deflation payoff, improves with M "
                         "(basis_quality diagnostics under --verbose)")
    ap.add_argument("--eigs", type=int, default=0, metavar="K",
                    help="eigensolver mode: instead of solving Ax=b, compute the "
                         "K extreme eigenpairs of the loaded operator and print "
                         "the 4-column line as 'dim NNZ time_ms "
                         "max_rel_residual' plus one JSON line with the "
                         "eigenvalues (lobpcg takes --precond as the "
                         "eigensolver preconditioner)")
    ap.add_argument("--eigs-method", choices=("lobpcg", "lanczos"), default="lobpcg",
                    dest="eigs_method",
                    help="lobpcg = preconditioned block iteration (pairs with "
                         "--precond); lanczos = one unpreconditioned Krylov pass "
                         "(--eigs-iters SpMVs)")
    ap.add_argument("--eigs-which", choices=("smallest", "largest"), default="smallest",
                    dest="eigs_which", help="which end of the spectrum to converge")
    ap.add_argument("--eigs-iters", type=int, default=None, dest="eigs_iters",
                    help="iteration budget: LOBPCG maxiter (default 100) or "
                         "Lanczos Krylov dimension (default max(2K, K+10))")
    ap.add_argument("--eigs-tol", type=float, default=None, dest="eigs_tol",
                    help="relative residual tolerance for the eigensolver "
                         "(||A x - lambda x|| <= tol*|lambda|; default: the "
                         "solver's own).  --tol is the linear-solve tolerance "
                         "and does not apply here")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="solve this many right-hand sides at once (lane j "
                         "gets roll(b, j)) via the lockstep multi-RHS loop; "
                         "the 4-column line reports lane 0 and the wall for "
                         "all lanes, plus a per-lane JSON line")
    ap.add_argument("--history", action="store_true",
                    help="also print the residual-norm history as JSON")
    ap.add_argument("--summary", action="store_true",
                    help="also print {iterations, converged, final_rnorm}")
    ap.add_argument("--progress", type=int, default=0, metavar="N",
                    help="log k and ||r_k|| every N iterations (the reference's "
                         "progress trace, CG.hpp:428-434), driving the solve in "
                         "run_cg chunks: one host read per chunk")
    ap.add_argument("--estimate-steps", action="store_true", dest="estimate_steps",
                    help="print the predicted CG iteration count before solving "
                         "(Lanczos condition-number bound, CG.hpp:235)")
    ap.add_argument("--verbose", action="store_true")
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


def _eigs_lane(args, A, M, n, nnz, device) -> int:
    """``--eigs K``: K extreme eigenpairs of the loaded operator, timed
    after one untimed warm-up run; the JAX tester's refusals and lines."""
    from . import lanczos_eigs, lobpcg_eigs
    from .utils import Timer

    if (args.method != "standard" or args.nrhs > 1 or args.deflate > 0
            or args.refine != "off" or args.progress > 0 or args.recompute > 0):
        print("error: --eigs is an eigensolver lane (no --method/--nrhs/"
              "--deflate/--refine/--progress/--recompute)", file=sys.stderr)
        return 2
    if args.eigs_method == "lanczos":
        if M is not None:
            print("error: --eigs-method lanczos is unpreconditioned "
                  "(drop --precond or use --eigs-method lobpcg)", file=sys.stderr)
            return 2
        if args.history:
            print("error: --history needs --eigs-method lobpcg (the "
                  "Lanczos pass is one dispatch, no per-iteration "
                  "trace)", file=sys.stderr)
            return 2

        def run_eigs():
            kw = {} if args.eigs_tol is None else {"rtol": args.eigs_tol}
            return lanczos_eigs(A, k=args.eigs, which=args.eigs_which,
                                iters=args.eigs_iters, **kw), None
    else:
        def run_eigs():
            kw = {} if args.eigs_tol is None else {"tol": args.eigs_tol}
            out = lobpcg_eigs(A, k=args.eigs, M=M, which=args.eigs_which,
                              maxiter=100 if args.eigs_iters is None else args.eigs_iters,
                              return_history=args.history, **kw)
            return (out[0], out[1:]) if args.history else (out, None)

    run_eigs()  # warm-up: kernel build and first-launch costs stay untimed
    t = Timer(device).start_measure()
    res, hists = run_eigs()
    t.stop_measure()
    vals = np.asarray(res.values, dtype=np.float64)
    resid = np.asarray(res.residuals, dtype=np.float64)
    scale = max(float(np.abs(vals).max()), 1e-300)
    print(f"{n} {nnz} {t.get_duration()} {float(resid.max()) / scale}")
    print(json.dumps({
        "eigenvalues": [float(v) for v in vals],
        "residuals": [float(v) for v in resid],
        "converged": [bool(v) for v in np.asarray(res.converged)],
        "iterations": int(res.iters),
        "which": args.eigs_which,
        "method": args.eigs_method,
    }))
    if hists is not None:
        lam_h, rn_h = hists
        upto = int(res.iters) + 1
        print(json.dumps({
            "eigenvalue_history": np.asarray(lam_h, np.float64)[:upto].tolist(),
            "residual_history": np.asarray(rn_h, np.float64)[:upto].tolist(),
        }))
    return 0


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

    from . import (CGInfo, CSRMatrix, StencilOperator, accuracy, bicgstab_solve,
                   bicgstab_solve_batched, block_cg_solve, cg_init, cg_solve, cg_solve_batched,
                   deflated_cg_solve, expected_step_count,
                   gmres_solve, gmres_solve_batched, harvest_deflation_basis,
                   jacobi_preconditioner, load_matrix,
                   minres_solve, minres_solve_batched, multigrid_preconditioner,
                   refined_cg_solve, smoothed_aggregation_preconditioner, sstep_cg_solve)
    from .ops.spmv import full_precision_matmul
    from .solver import (basis_quality, block_jacobi_preconditioner, chebyshev_preconditioner,
                         estimate_spectral_bounds, fsai_preconditioner, pipelined_cg_solve,
                         run_cg)
    from .utils import Timer, get_logger, set_verbosity

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(use --device cpu)", file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    if args.recompute < 0:
        print("error: --recompute must be >= 0", file=sys.stderr)
        return 2
    set_verbosity("verbose" if args.verbose else "info")
    log = get_logger()
    perm = None
    if args.mtx.startswith("stencil:"):
        dims = _stencil_dims(args)
        if dims is None:
            return 2
        A = StencilOperator.poisson(dims, dtype=dtype, device=device)
    else:
        try:
            A = load_matrix(args.mtx, layout=args.layout, dtype=dtype,
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
    if args.verbose:
        log.debug("loaded %s: n=%d nnz=%d layout=%s reorder=%s",
                  args.mtx, n, nnz, type(A).__name__, args.reorder)

    # b_i = i + 1 as jnp.arange(1, n + 1, dtype=dtype) forms it: i rounded
    # to the solve dtype, then 1 added in it (in bfloat16 that rounds twice:
    # 258 becomes 256; exact in float32 and float64 below 2**24)
    b = torch.arange(n, dtype=torch.float64, device=device).to(dtype) + 1
    if perm is not None:
        b = b[torch.from_numpy(perm).to(device)]
    if args.precond == "jacobi":
        M = jacobi_preconditioner(A)
    elif args.precond == "blockjacobi":
        M = block_jacobi_preconditioner(A, block_size=args.block_size)
    elif args.precond == "chebyshev":
        try:
            lmin, lmax = estimate_spectral_bounds(A)
            if args.verbose:
                log.debug("chebyshev interval [%g, %g]", lmin, lmax)
            M = chebyshev_preconditioner(A, lmin, lmax, degree=args.cheb_degree)
        except ValueError as e:
            print(f"error: chebyshev setup failed: {e}", file=sys.stderr)
            return 2
    elif args.precond == "fsai":
        if not isinstance(A, CSRMatrix):
            print("error: --precond fsai needs --layout csr (the FSAI setup "
                  "mines A's CSR pattern)", file=sys.stderr)
            return 2
        M = fsai_preconditioner(A, power=args.fsai_power)
    elif args.precond == "amg":
        if isinstance(A, StencilOperator):
            M = multigrid_preconditioner(A, smoother=args.smoother)
        elif isinstance(A, CSRMatrix):
            M = smoothed_aggregation_preconditioner(A, smoother=args.smoother)
        else:
            print("error: --precond amg needs --layout csr (the AMG setup "
                  "reads the CSR graph) or a stencil: input", file=sys.stderr)
            return 2
    else:
        M = None

    if args.estimate_steps:
        bnorm = float(torch.linalg.vector_norm(b))
        eps = min(max(args.tol / max(bnorm, 1e-300), 1e-16), 0.5)
        try:
            k_est = expected_step_count(A, eps)
            print(f"expected_steps {k_est} (eps={eps:.3g})")
        except ValueError as e:
            print(f"expected_steps unavailable: {e}", file=sys.stderr)

    if args.eigs > 0:
        return _eigs_lane(args, A, M, n, nnz, device)

    if args.progress > 0 and (args.nrhs > 1 or args.method != "standard"):
        print("error: --progress drives the standard single-RHS loop "
              "(no --nrhs/--method pipelined)", file=sys.stderr)
        return 2
    if args.shift and args.method != "minres":
        print("error: --shift drives --method minres (the Paige-Saunders "
              "shifted solve)", file=sys.stderr)
        return 2
    if args.recompute > 0 and (args.method not in ("standard", "pipelined")
                               or args.nrhs > 1 or args.refine != "off" or args.deflate > 0
                               or args.progress > 0):
        print("error: --recompute drives the standard or pipelined "
              "single-RHS loop", file=sys.stderr)
        return 2
    if args.refine != "off" and (args.method != "standard" or args.progress > 0):
        print("error: --refine drives the standard loop (no --method/"
              "--progress)", file=sys.stderr)
        return 2
    if args.deflate > 0 and (args.method != "standard" or args.nrhs > 1
                             or args.refine != "off" or args.progress > 0):
        print("error: --deflate drives the standard single-RHS loop "
              "(no --method/--nrhs/--refine/--progress)", file=sys.stderr)
        return 2
    if args.method in ("pipelined", "sstep"):
        if M is not None and args.method == "sstep":
            print("error: --method sstep is unpreconditioned", file=sys.stderr)
            return 2
        if args.nrhs > 1:
            print("error: --nrhs > 1 uses the lockstep loop, not --method "
                  f"{args.method}", file=sys.stderr)
            return 2
    if args.refine != "off":
        if args.nrhs > 1:
            print("error: --refine drives the single-RHS standard loop "
                  "(no --nrhs)", file=sys.stderr)
            return 2
        low = getattr(torch, args.refine)
        if torch.empty((), dtype=low).element_size() >= torch.empty((), dtype=dtype).element_size():
            print(f"error: --refine {args.refine} is not below --dtype "
                  f"{args.dtype}; pick a lower storage dtype", file=sys.stderr)
            return 2
    basis = None
    if args.deflate > 0:
        # the basis is set-up, harvested from a plain-CG pass on this system
        # outside the timed region: the recycling workflow, where a prior
        # solve has already paid for it
        basis = harvest_deflation_basis(A, b, k=args.deflate, m=args.deflate_m)
        if args.verbose:
            q = basis_quality(A, basis).double().cpu().numpy()
            log.debug("deflation basis k=%d max Ritz residual %.3g", basis.k, float(q.max()))

    cap = args.maxiter if args.maxiter is not None else n + 1
    progress_quiet = [True]  # the warm-up solve logs nothing

    def progress_solve():
        # run_cg chunks of --progress steps: one host read per chunk (the
        # reference's progress trace on the checkpointable carry)
        full_precision_matmul()
        state = cg_init(A, b, M=M, maxiter=cap)
        while True:
            state = run_cg(A, state, args.tol, steps=args.progress, M=M)
            k = int(state.k)
            if not progress_quiet[0]:
                log.info("iter %d  ||r|| = %.6e", k, float(torch.sqrt(state.rnorm_sq)))
            if bool(state.done) or k >= cap:
                break
        return state.x, CGInfo(iterations=state.k,
                               converged=state.done & ~torch.isnan(state.rnorm_sq),
                               rho=state.rho, rnorm_sq=state.rnorm_sq,
                               rho_history=state.hist)

    # lane j solves against roll(b, j): the same norm on every lane (one
    # shared absolute tol stays fair), R distinct systems; --method block
    # builds its block the same way, so the two methods' counts compare
    B = (torch.stack([torch.roll(b, j) for j in range(args.nrhs)])
         if args.nrhs > 1 or args.method == "block" else None)
    solvers = {"minres": (minres_solve, minres_solve_batched,
                          {"shift": args.shift} if args.shift else {}),
               "gmres": (gmres_solve, gmres_solve_batched, {"restart": args.restart}),
               "bicgstab": (bicgstab_solve, bicgstab_solve_batched, {})}

    def refine_solve():
        x, rinfo = refined_cg_solve(A, b, tol=args.tol, low_dtype=getattr(torch, args.refine),
                                    inner_maxiter=args.maxiter, M=M)
        # the CGInfo the printing reads: iterations = the inner work, the
        # history = the outer true-residual trace (the JAX tester's adaptation)
        rn = torch.tensor(rinfo.rnorm_sq, dtype=torch.float64)
        if args.verbose:
            log.debug("refinements=%d inner_iterations=%d",
                      rinfo.refinements, rinfo.inner_iterations)
        return x, CGInfo(iterations=torch.tensor(rinfo.inner_iterations, dtype=torch.int32),
                         converged=torch.tensor(rinfo.converged), rho=rn, rnorm_sq=rn,
                         rho_history=torch.tensor(rinfo.rnorm_history, dtype=torch.float64))

    def solve():
        if args.method in solvers:
            solo, batched, extra = solvers[args.method]
            if args.nrhs > 1:
                X, ninfo = batched(A, B, tol=args.tol, maxiter=args.maxiter, M=M, **extra)
                x = X[0]
            else:
                x, ninfo = solo(A, b, tol=args.tol, maxiter=args.maxiter, M=M, **extra)
            # the printing below reads a CGInfo, whose history holds squared
            # norms; MINRES, BiCGStab and GMRES carry norms
            sq = ninfo.rnorm * ninfo.rnorm
            return x, CGInfo(iterations=ninfo.iterations, converged=ninfo.converged,
                             rho=sq, rnorm_sq=sq,
                             rho_history=ninfo.rnorm_history * ninfo.rnorm_history)
        if args.method == "sstep":
            return sstep_cg_solve(A, b, s=args.sstep_s, tol=args.tol, maxiter=args.maxiter)
        if args.method == "pipelined":
            return pipelined_cg_solve(A, b, tol=args.tol, maxiter=args.maxiter, M=M,
                                      recompute_r_every=args.recompute)
        if args.progress > 0:
            return progress_solve()
        if args.method == "block":
            X, info = block_cg_solve(A, B, tol=args.tol, maxiter=args.maxiter, M=M)
            return X[0], info
        if args.refine != "off":
            return refine_solve()
        if args.nrhs > 1:
            X, info = cg_solve_batched(A, B, tol=args.tol, maxiter=args.maxiter, M=M)
            return X[0], info
        if basis is not None:
            return deflated_cg_solve(A, b, basis, tol=args.tol, maxiter=args.maxiter, M=M)
        return cg_solve(A, b, tol=args.tol, maxiter=args.maxiter, M=M,
                        recompute_r_every=args.recompute)

    solve()  # warm-up: kernel build and first-launch costs stay untimed
    progress_quiet[0] = False
    t = Timer(device).start_measure()
    x, info = solve()
    t.stop_measure()

    # with --reorder the solve runs in RCM ordering; the printed metrics are
    # permutation-invariant, so x is not mapped back.  With --nrhs the line
    # reports lane 0 (whose right-hand side is the reference's b) and the
    # wall covers all lanes; the JSON line below carries each lane
    if args.shift:
        # the shifted solve's operator is A − σI: rel_error must use it
        res = b - (A.matvec(x) - args.shift * x)
        rel_err = float(torch.abs(torch.sum(res * res) / torch.sum(x * x)))
    else:
        rel_err = float(accuracy(A, b, x))
    print(f"{n} {nnz} {t.get_duration()} {rel_err}")
    iters = info.iterations.cpu().numpy().reshape(-1)
    convs = info.converged.cpu().numpy().reshape(-1)
    if args.nrhs > 1:
        print(json.dumps({
            "nrhs": args.nrhs,
            "iterations": [int(v) for v in iters],
            "converged": [bool(v) for v in convs],
            "per_rhs_ms": t.get_duration() / args.nrhs,
        }))
    if args.summary:
        rns = np.sqrt(np.abs(info.rnorm_sq.double().cpu().numpy().reshape(-1)))
        print(json.dumps({
            "iterations": [int(v) for v in iters],
            "converged": [bool(v) for v in convs],
            "final_rnorm": [float(v) for v in rns],
        }))
    if args.history:
        # with --nrhs or --method block (histories (R, maxiter+1)): lane 0
        hist_all = info.rho_history.double().cpu().numpy()
        if args.refine != "off":
            # the inner work beside the OUTER true-residual trace (one entry
            # a refinement): labelled for what it is, as the JAX tester does
            print(json.dumps({
                "inner_iterations": int(iters[0]),
                "converged": bool(convs[0]),
                "outer_residual_norms": [float(v) for v in
                                         np.sqrt(hist_all[np.isfinite(hist_all)])],
            }))
            return 0
        hist_all = hist_all[0] if hist_all.ndim == 2 else hist_all
        k, conv = int(iters[0]), bool(convs[0])
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
