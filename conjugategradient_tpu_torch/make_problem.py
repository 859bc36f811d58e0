"""Generate SPD (and, for ``convdiff``, nonsymmetric) MatrixMarket
problems for the harness and benchmarks, with the port's own generators
(``problems.py``) and writer (``io.write_mtx``): the same files, byte for
byte, as the repository's ``tools/make_problem.py`` writes with the JAX
package's.

  cgtorch-make-problem poisson2d --nx 64 -o problems/poisson2d_64.mtx
  python -m conjugategradient_tpu_torch.make_problem banded --n 1138 --bandwidth 6 -o banded.mtx
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .io.mtx import write_mtx
from .problems import (banded_spd_coo, bcsstk17_profile_coo, circuit_spd_coo,
                       convection_diffusion_2d_coo, elasticity3d_coo, poisson2d_coo,
                       powerlaw_spd_coo, random_spd_dense)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "kind",
        choices=(
            "poisson2d",
            "poisson3d",
            "banded",
            "dense",
            "powerlaw",
            "elasticity3d",
            "bcsstk17",
            "circuit",
            "convdiff",
        ),
    )
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--nz", type=int, default=None)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--bandwidth", type=int, default=6)
    ap.add_argument("--avg-degree", type=float, default=None,
                    help="target avg nnz/row (default: 3.5 powerlaw = "
                         "1138_bus profile, 4.83 circuit = G3_circuit)")
    ap.add_argument("--peclet", type=float, default=10.0,
                    help="convection strength for convdiff (0 = symmetric "
                         "Poisson limit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)

    if args.kind == "poisson2d":
        rows, cols, vals, shape = poisson2d_coo(args.nx, args.ny)
        comment = f"2-D 5-point Poisson, {args.nx}x{args.ny or args.nx}"
    elif args.kind == "poisson3d":
        from .ops.stencil import poisson7_csr

        nx = args.nx
        ny = args.ny or nx
        nz = args.nz or nx
        csr = poisson7_csr((nx, ny, nz), device="cpu")
        rows = np.repeat(
            np.arange(csr.shape[0]), np.diff(csr.indptr.numpy())
        )
        cols = csr.indices.numpy()
        vals = csr.data.numpy()
        shape = csr.shape
        comment = f"3-D 7-point Poisson, {nx}x{ny}x{nz}"
    elif args.kind == "banded":
        rows, cols, vals, shape = banded_spd_coo(
            args.n, bandwidth=args.bandwidth, seed=args.seed
        )
        comment = f"random banded SPD, n={args.n} bw={args.bandwidth} seed={args.seed}"
    elif args.kind == "powerlaw":
        if args.avg_degree is None:
            args.avg_degree = 3.5  # 1138_bus calibration
        rows, cols, vals, shape = powerlaw_spd_coo(
            args.n, avg_degree=args.avg_degree, seed=args.seed
        )
        comment = (
            f"scattered power-law SPD (bus-network profile), n={args.n} "
            f"avg_degree={args.avg_degree} seed={args.seed}"
        )
    elif args.kind == "circuit":
        if args.avg_degree is None:
            args.avg_degree = 4.83  # G3_circuit calibration
        rows, cols, vals, shape = circuit_spd_coo(
            args.n, avg_degree=args.avg_degree, seed=args.seed
        )
        comment = (
            f"circuit conductance SPD (G3_circuit profile: grid-local wires "
            f"+ scattered nets, narrow degree distribution), n={args.n} "
            f"avg_degree={args.avg_degree} seed={args.seed}"
        )
    elif args.kind == "elasticity3d":
        rows, cols, vals, shape = elasticity3d_coo(
            args.nx, args.ny, args.nz, seed=args.seed
        )
        comment = (
            f"3-D block stiffness (bcsstk-class, 3 dof/node, 27-pt), "
            f"{args.nx}x{args.ny or args.nx}x{args.nz or args.nx} seed={args.seed}"
        )
    elif args.kind == "bcsstk17":
        rows, cols, vals, shape = bcsstk17_profile_coo(seed=args.seed)
        comment = (
            "elasticity stand-in calibrated to bcsstk17's published "
            "profile: n=10974 (3 dof x 59x31x2 shell), nnz~428650 "
            f"seed={args.seed}"
        )
    elif args.kind == "convdiff":
        rows, cols, vals, shape = convection_diffusion_2d_coo(
            args.nx, args.ny, peclet=args.peclet
        )
        comment = (
            f"2-D upwind convection-diffusion (NONSYMMETRIC, bicgstab "
            f"lane), {args.nx}x{args.ny or args.nx} peclet={args.peclet}"
        )
    else:  # dense
        a = random_spd_dense(args.n, seed=args.seed)
        rows, cols = np.nonzero(a)
        vals = a[rows, cols]
        shape = a.shape
        comment = f"dense random SPD, n={args.n} seed={args.seed}"

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_mtx(args.out, rows, cols, vals, shape,
              symmetric=args.kind != "convdiff", comment=comment)
    if args.kind == "convdiff":
        print(f"wrote {args.out}: n={shape[0]} "
              f"nnz(stored,general)={len(np.asarray(vals))}")
    else:
        nnz_lower = int(np.sum(np.asarray(rows) >= np.asarray(cols)))
        print(f"wrote {args.out}: n={shape[0]} nnz(stored,lower)={nnz_lower}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
