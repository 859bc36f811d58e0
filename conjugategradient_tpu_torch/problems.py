"""SPD problem generators for tests and benchmarks.

The reference vendors no matrices (users supply SuiteSparse .mtx files,
test/Tester.cpp:14-21); with zero egress in this environment we generate
equivalent SPD problems deterministically instead, and tools/fetch_suitesparse.py
downloads the real ones when a network exists.
"""

from __future__ import annotations

import numpy as np


def poisson2d_coo(nx: int, ny: int = None):
    """5-point 2-D Poisson (Dirichlet) — the classic SPD test matrix."""
    ny = ny or nx
    n = nx * ny

    def idx(i, j):
        return i * ny + j

    rows, cols, vals = [], [], []
    for i in range(nx):
        for j in range(ny):
            r = idx(i, j)
            rows.append(r)
            cols.append(r)
            vals.append(4.0)
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < ny:
                    rows.append(r)
                    cols.append(idx(ii, jj))
                    vals.append(-1.0)
    return (
        np.array(rows, dtype=np.int64),
        np.array(cols, dtype=np.int64),
        np.array(vals, dtype=np.float64),
        (n, n),
    )


def poisson3d_coo(nx: int, ny: int = None, nz: int = None):
    """7-point 3-D Poisson (Dirichlet), fully vectorized — usable at the
    north-star scale (117³ ≈ 1.6M rows, ~11M nnz) where a Python triple loop
    would take minutes."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    ids = np.arange(n, dtype=np.int64)
    i, rem = np.divmod(ids, ny * nz)
    j, k = np.divmod(rem, nz)
    rows = [ids]
    cols = [ids]
    vals = [np.full(n, 6.0)]
    for axis, coord, extent, stride in (
        (0, i, nx, ny * nz),
        (1, j, ny, nz),
        (2, k, nz, 1),
    ):
        for sgn in (-1, 1):
            m = (coord + sgn >= 0) & (coord + sgn < extent)
            rows.append(ids[m])
            cols.append(ids[m] + sgn * stride)
            vals.append(np.full(int(m.sum()), -1.0))
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (n, n),
    )


def convection_diffusion_2d_coo(nx: int, ny: int = None, peclet: float = 10.0):
    """5-point upwind convection-diffusion — the standard NONSYMMETRIC test
    operator (for the BiCGStab lane; the SPD generators above cannot
    exercise it).

    Discretizes −Δu + β·∇u on the unit square (Dirichlet) with first-order
    upwinding of the constant convection field β = peclet·(1, 1)/h, scaled
    by h² like :func:`poisson2d_coo`.  Upwinding keeps the matrix an
    M-matrix (positive-definite though NOT symmetric) for every ``peclet``,
    so BiCGStab converges and the skew part grows with ``peclet`` — at 0 it
    degenerates to the symmetric Poisson operator.
    """
    ny = ny or nx
    n = nx * ny
    # grid spacing folded out: the operator is the h²-scaled stencil
    # (matching poisson2d_coo); bx,by are the per-cell upwind weights
    bx = by = float(peclet) / (nx + 1)
    ids = np.arange(n, dtype=np.int64)
    i, j = np.divmod(ids, ny)
    rows = [ids]
    cols = [ids]
    vals = [np.full(n, 4.0 + bx + by)]
    for mask, stride, coeff in (
        (i - 1 >= 0, -ny, -1.0 - bx),  # west: upwind side of the +x flow
        (i + 1 < nx, +ny, -1.0),       # east
        (j - 1 >= 0, -1, -1.0 - by),   # south: upwind side of the +y flow
        (j + 1 < ny, +1, -1.0),        # north
    ):
        rows.append(ids[mask])
        cols.append(ids[mask] + stride)
        vals.append(np.full(int(mask.sum()), coeff))
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (n, n),
    )


def random_spd_dense(n: int, seed: int = 0, cond: float = 100.0) -> np.ndarray:
    """Dense SPD with controlled condition number (for dense-CG config 1)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.geomspace(1.0, cond, n)
    return (q * eigs) @ q.T


def banded_spd_coo(n: int, bandwidth: int = 4, seed: int = 0):
    """Random banded diagonally-dominant SPD matrix (synthetic SuiteSparse
    stand-in; band structure keeps blocked-ELL padding low, like 1138_bus)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    offdiag = {}
    for i in range(n):
        for d in range(1, bandwidth + 1):
            j = i + d
            if j < n and rng.random() < 0.6:
                v = -rng.random()
                offdiag[(i, j)] = v
    for (i, j), v in offdiag.items():
        rows += [i, j]
        cols += [j, i]
        vals += [v, v]
    # diagonal dominance => SPD
    diag = np.full(n, 1.0)
    for (i, j), v in offdiag.items():
        diag[i] += abs(v)
        diag[j] += abs(v)
    rows += list(range(n))
    cols += list(range(n))
    vals += list(diag)
    return (
        np.array(rows, dtype=np.int64),
        np.array(cols, dtype=np.int64),
        np.array(vals, dtype=np.float64),
        (n, n),
    )


def powerlaw_spd_coo(
    n: int,
    avg_degree: float = 3.5,
    gamma: float = 2.5,
    seed: int = 0,
    shuffle: bool = True,
):
    """Scattered power-law SPD matrix — synthetic stand-in for irregular
    SuiteSparse problems (1138_bus-class bus networks, circuit matrices).

    The reference's real input distribution is user-supplied SuiteSparse
    matrices (test/Tester.cpp:14-21); with zero egress we generate the same
    *shape* of hardness instead: a Chung–Lu graph with expected degrees
    ``d_i ∝ i^(−1/(γ−1))`` (power-law tail with a few hub rows), vertex labels
    shuffled so the pattern is scattered — the worst case for banded/blocked
    layouts and the stress test for ``choose_layout``'s CSR fallback, RCM
    reordering, and the sharded all-gather path.

    1138_bus for calibration: n=1138, nnz≈4054 (avg degree ≈3.5), max degree
    ≈30 — the defaults reproduce that profile at any n.

    SPD by diagonal dominance: off-diagonals are −|w|, diagonal is
    1 + Σ|row|.  Returns (rows, cols, vals, shape) COO with both triangles.
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish weight per vertex; exponent −1/(γ−1) gives degree tail ~ γ
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (gamma - 1.0))
    p = w / w.sum()
    # draw enough endpoint pairs that, after dropping self-loops and
    # duplicates, ~ n*avg_degree/2 distinct undirected edges remain
    m_target = int(n * avg_degree / 2)
    draw = int(m_target * 1.6) + 16
    i = rng.choice(n, size=draw, p=p)
    j = rng.choice(n, size=draw, p=p)
    keep = i != j
    i, j = i[keep], j[keep]
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    edges = np.unique(lo.astype(np.int64) * n + hi.astype(np.int64))[:m_target]
    lo, hi = edges // n, edges % n
    if shuffle:
        perm = rng.permutation(n)
        lo, hi = perm[lo], perm[hi]
    vals_off = -(0.1 + rng.random(len(lo)))
    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    vals = np.concatenate([vals_off, vals_off])
    diag = np.ones(n, dtype=np.float64)
    np.add.at(diag, rows, np.abs(vals))
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vals, diag])
    return (
        rows.astype(np.int64),
        cols.astype(np.int64),
        vals.astype(np.float64),
        (n, n),
    )


def circuit_spd_coo(
    n: int,
    avg_degree: float = 4.83,
    seed: int = 0,
    ground_frac: float = 0.05,
):
    """Circuit-simulation conductance matrix — synthetic stand-in for
    G3_circuit (SuiteSparse AMD/G3_circuit: n=1,585,478, nnz=7,660,826,
    avg nnz/row ≈ 4.83, a circuit topology — NOT power-law: degrees are
    narrowly distributed, unlike the hub-heavy bus networks
    ``powerlaw_spd_coo`` models; round-2 VERDICT gap 1).

    Construction mirrors how a nodal-analysis G-matrix actually arises:
    nodes on a 2-D layout grid (circuits are placed in 2-D), resistive
    wires to the right/down neighbors (local routing, present with the
    probability that calibrates avg_degree), plus a small budget of
    longer-range wires with layout-local spans (vias/nets crossing a few
    rows).  Each wire of conductance g contributes the PSD stamp
    ``g·(e_i−e_j)(e_i−e_j)ᵀ``; a ``ground_frac`` fraction of nodes is tied
    to ground (adds g to the diagonal only) — the matrix is then SPD, an
    irreducibly diagonally-dominant M-matrix exactly like a real
    conductance matrix.  Conductances are lognormal (wire widths vary).

    Vectorized; usable at the G3_circuit scale (n≈1.59M builds in seconds).
    Returns (rows, cols, vals, shape) COO with both triangles, grid-local
    ordering (like the SuiteSparse file's native ordering: mostly banded
    with scattered longer-range entries).
    """
    rng = np.random.default_rng(seed)
    ny = max(int(round(np.sqrt(n))), 1)
    ids = np.arange(n, dtype=np.int64)

    # candidate local wires: right neighbor (same grid row), down neighbor
    i_row, j_col = np.divmod(ids, ny)
    right_ok = (j_col + 1 < ny) & (ids + 1 < n)
    down_ok = ids + ny < n
    cand_u = np.concatenate([ids[right_ok], ids[down_ok]])
    cand_v = np.concatenate([ids[right_ok] + 1, ids[down_ok] + ny])

    # edge budget: avg nnz/row = 1 (diag) + 2·edges/n  =>  edges target
    target_edges = int(round(n * (avg_degree - 1.0) / 2.0))
    # ~92% local wires, the rest longer spans (calibrates G3_circuit's
    # mostly-banded pattern with scattered off-band entries)
    n_local = min(int(target_edges * 0.92), len(cand_u))
    keep = rng.permutation(len(cand_u))[:n_local]
    lu, lv = cand_u[keep], cand_v[keep]

    n_far = max(target_edges - n_local, 0)
    if n_far:
        src = rng.integers(0, n, size=int(n_far * 1.3) + 8)
        # spans of 2..8 grid rows — nets crossing nearby placement rows,
        # not the global hops a power-law graph would draw
        span = rng.integers(2 * ny, 8 * ny, size=src.size)
        dst = src + span * rng.choice((-1, 1), size=src.size)
        ok = (dst >= 0) & (dst < n)
        fu, fv = src[ok][:n_far], dst[ok][:n_far]
    else:
        fu = fv = np.zeros((0,), np.int64)

    u = np.concatenate([lu, fu])
    v = np.concatenate([lv, fv])
    # dedup undirected pairs so the stamp sum matches the stored pattern
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    edges = np.unique(lo * np.int64(n) + hi)
    lo, hi = edges // n, edges % n
    g = np.exp(0.5 * rng.standard_normal(len(lo)))  # lognormal conductances

    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    vals = np.concatenate([-g, -g])
    diag = np.zeros(n, dtype=np.float64)
    np.add.at(diag, lo, g)
    np.add.at(diag, hi, g)
    # grounded nodes: diagonal-only conductance stamps keep A non-singular
    n_ground = max(int(n * ground_frac), 1)
    gnd = rng.choice(n, size=n_ground, replace=False)
    diag[gnd] += np.exp(0.5 * rng.standard_normal(n_ground))
    # every connected component needs a path to ground or its constant mode
    # is (near-)singular — x in that mode would be arbitrary even at tiny
    # residual.  Ground one node per component (real supply networks reach
    # every net); fall back to a uniform leak without scipy.
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        _, labels = connected_components(
            coo_matrix((np.ones(len(lo)), (lo, hi)), shape=(n, n)),
            directed=False,
        )
        order = np.argsort(labels, kind="stable")
        ncomp = int(labels.max()) + 1 if n else 0
        firsts = order[np.searchsorted(labels[order], np.arange(ncomp))]
        diag[firsts] += 1.0
    except ImportError:  # pragma: no cover
        diag += 1e-8
    rows = np.concatenate([rows, ids])
    cols = np.concatenate([cols, ids])
    vals = np.concatenate([vals, diag])
    return rows.astype(np.int64), cols.astype(np.int64), vals, (n, n)


def elasticity3d_coo(nx: int, ny: int = None, nz: int = None, seed: int = 0,
                     edge_keep: float = 1.0):
    """Block-structured SPD stiffness matrix — synthetic stand-in for
    structural-mechanics SuiteSparse problems (bcsstk17-class).

    ``edge_keep`` < 1 drops that fraction of members at random (real
    trusses are not fully 27-connected) — the calibration knob
    :func:`bcsstk17_profile_coo` uses to hit a published nnz exactly.

    The reference's other named workload class (BASELINE configs: bcsstk17,
    a steam-turbine stiffness matrix: 3 dof/node, dense coupling blocks,
    ~40 nnz/row) is reproduced in *shape* without egress: nodes on an
    nx×ny×nz grid carry a 3-vector displacement dof, every 27-neighborhood
    edge (p, q) with geometric offset d contributes the anisotropic spring
    energy ``w·(u_p−u_q)ᵀ(I + d̂ d̂ᵀ)(u_p−u_q)`` — the rank-structure of an
    elastic truss: stiffer along the member axis, like real elasticity's
    directional coupling.  SPD because the energy is a sum of PSD terms
    plus boundary pinning (z=0 face clamped, tiny ε·I everywhere).

    Profile at nx=16: n=12,288, ~75 nnz/row of dense 3×3 blocks —
    block-banded; `choose_layout` should pick a blocked layout and
    block-Jacobi(3) should beat scalar Jacobi.  Returns (rows, cols, vals,
    shape) COO with both triangles, block-row ordering (node-major,
    dof-minor).
    """
    ny = ny or nx
    nz = nz or nx
    nn = nx * ny * nz
    n = 3 * nn
    rng = np.random.default_rng(seed)
    idx = np.arange(nn, dtype=np.int64).reshape(nx, ny, nz)

    # 13 positive-half offsets of the 27-point neighborhood
    offsets = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) > (0, 0, 0)
    ]
    I3 = np.eye(3)
    rows_l, cols_l, vals_l = [], [], []
    # accumulate block diagonal contributions per node
    diag_blocks = np.zeros((nn, 3, 3), dtype=np.float64)
    a3 = np.arange(3, dtype=np.int64)

    def emit(bp, bq, K):  # block rows bp, block cols bq, (m,3,3) values
        m = len(bp)
        rows_l.append(
            np.broadcast_to(3 * bp[:, None, None] + a3[None, :, None], (m, 3, 3)).ravel()
        )
        cols_l.append(
            np.broadcast_to(3 * bq[:, None, None] + a3[None, None, :], (m, 3, 3)).ravel()
        )
        vals_l.append(np.broadcast_to(K, (m, 3, 3)).ravel())

    for dx, dy, dz in offsets:
        sp = idx[
            max(0, -dx) : nx - max(0, dx),
            max(0, -dy) : ny - max(0, dy),
            max(0, -dz) : nz - max(0, dz),
        ].ravel()
        sq = idx[
            max(0, dx) : nx - max(0, -dx),
            max(0, dy) : ny - max(0, -dy),
            max(0, dz) : nz - max(0, -dz),
        ].ravel()
        if edge_keep < 1.0:
            keep = rng.random(len(sp)) < edge_keep
            sp, sq = sp[keep], sq[keep]
        d = np.array([dx, dy, dz], dtype=np.float64)
        dhat = d / np.linalg.norm(d)
        w = 1.0 / np.dot(d, d)  # farther members are softer
        # heterogeneous member stiffness (real trusses are not uniform);
        # also the reason block-Jacobi(3) beats scalar Jacobi here — with
        # uniform weights the ±d contributions cancel the off-diagonal
        # terms of interior nodes' 3×3 diagonal blocks exactly
        we = w * (0.25 + 1.5 * rng.random(len(sp)))
        Ke = we[:, None, None] * (I3 + np.outer(dhat, dhat))[None]
        emit(sp, sq, -Ke)
        emit(sq, sp, -Ke)
        np.add.at(diag_blocks, sp, Ke)
        np.add.at(diag_blocks, sq, Ke)

    # boundary pinning (clamp the z=0 face) + jitter keeps it strictly SPD
    # and non-trivially conditioned like a real stiffness matrix
    pin = idx[:, :, 0].ravel()
    diag_blocks[pin] += 4.0 * I3[None]
    diag_blocks += (1e-3 + 0.01 * rng.random((nn, 1, 1))) * I3[None]
    nodes = np.arange(nn, dtype=np.int64)
    emit(nodes, nodes, diag_blocks)

    return (
        np.concatenate(rows_l),
        np.concatenate(cols_l),
        np.concatenate(vals_l),
        (n, n),
    )


def bcsstk17_profile_coo(seed: int = 0):
    """Elasticity stand-in calibrated to bcsstk17's PUBLISHED profile
    (test/Tester.cpp:16-21's steam-turbine stiffness matrix): n = 10,974
    exactly (3 dof × 3,658 nodes on a thin 59×31×2 shell — turbines are
    shells, not cubes) and nnz ≈ 428,650 (~39/row) via member
    sparsification (``edge_keep`` tuned so the expected stored-edge count
    matches; the realized nnz lands within ~1%).

    Until the sandbox gains egress (tools/fetch_suitesparse.py is attempted
    each round), this is config 2's bcsstk17 row; the skip-gated
    tests/test_suitesparse_real.py take over the moment the real file
    exists.
    """
    # target edges = (nnz_published − diag 3658·9) / (2·9)
    # full 27-neighborhood on 59×31×2 has 30,021 edges (counted once)
    return elasticity3d_coo(59, 31, 2, seed=seed,
                            edge_keep=(428650 - 3658 * 9) / 18 / 30021)


def block_tridiag_tiles(n: int, bm: int = 128, bn: int = 128, seed: int = 0):
    """The headline benchmark operator as full blocked-ELL host tiles:
    ``(blocks (nrb, 3, bm, bn) f32, block_cols (nrb, 3) i32, nnz)``.

    Same generator as ``bench.py``'s ``_block_tridiag_np`` (seed 0 there):
    SPD diagonally-dominant diagonal tiles and one symmetric coupling tile
    repeated along both off-diagonals; kmax = 3 with no padding waste.
    """
    assert bm == bn, "square tiles for this generator"
    nrb = n // bm
    rng = np.random.default_rng(seed)
    off = (0.1 * rng.standard_normal((bm, bn))).astype(np.float32)
    off = 0.5 * (off + off.T)
    diag = np.eye(bm, dtype=np.float32) * (2.0 + 2.0 * np.abs(off).sum())

    blocks = np.zeros((nrb, 3, bm, bn), dtype=np.float32)
    block_cols = np.zeros((nrb, 3), dtype=np.int32)
    for i in range(nrb):
        blocks[i, 0] = diag
        block_cols[i, 0] = i
        k = 1
        if i > 0:
            blocks[i, k] = off
            block_cols[i, k] = i - 1
            k += 1
        if i + 1 < nrb:
            blocks[i, k] = off
            block_cols[i, k] = i + 1
            k += 1
    return blocks, block_cols, nrb * 3 * bm * bn


def reference_rhs(n: int, dtype=np.float64) -> np.ndarray:
    """The harness RHS: b[i] = i + 1 (test/Tester.cpp:27-30)."""
    return np.arange(1, n + 1, dtype=dtype)
