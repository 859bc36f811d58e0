"""HPCG's 27-point operator as the port's ``SymBellMatrix``: the diagonal
tiles and the strictly upper tiles of ``tile``-wide block rows, built on
the device from the stencil's structure (no host CSR pass).  Rows are
grid points, x fastest, then y, then z."""

from __future__ import annotations

import math

import torch


def build(port, cfg: dict, dtype: torch.dtype, device) -> "port.SymBellMatrix":
    nx, ny, nz = cfg["grid"]
    n = nx * ny * nz
    bs = int(cfg["tile"])
    nrb = -(-n // bs)
    dev = torch.device(device)
    r = torch.arange(n, device=dev)
    x, y, z = r % nx, (r // nx) % ny, r // (nx * ny)
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
                      & (z + dz >= 0) & (z + dz < nz))
                c = r + dx + nx * (dy + ny * dz)
                # symmetric storage keeps the diagonal tiles and the upper ones
                keep = ok & (c // bs >= r // bs)
                rows.append(r[keep])
                cols.append(c[keep])
                v = cfg["center"] if (dx, dy, dz) == (0, 0, 0) else cfg["off"]
                vals.append(torch.full((rows[-1].numel(),), v, dtype=dtype, device=dev))
    row, col, val = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    del rows, cols, vals
    rb, cb = row // bs, col // bs
    diag = cb == rb
    diag_blocks = torch.zeros((nrb, bs, bs), dtype=dtype, device=dev)
    diag_blocks.view(-1)[(rb[diag] * bs + row[diag] % bs) * bs + col[diag] % bs] = val[diag]
    up = ~diag
    # each block row's distinct upper column blocks, in increasing order,
    # take slots 0, 1, ...; a row's unused slots point at itself (padding)
    pairs = torch.unique(rb[up] * nrb + cb[up])
    prow, pcol = pairs // nrb, pairs % nrb
    count = torch.bincount(prow, minlength=nrb)
    ku = max(int(count.max()), 1)
    first = torch.cumsum(count, 0) - count
    pslot = torch.arange(pairs.numel(), device=dev) - first[prow]
    off_cols = torch.arange(nrb, dtype=torch.int32, device=dev)[:, None].repeat(1, ku)
    off_cols[prow, pslot] = pcol.to(torch.int32)
    slot = pslot[torch.searchsorted(pairs, rb[up] * nrb + cb[up])]
    off_blocks = torch.zeros((nrb, ku, bs, bs), dtype=dtype, device=dev)
    off_blocks.view(-1)[((rb[up] * ku + slot) * bs + row[up] % bs) * bs + col[up] % bs] = val[up]
    nnz = math.prod(3 * g - 2 for g in cfg["grid"])
    # tiles a block row of the full layout holds: its diagonal, its upper
    # tiles and the mirrors of the upper tiles that land in it
    incoming = torch.bincount(pcol, minlength=nrb)
    full_kmax = int((1 + count + incoming).max())
    return port.SymBellMatrix(diag_blocks, off_blocks, off_cols, (n, n), nnz, full_kmax)
