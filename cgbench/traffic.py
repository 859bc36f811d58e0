"""The general generator of the benchmark's requests.

A traffic mix (``traffic/<mix>.json``) is parameters only:

* ``solver``: the request entry (``solvers/<solver>.py``);
* ``rhs_per_request``: R, the right-hand sides one request solves;
* ``pool``: P, the distinct requests of a run; the window cycles through
  them in order;
* ``base_seed``: the seed of the pool's base right-hand sides, whose
  entries are standard normal;
* ``dtype``: the type of the vectors and of the operator's values;
* ``tol_rel``: each right-hand side is solved to ``tol_rel * ||b||``.

How many steps CG takes depends on b, so right-hand sides drawn afresh
from every seed would give every seed a different amount of work.  Every
run therefore serves the same P base right-hand sides (drawn on the device
from ``base_seed`` in one call), each moved by a symmetry of the grid
that the run's ``--seed`` draws: a flip of each axis, a permutation of the
axes of equal length, and a sign.  The operators commute with those
symmetries, so each request's work is the same in every run while its
vector differs; the same seed gives the same requests.
"""

from __future__ import annotations

import itertools

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def dtype_of(traffic: dict) -> torch.dtype:
    return DTYPES[traffic["dtype"]]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any whole number;
    taken modulo 2**64, the range ``manual_seed`` accepts)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def symmetries(shape: tuple) -> list:
    """(flips, permutation) of a grid of ``shape``: every set of flipped
    axes, and every permutation that maps each axis to one of equal
    length."""
    perms = [p for p in itertools.permutations(range(len(shape)))
             if all(shape[a] == shape[b] for a, b in zip(p, range(len(shape))))]
    flips = [tuple(a for a in range(len(shape)) if mask >> a & 1)
             for mask in range(1 << len(shape))]
    return [(f, p) for f in flips for p in perms]


def draw_pool(traffic: dict, shape: tuple, seed: int, device) -> list:
    """The P requests of a run: (n,) vectors for R = 1, (R, n) blocks
    otherwise, in the mix's ``dtype``; ``shape`` is the grid's shape in
    the order the operator's vectors are laid out (C order)."""
    P, R = int(traffic["pool"]), int(traffic["rhs_per_request"])
    dtype = dtype_of(traffic)
    base = generator(traffic["base_seed"], device)
    n = 1
    for s in shape:
        n *= s
    pool = torch.randn((P, R, n), generator=base, device=device, dtype=dtype)
    moves = symmetries(tuple(shape))
    pick = generator(seed, "cpu")
    which = torch.randint(len(moves), (P,), generator=pick).tolist()
    signs = (2 * torch.randint(2, (P,), generator=pick) - 1).tolist()
    out = []
    for j in range(P):
        flips, perm = moves[which[j]]
        v = pool[j].view(R, *shape)
        if flips:
            v = v.flip([a + 1 for a in flips])
        # a copy of its own for every request, so the base pool is freed
        w = torch.empty((R, n), dtype=dtype, device=device)
        w.view(R, *(shape[a] for a in perm)).copy_(v.permute(0, *[a + 1 for a in perm]))
        if signs[j] < 0:
            w.neg_()
        out.append(w[0] if R == 1 else w)
    return out
