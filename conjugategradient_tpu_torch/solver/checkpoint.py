"""Checkpoint and resume of long solves.  Counterpart of
``conjugategradient_tpu/solver/checkpoint.py``:

    state = cg_init(A, b, maxiter=100000)
    state = run_cg(A, state, tol, steps=5000)
    save_state("ckpt.npz", state)
    ...
    state = load_state("ckpt.npz")
    state = run_cg(A, state, tol, steps=5000)      # continues exactly

A carry is written as ``.npz`` with the JAX package's field names and its
``__kind__``, so a file written by either package loads in the other:
``k, done, x, r, p, rho, rnorm_sq, hist`` for ``CGState``,
``k, done, x, r, p, beta, rho, hist`` for ``FusedCGState`` (vectors as
(rows, bn) float32 blocks, β and ρ = ‖r‖² as (1, 1)) and
``k, done, X, r, p, rho, rnorm, hist`` for the lockstep multi-RHS
``BatchedCGState`` (vectors (N, R), per-lane scalars (R,), the history
(maxiter+1, R); driven by ``solver.batched.run_batched_cg``), and
``k, done, x, r, p, rho, rnorm, hist`` for the row-sharded
``parallel.ShardedCGState`` (global (n_padded,) vectors; driven by
``parallel.sharded_run_cg`` and its DIA and SELL siblings, the group and
the operator given again at resume).  The port's
``FusedCGState`` keeps k, done, β, ρ and the history in its ``FusedWork``;
:func:`load_state` builds one (``convert.fused_state_from_arrays``).
``run_cg`` drives the same step as the whole solve through
``solver/restart.run_chunked``, so a solve advanced in chunks gives the
bits of one uninterrupted solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.cuda.fused_cg import S_TOL
from ..types.base import DEFAULT_DEVICE
from .batched import BatchedCGState
from .cg import CGState, cg_step
from .fused import FusedCGState, fused_cg_step
from .restart import run_chunked

_FIELDS = {
    "CGState": ("k", "done", "x", "r", "p", "rho", "rnorm_sq", "hist"),
    "FusedCGState": ("k", "done", "x", "r", "p", "beta", "rho", "hist"),
    "BatchedCGState": ("k", "done", "X", "r", "p", "rho", "rnorm", "hist"),
    "ShardedCGState": ("k", "done", "x", "r", "p", "rho", "rnorm", "hist"),
}


def save_state(path, state) -> None:
    """Write a solver carry (``CGState``, unpreconditioned ``FusedCGState``,
    ``BatchedCGState`` or ``ShardedCGState``) to ``.npz``."""
    kind = type(state).__name__
    if kind not in _FIELDS:
        raise TypeError(f"not a checkpointable solver state: {kind}")
    if kind == "FusedCGState" and state.d is not None:
        raise ValueError("FusedCGState checkpoints are unpreconditioned "
                         "(the file has no Jacobi diagonal)")
    fields = {name: getattr(state, name) for name in _FIELDS[kind]}
    np.savez(path, __kind__=np.asarray(kind),
             **{name: t.detach().cpu().numpy() for name, t in fields.items()})


def load_state(path, *, device=DEFAULT_DEVICE):
    """Load a carry written by :func:`save_state` (or by the JAX package's)
    onto ``device``; files without ``__kind__`` are ``CGState``."""
    with np.load(path) as z:
        kind = str(z["__kind__"]) if "__kind__" in z else "CGState"
        if kind not in _FIELDS:
            raise TypeError(f"not a checkpointable solver state: {kind}")
        f = {name: np.array(z[name]) for name in _FIELDS[kind]}
    if kind == "FusedCGState":
        from ..convert import fused_state_from_arrays

        return fused_state_from_arrays(f["x"], f["r"], f["p"], f["beta"], f["rho"],
                                       int(f["k"]), bool(f["done"]), f["hist"], device=device)
    t = {name: torch.from_numpy(v).to(torch.device(device)) for name, v in f.items()}
    if kind in ("BatchedCGState", "ShardedCGState"):
        if kind == "ShardedCGState":
            from ..parallel.sharded_cg import ShardedCGState as cls
        else:
            cls = BatchedCGState
        return cls(**{**t, "k": t["k"].to(torch.int32), "done": t["done"].to(torch.bool)})
    return CGState(k=t["k"].to(torch.int32), done=t["done"].to(torch.bool), x=t["x"], r=t["r"],
                   p=t["p"], rho=t["rho"], rnorm_sq=t["rnorm_sq"], hist=t["hist"])


def run_cg(A, state, tol, steps: Optional[int] = None, M=None):
    """Advance a solve by at most ``steps`` iterations (or to convergence or
    the history's capacity), in place for a ``FusedCGState``; returns the
    state.

    ``M`` must be the preconditioner the ``CGState`` was made with
    (``cg_init(..., M=M)``); a ``FusedCGState`` (from
    ``solver.fused.fused_cg_init``, for the blocked-ELL operator ``A``) is
    unpreconditioned.  The host reads k once per call.
    """
    fused = isinstance(state, FusedCGState)
    if fused and (M is not None or state.d is not None):
        raise ValueError("FusedCGState carries are unpreconditioned (M=None)")
    maxiter = state.hist.numel() - 1
    k = int(state.k)
    limit = maxiter if steps is None else min(maxiter, k + int(steps))
    if fused:
        state.work.scal[S_TOL] = float(tol)
        run_chunked(lambda: fused_cg_step(A, state), lambda: state.live, limit - k)
        return state
    tol_t = torch.as_tensor(tol, dtype=state.x.dtype, device=state.x.device)
    box = [state]

    def step():
        box[0] = cg_step(A, box[0], tol_t, M=M)

    run_chunked(step, lambda: box[0].live, limit - k, done=lambda: box[0].done)
    return box[0]
