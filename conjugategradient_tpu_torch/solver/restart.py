"""The solve loop's driver, with periodic residual replacement.
Counterpart of ``conjugategradient_tpu/solver/restart.py``.

The JAX package runs a solve as one ``lax.while_loop`` and makes the
restart cadence structural: an inner loop runs to the next multiple of
``every``, then one replacement step runs, masked so that a boundary that is
not a restart point (the solve is done) changes nothing.  Here the loop is
a Python loop of device-resident steps: the host reads the ``live`` flag
only every ``CHECK_EVERY`` launched steps, and a chunk of launches stops at
the nearer of the next host check and the next restart boundary.  The
replacement is torch ops masked on the device, with no host read, so the
cadence of host reads is the same with or without restarts.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

#: steps launched between host reads of the done flag: a read drains the
#: launch queue, and steps after done are no-ops that cost only launches
CHECK_EVERY = 32


def run_chunked(step: Callable[[], Any], live: Callable[[], torch.Tensor],
                maxiter: int, every: int = 0,
                replace: Optional[Callable[[], Any]] = None) -> None:
    """Drive ``step`` until ``live()`` turns false, reading it on the host
    once per ``CHECK_EVERY`` steps and never launching more than
    ``maxiter`` steps in all.

    With ``every > 0``, ``replace`` runs after each launched multiple of
    ``every``.  While the solve is live the step count on the device equals
    the launched count, so that is iteration k = every, 2·every, ... — also
    k == maxiter when ``every`` divides it, as in the JAX loop.  ``replace``
    must mask itself on the device (no-op once the solve is done), since
    launched steps after ``done`` leave k behind.
    """
    if every < 0:
        raise ValueError(f"recompute_r_every must be >= 0, got {every}")
    launched = 0
    next_check = CHECK_EVERY
    while launched < maxiter:
        stop = min(next_check, maxiter)
        if every:
            stop = min(stop, (launched // every + 1) * every)
        for _ in range(stop - launched):
            step()
        launched = stop
        if every and launched % every == 0:
            replace()
        if launched == next_check:
            if not bool(live()):
                break
            next_check += CHECK_EVERY
