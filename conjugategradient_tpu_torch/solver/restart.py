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

A fused step after the end costs two launches that return at once.  A
portable step after the end computes everything and masks it, the
preconditioner included, so the portable loops also pass their ``done``
flag: after each step it is copied to pinned host memory without blocking,
and the host launches a step only while at most ``LOOKAHEAD - 1`` of those
copies are still in flight and none that arrived is set.  The host then
runs at most ``LOOKAHEAD`` steps ahead of the device, which keeps the
device's queue full, and at most ``LOOKAHEAD - 1`` steps are launched after
the step that set ``done``.

While tracing is on (``utils/tracing.py``), the loop, each launched step
and each blocking host read are spans: ``cg.loop``, ``cg.step``,
``cg.live_read`` and ``cg.poll_wait``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Optional

import torch

from ..utils.tracing import annotate, on

#: steps launched between host reads of the done flag: a read drains the
#: launch queue, and steps after done are no-ops that cost only launches
CHECK_EVERY = 32
#: most steps of a polled (portable) loop in flight on the device at once
LOOKAHEAD = 4


class _DonePoll:
    """Watch a device ``done`` flag from the host without draining the
    launch queue (module doc).  On CPU tensors the flag is read directly."""

    def __init__(self, flag: Callable[[], torch.Tensor]):
        self.flag = flag
        self.cuda = flag().is_cuda
        if self.cuda:
            buf = torch.zeros(LOOKAHEAD, dtype=torch.bool).pin_memory()
            self.slots = [buf[i] for i in range(LOOKAHEAD)]
            self.events = [torch.cuda.Event() for _ in range(LOOKAHEAD)]
            self.pending = collections.deque()
            self.pushed = 0
            self.push()

    def push(self) -> None:
        """Queue a copy of the flag as it stands after the work queued so far."""
        if not self.cuda:
            return
        i = self.pushed % LOOKAHEAD
        self.pushed += 1
        self.slots[i].copy_(self.flag(), non_blocking=True)
        self.events[i].record()
        self.pending.append(i)

    def finished(self) -> bool:
        """Whether a copy that has arrived is set; waits for the oldest
        copy only while ``LOOKAHEAD`` of them are in flight."""
        if not self.cuda:
            with annotate("cg.poll_wait"):
                return bool(self.flag())
        while self.pending:
            i = self.pending[0]
            if len(self.pending) >= LOOKAHEAD:
                with annotate("cg.poll_wait"):
                    self.events[i].synchronize()
            elif not self.events[i].query():
                break
            self.pending.popleft()
            if bool(self.slots[i]):
                return True
        return False


def run_chunked(step: Callable[[], Any], live: Callable[[], torch.Tensor],
                maxiter: int, every: int = 0,
                replace: Optional[Callable[[], Any]] = None,
                done: Optional[Callable[[], torch.Tensor]] = None,
                start: int = 0) -> None:
    """Drive ``step`` until ``live()`` turns false, reading it on the host
    once per ``CHECK_EVERY`` steps and never launching more than
    ``maxiter - start`` steps in all.

    ``start``: the iteration count the state already has (a resumed
    chunk); the step count, the restart boundaries and the host checks
    run on from it.

    With ``every > 0``, ``replace`` runs after each launched multiple of
    ``every``.  While the solve is live the step count on the device equals
    the launched count, so that is iteration k = every, 2·every, ... — also
    k == maxiter when ``every`` divides it, as in the JAX loop.  ``replace``
    must mask itself on the device (no-op once the solve is done), since
    launched steps after ``done`` leave k behind.

    ``done`` (the portable loops pass it; the fused ones do not): returns
    the state's device flag that a step sets when the solve has ended.  It
    is polled as the module doc says, and the loop returns as soon as it is
    seen set: at most ``LOOKAHEAD - 1`` steps after the one that set it
    (none on CPU tensors).  The steps in between are masked no-ops, so the
    result is the same as without it.
    """
    if every < 0:
        raise ValueError(f"recompute_r_every must be >= 0, got {every}")
    with annotate("cg.loop"):
        _loop(step, live, maxiter, every, replace, done, start)


def _loop(step, live, maxiter, every, replace, done, start) -> None:
    """The body of :func:`run_chunked`."""
    poll = _DonePoll(done) if done is not None else None
    launch = step
    if poll is not None:
        def launch():
            step()
            poll.push()

    launched = start
    next_check = start + CHECK_EVERY
    while launched < maxiter:
        stop = min(next_check, maxiter)
        if every:
            stop = min(stop, (launched // every + 1) * every)
        for _ in range(stop - launched):
            if poll is not None and poll.finished():
                return
            if on():
                with annotate("cg.step"):
                    launch()
            else:
                launch()
        launched = stop
        if every and launched % every == 0:
            replace()
        if launched == next_check:
            with annotate("cg.live_read"):
                alive = bool(live())
            if not alive:
                break
            next_check += CHECK_EVERY
