"""The reference's object API.  Counterpart of ``conjugategradient_tpu/compat.py``.

The reference exposes a stateful solver (class ``CG``, src/CG.hpp:53-601):
``createCG()`` (:70), ``setMatrix`` (:87), ``setTarget`` (:164),
``setInital``/``setInitial`` (:215, :244), ``solve(improvement)`` (:255),
then ``accuracy()`` (:463), ``extract()``/``extractTo()`` (:517, :529),
``getDimension()`` (:156) and ``memoryFootprint()`` (:555).  This wrapper
over :func:`cg_solve` keeps its preconditions (a missing matrix or target
raises), x₀ = 0 by default, ``improvement`` as an absolute tolerance on
‖r‖₂, the N+1 iteration cap, and a second ``solve`` warm-started from the
previous x.  After a solve it also has ``iterations``, ``converged`` and
``residual_history``.  The solve runs on ``device`` (the card unless the
caller passes ``"cpu"``), in float64 by default like the reference's DT.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .solver.cg import accuracy as _accuracy
from .solver.cg import cg_solve, expected_step_count, memory_footprint
from .types import CSRMatrix, LinearOperator, as_linear_operator
from .types.base import DEFAULT_DEVICE


class CG:
    """Stateful wrapper over :func:`cg_solve`, used as the reference's
    harness uses it (test/Tester.cpp:36-53)::

        cg = CG.createCG()
        cg.setMatrix(data, cols, rows)      # host CSR arrays
        cg.setTarget(b)
        cg.solve(1e-24)
        x = cg.extract()
        err = cg.accuracy()
    """

    def __init__(self, dtype=torch.float64, verbose: bool = False, *, device=DEFAULT_DEVICE):
        """``verbose`` plays the role of the reference's compile-time
        ``Debuglevel`` (LinearAlgebraTypes.hpp:26-30)."""
        self._dtype = dtype
        self._device = torch.device(device)
        self._A: Optional[LinearOperator] = None
        self._b: Optional[torch.Tensor] = None
        self._x0: Optional[torch.Tensor] = None
        self._x: Optional[torch.Tensor] = None
        self._info = None
        self._nnz = 0
        if verbose:
            from .utils.logging import set_verbosity

            set_verbosity("verbose")

    @staticmethod
    def createCG(dtype=torch.float64, verbose: bool = False, *, device=DEFAULT_DEVICE) -> "CG":
        """The reference's ``createCG()`` factory."""
        return CG(dtype=dtype, verbose=verbose, device=device)

    def _vector(self, values: Sequence) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=self._dtype, device=self._device)

    def setMatrix(self, data, columns=None, rows=None) -> None:
        """``setMatrix(data, columns, rows)`` with host CSR arrays (values,
        column indices, row offsets: the reference's signature,
        CG.hpp:87-93), or ``setMatrix(operator)`` with anything
        ``as_linear_operator`` takes."""
        if columns is None and rows is None:
            self._A = as_linear_operator(data, dtype=self._dtype, device=self._device)
            self._nnz = getattr(self._A, "nnz", 0)
            return
        csr = CSRMatrix.from_arrays(np.asarray(data), np.asarray(columns), np.asarray(rows),
                                    dtype=self._dtype, device=self._device)
        self._A = csr
        self._nnz = csr.nnz

    def setTarget(self, target: Sequence) -> None:
        """Right-hand side b (CG.hpp:164-170)."""
        self._b = self._vector(target)

    def setInitial(self, x0: Sequence) -> None:
        """Initial guess (CG.hpp:244-253; zero if never set)."""
        self._x0 = self._vector(x0)

    # the reference's own spelling (CG.hpp:215), kept as an alias
    setInital = setInitial

    def solve(self, improvement: float = 0.0, maxiter: Optional[int] = None) -> "CG":
        """CG with ``improvement`` as the absolute tolerance on ‖r‖₂, from
        the previous solution if there is one (CG.hpp:291-297).  Raises if
        the matrix or the target is missing (CG.hpp:266-272)."""
        if self._b is None:
            raise RuntimeError("No b vector specified")
        if self._A is None:
            raise RuntimeError("No Matrix specified")
        x0 = self._x if self._x is not None else self._x0
        self._x, self._info = cg_solve(self._A, self._b, x0, tol=improvement, maxiter=maxiter)
        return self

    def accuracy(self) -> float:
        """|Σ(b−Ax)² / Σx²|, a ratio of squared norms (CG.hpp:463-515)."""
        if self._x is None:
            raise RuntimeError("solve() has not been run")
        return float(_accuracy(self._A, self._b, self._x))

    def extract(self) -> np.ndarray:
        """The solution, copied to the host (CG.hpp:517-523)."""
        if self._x is None:
            raise RuntimeError("solve() has not been run")
        return self._x.cpu().numpy()

    def extractTo(self, out) -> None:
        """The solution, copied into a caller's buffer (CG.hpp:529-532)."""
        x = self.extract()
        if isinstance(out, list):
            out[:] = x.tolist()
        else:
            out[...] = x

    def getDimension(self) -> int:
        """System dimension N (CG.hpp:156-162)."""
        if self._A is None:
            raise RuntimeError("No Matrix specified")
        return self._A.shape[0]

    def memoryFootprint(self) -> int:
        """The reference's analytic estimate (CG.hpp:555-558)."""
        if self._A is None:
            raise RuntimeError("No Matrix specified")
        return memory_footprint(self._A.shape[0], self._nnz or self._A.shape[0],
                                dtype=self._dtype)

    def calculateExpectedStepCount(self, accuracy: float) -> int:
        """Predicted iterations to an A-norm error reduction of ``accuracy``
        (the reference declares it with an empty body, CG.hpp:235): a
        Lanczos condition estimate and the CG bound
        (solver/cg.expected_step_count)."""
        if self._A is None:
            raise RuntimeError("No Matrix specified")
        return expected_step_count(self._A, accuracy, device=self._device)

    @property
    def iterations(self) -> int:
        return int(self._info.iterations) if self._info is not None else 0

    @property
    def converged(self) -> bool:
        return bool(self._info.converged) if self._info is not None else False

    @property
    def residual_history(self) -> np.ndarray:
        """‖r_k‖² per iteration (the device scalar ``rxr`` the reference
        never exposed)."""
        if self._info is None:
            raise RuntimeError("solve() has not been run")
        return self._info.rho_history.cpu().numpy()[: self.iterations + 1]
