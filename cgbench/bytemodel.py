"""The bytes one loop step needs, whatever implements it.

Counting rule: the operator's bytes once (its reference module's
``operator_bytes``: for an assembled symmetric operator each stored nonzero
of D + strict U at its value and a 4-byte column, and 4 bytes a row; a
matrix-free one needs none), and x, r and p each read once and written once
per right-hand side: 6 * n * w bytes, w the vectors' element size.
"""

from __future__ import annotations

import torch

from .traffic import dtype_of


def element_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def step_bytes(reference, cfg: dict, traffic: dict) -> int:
    n = reference.n(cfg)
    w = element_bytes(dtype_of(traffic))
    op = reference.operator_bytes(cfg, w)
    return op + 6 * n * w * int(traffic["rhs_per_request"])
