"""Vector primitives (the reference's ``VectorOperations.hpp``) on torch
tensors.  Counterpart of ``conjugategradient_tpu/ops/blas.py``; scalars stay
0-dim device tensors, never host numbers."""

from __future__ import annotations

import torch


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> with at least float32 accumulation."""
    acc = _acc_dtype(x.dtype)
    return torch.sum(x.to(acc) * y.to(acc))


def norm_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ x² (the reference's ``norm``: no sqrt)."""
    return dot(x, x)


def norm(x: torch.Tensor) -> torch.Tensor:
    """‖x‖₂."""
    return torch.sqrt(norm_sq(x))


def saxpby(a, x: torch.Tensor, b, y: torch.Tensor) -> torch.Tensor:
    """a·x + b·y."""
    return a * x + b * y


def sapbx(x: torch.Tensor, b, y: torch.Tensor) -> torch.Tensor:
    """x + b·y (the x and p updates)."""
    return x + b * y


def sambx(x: torch.Tensor, b, y: torch.Tensor) -> torch.Tensor:
    """x − b·y (the residual update)."""
    return x - b * y
