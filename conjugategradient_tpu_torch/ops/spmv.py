"""SpMV: CSR, full and symmetric blocked-ELL, and dense.

Counterpart of the matching parts of ``conjugategradient_tpu/ops/spmv.py``.
The JAX package computes CSR and symmetric blocked-ELL outside any Pallas
kernel (segment_sum, einsum), so they stay plain torch here too; full
blocked-ELL goes to the hand-written kernel (``ops/cuda/bell_spmv.py``) on
a CUDA device, as the JAX package sends it to its Pallas kernel on a TPU.
The plain forms are deterministic on CUDA: no ``index_add_`` (which lands
through atomics there) — the CSR rows reduce with ``torch.segment_reduce``
(one thread per segment walks its values in order) and the symmetric mirror
lands through a fixed-order gather of the transposed tile index.
"""

from __future__ import annotations

import torch


def full_precision_matmul() -> None:
    """Turn TF32 off for matmuls and cuDNN.  TF32 keeps ~10 mantissa bits,
    which costs CG iterations (the TPU's VPU-over-MXU rule,
    ``conjugategradient_tpu/ops/pallas/ell_spmv.py:15-17``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _acc(dtype: torch.dtype) -> torch.dtype:
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of consecutive segments of ``vals`` with the given lengths."""
    return torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)


def csr_spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y[i] = Σ_j A[i,j]·x[j]: one gather, one sorted segmented sum."""
    prods = a.data * x.index_select(0, a.indices)
    return segment_sum(prods, a.lengths)


def dense_spmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    full_precision_matmul()
    return torch.mv(a, x)


KERNEL_CHOICES = ("auto", "never", "always")


def bell_apply(blocks, block_cols, x2d):
    """(nrb, bm) = Σ_k blocks[:, k] @ x2d[block_cols[:, k]] — the plain
    full blocked-ELL product (the einsum of the JAX package's
    ``_bell_spmv_jnp``), in the tiles' and x's common dtype."""
    full_precision_matmul()
    gathered = x2d[block_cols.long()]  # (nrb, kmax, bn)
    # one batched product per (row, slot), then the sum over slots: no copy
    # of the tile stream, which a joint (k, n) contraction would make
    return torch.einsum("rkmn,rkn->rkm", blocks, gathered).sum(dim=1)


def bell_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """Full blocked-ELL SpMV (``BlockedEllMatrix.matvec``): x padded to the
    operator's padded width, y cut to its ``n`` rows.

    ``use_kernel="auto"`` follows the JAX package's dispatch: float32 (and
    bf16) tiles on a CUDA device go to the hand-written kernel, float64
    tiles and CPU tensors to the plain einsum; ``"never"`` and ``"always"``
    force one route (on CPU tensors the kernel's wrapper runs its plain
    version).  The JAX package's TPU gates (x fits VMEM ≤ 8 MB,
    ``kmax <= 64``, ``bm % 8``/``bn % 128``) are dropped: the CUDA kernel
    reads x from L2/HBM, loops over the slots at run time and takes any
    ``bm`` with ``bn`` in ``CUDA_BN``.
    """
    if use_kernel not in KERNEL_CHOICES:
        raise ValueError(f"use_kernel must be one of {KERNEL_CHOICES}, got {use_kernel!r}")
    n, _ = a.shape
    _, mp = a.padded_shape
    xp = x if mp == x.shape[0] else torch.nn.functional.pad(x, (0, mp - x.shape[0]))
    x2d = xp.reshape(mp // a.bn, a.bn)
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    if use_kernel == "always" or (
        use_kernel == "auto" and x.is_cuda and a.dtype != torch.float64
    ):
        from .cuda.bell_spmv import bell_spmv_tiles

        y = bell_spmv_tiles(a.blocks, a.block_cols, x2d.to(torch.float32))
    else:
        acc = _acc(out_dtype)
        y = bell_apply(a.blocks.to(acc), a.block_cols, x2d.to(acc)).reshape(-1)
    return y[:n].to(out_dtype)


def sym_bell_spmv(a, x: torch.Tensor) -> torch.Tensor:
    """Symmetric blocked-ELL SpMV: each stored upper tile applied twice,
    ``q[r] += B @ x[c]`` and ``q[c] += Bᵀ @ x[r]``.

    The mirror products land in their block-row through ``a.mirror_src``
    (types/bell.mirror_index): a padded gather summed over a small fixed
    axis, so the result is the same on every run.
    """
    n, _ = a.shape
    _, mp = a.padded_shape
    xp = x if mp == x.shape[0] else torch.nn.functional.pad(x, (0, mp - x.shape[0]))
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    acc = _acc(out_dtype)
    y = sym_bell_apply(
        a.diag_blocks.to(acc), a.off_blocks.to(acc), a.off_cols, a.mirror_src,
        xp.reshape(mp // a.bn, a.bn).to(acc),
    )
    return y.reshape(-1)[:n].to(out_dtype)


def sym_bell_apply(diag, off, off_cols, mirror_src, x2d):
    """(nrb, bm) = (D + U + Uᵀ) x on symmetric tiles, x as (nrb, bn)."""
    full_precision_matmul()
    bn = x2d.shape[1]
    qd = torch.einsum("rmn,rn->rm", diag, x2d)
    gathered = x2d[off_cols.long()]  # (nrb, ku, bn)
    qu = torch.einsum("rkmn,rkn->rm", off, gathered)
    # mirror: Bᵀ @ x[r], one (bn,) row per stored slot, plus a zero row
    # that the -1 padding of the transposed index points at
    v = torch.einsum("rkmn,rm->rkn", off, x2d).reshape(-1, bn)
    v = torch.cat([v, v.new_zeros(1, bn)])
    src = mirror_src.long()
    src = torch.where(src < 0, v.shape[0] - 1, src)
    qt = v[src].sum(dim=1)  # (nrb, bn)
    return qd + qu + qt
