"""SpMV: CSR, full and symmetric blocked-ELL, full and symmetric DIA,
SELL, and dense.

Counterpart of the matching parts of ``conjugategradient_tpu/ops/spmv.py``.
The JAX package computes CSR, symmetric blocked-ELL and SELL outside any
Pallas kernel (segment_sum, einsum, gathers), so they stay plain torch here
too; full blocked-ELL and both DIA layouts go to hand-written kernels
(``ops/cuda/bell_spmv.py``, ``ops/cuda/dia_spmv.py``) on a CUDA device, as
the JAX package sends them to its Pallas kernels on a TPU.  The plain forms
are deterministic on CUDA: no ``index_add_`` (which lands through atomics
there) — the CSR rows reduce with ``torch.segment_reduce`` (one thread per
segment walks its values in order), the symmetric mirror lands through a
fixed-order gather of the transposed tile index, and SELL reduces fixed
(nb, k) slabs.
"""

from __future__ import annotations

import torch

from .cuda._common import CUDA_BN


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


def _kernel_route(use_kernel: str, x: torch.Tensor, out_dtype) -> bool:
    """The dispatch rule of the kernel-backed SpMVs (``use_kernel="auto"``):
    a CUDA device and a float32 result take the hand-written kernel
    (bf16 operators too, which the wrappers refuse on CUDA); a float64
    operator or vector, and CPU tensors, the plain form.  ``"never"`` and
    ``"always"`` force one route (on CPU tensors a kernel's wrapper runs its
    plain version)."""
    if use_kernel not in KERNEL_CHOICES:
        raise ValueError(f"use_kernel must be one of {KERNEL_CHOICES}, got {use_kernel!r}")
    return use_kernel == "always" or (
        use_kernel == "auto" and x.is_cuda and out_dtype != torch.float64)


def bell_apply(blocks, block_cols, x2d):
    """(nrb, bm) = Σ_k blocks[:, k] @ x2d[block_cols[:, k]] — the plain
    full blocked-ELL product (the einsum of the JAX package's
    ``_bell_spmv_jnp``), in the tiles' and x's common dtype."""
    full_precision_matmul()
    gathered = x2d[block_cols.long()]  # (nrb, kmax, bn)
    # one batched product per (row, slot), then the sum over slots: no copy
    # of the tile stream, which a joint (k, n) contraction would make
    return torch.einsum("rkmn,rkn->rkm", blocks, gathered).sum(dim=1)


def bell_packed_route(a) -> bool:
    """Whether products with a blocked-ELL operator read its packed
    nonzeros (``a.packed()``) instead of the tile stream: float32 tiles
    whose view, 8 bytes a nonzero and 4 a row, takes at most half of
    ``tile_bytes()``, or whose width bn the dense kernels do not take.
    ``a.nnz`` (the whole operator's, also for symmetric storage, whose
    view holds D + U + Uᵀ) and the shapes decide, so choosing reads no
    tiles; the rule is the same on every device, so the CPU runs the
    packed kernels' plain versions where the card runs the kernels.  Full
    storage (``BlockedEllMatrix``) is read so by every SpMV and fused step;
    symmetric storage (``SymBellMatrix``, ``tile_bytes()`` = diagonal and
    upper tiles) by the fused MINRES step only."""
    if a.dtype != torch.float32:
        return False
    return a.bn not in CUDA_BN or 2 * (8 * a.nnz + 4 * a.nrb * a.bm) <= a.tile_bytes()


def bell_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """Full blocked-ELL SpMV (``BlockedEllMatrix.matvec``): x padded to the
    operator's padded width, y cut to its ``n`` rows.

    A float32 result on an operator that :func:`bell_packed_route` sends to
    the packed view takes the packed kernel (its plain version on CPU
    tensors) unless ``use_kernel="never"``.  Otherwise ``use_kernel``
    follows the JAX package's dispatch (:func:`_kernel_route`: float32 on a
    CUDA device takes the dense-tile kernel, float64 and CPU tensors the
    plain einsum).  The JAX package's TPU gates (x fits VMEM ≤ 8 MB,
    ``kmax <= 64``, ``bm % 8``/``bn % 128``) are dropped: the CUDA kernels
    read x from L2/HBM, loop over the slots at run time, and the dense one
    takes any ``bm`` with ``bn`` in ``CUDA_BN``.
    """
    n, _ = a.shape
    _, mp = a.padded_shape
    xp = x if mp == x.shape[0] else torch.nn.functional.pad(x, (0, mp - x.shape[0]))
    x2d = xp.reshape(mp // a.bn, a.bn)
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    kernel = _kernel_route(use_kernel, x, out_dtype)
    if use_kernel != "never" and out_dtype == torch.float32 and bell_packed_route(a):
        from .cuda.bell_spmv import bell_spmv_packed

        return bell_spmv_packed(a.packed(), xp.to(torch.float32))[:n]
    if kernel:
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


def dia_apply(diags: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y (n,) = Σ_d diags[d] ⊙ x[i + offsets[d]] — the plain DIA product
    (the JAX package's XLA path): one zero-padded copy of x, then one
    multiply and one add per diagonal, in offset order, each rounded to the
    common dtype of ``diags`` and ``x``.  Columns outside [0, ncols) read
    the padding's zeros."""
    n = diags.shape[1]
    ncols = x.shape[0]
    lpad = max(0, -min(offsets)) if offsets else 0
    rpad = max(0, max(offsets) + n - ncols) if offsets else 0
    xp = torch.nn.functional.pad(x, (lpad, rpad)) if (lpad or rpad) else x
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        lo = off + lpad
        y = y + diags[d] * xp[lo: lo + n]
    return y


def dia_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """DIA SpMV (``DIAMatrix.matvec``): y[i] = Σ_d diags[d, i]·x[i + off_d].

    ``use_kernel`` as in :func:`bell_spmv`: float32 operators on a CUDA
    device take the hand-written kernel at any offsets, float64 and CPU
    tensors the plain form.  The JAX package's TPU gate (the Pallas kernel
    only for max|offset| >= 1024) is dropped: it rests on XLA:TPU keeping
    loop-invariant diagonals in VMEM across a jitted solve
    (``conjugategradient_tpu/ops/spmv.py:288-295``), while the plain torch
    form makes ndiag separate passes over x and y, so on the card the
    kernel's single pass wins at every offset.
    """
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    if _kernel_route(use_kernel, x, out_dtype):
        from .cuda.dia_spmv import dia_spmv_diags

        y = dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x.to(torch.float32))
    else:
        acc = _acc(out_dtype)
        y = dia_apply(a.diags.to(acc), a.offsets, x.to(acc))
    return y.to(out_dtype)


def sym_dia_apply(diags: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y (n,) = symmetric-DIA(diags, offsets ≥ 0) @ x — the plain form (the
    JAX package's XLA path): for each stored offset k in order, the forward
    term d_k[i]·x[i+k] (zero past the end), then for k > 0 the mirror
    d_k[i−k]·x[i−k] (zero for i < k), each product and sum rounded to the
    common dtype."""
    n = diags.shape[1]
    w = max(offsets) if offsets else 0
    xp = torch.nn.functional.pad(x, (0, w)) if w else x
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        dv = diags[d]
        y = y + dv * xp[off: off + n]
        if off > 0:
            m = max(n - off, 0)
            y = y + torch.nn.functional.pad(dv[:m] * x[:m], (n - m, 0))
    return y


def sym_dia_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """Symmetric DIA SpMV (``SymDIAMatrix.matvec``): each stored diagonal
    applied both ways, so the operator stream is the stored half-band.
    Dispatch as in :func:`dia_spmv` (no offset gate)."""
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    if _kernel_route(use_kernel, x, out_dtype):
        from .cuda.dia_spmv import sym_dia_spmv_diags

        y = sym_dia_spmv_diags(a.diags, a.offsets, a.offsets_dev, x.to(torch.float32))
    else:
        acc = _acc(out_dtype)
        y = sym_dia_apply(a.diags.to(acc), a.offsets, x.to(acc))
    return y.to(out_dtype)


def sell_bucket_reduce(prods: torch.Tensor, meta) -> torch.Tensor:
    """Per-bucket k-axis sums of flat SELL slot products: ``prods`` is
    (slots,) or (slots, R), ``meta`` the (nb, k) bucket list; returns the
    bucket-concatenated row sums ((Σnb,) or (Σnb, R))."""
    trailing = tuple(prods.shape[1:])
    parts, base = [], 0
    for nb, k in meta:
        if k == 0:
            parts.append(prods.new_zeros((nb,) + trailing))
            continue
        parts.append(prods[base: base + nb * k].reshape((nb, k) + trailing).sum(dim=1))
        base += nb * k
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def sell_spmv(a, x: torch.Tensor) -> torch.Tensor:
    """Degree-bucketed ELL SpMV (``SellMatrix.matvec``): one gather of x at
    every stored column, one multiply, a fixed (nb, k) sum per bucket, the
    order-restore gather through ``pos`` (skipped when ``pos_identity``),
    and the diagonal as a plain stream.  Plain torch everywhere, as in the
    JAX package, which has no Pallas kernel for SELL."""
    n = a.shape[0]
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    acc = _acc(out_dtype)
    xa = x.to(acc)
    prods = a.vals_flat.to(acc) * xa.index_select(0, a.cols_flat)
    y_sorted = sell_bucket_reduce(prods, a.bucket_meta)
    y_off = y_sorted[:n] if a.pos_identity else y_sorted.index_select(0, a.pos)
    return (a.diag.to(acc) * xa[:n] + y_off).to(out_dtype)
