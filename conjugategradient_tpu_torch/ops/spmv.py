"""SpMV: CSR, full and symmetric blocked-ELL, full and symmetric DIA,
SELL, and dense.

Counterpart of the matching parts of ``conjugategradient_tpu/ops/spmv.py``.
The JAX package computes CSR, symmetric blocked-ELL and SELL outside any
Pallas kernel (segment_sum, einsum, gathers), so CSR and SELL stay plain
torch here too, and so does symmetric blocked-ELL on dense tiles; full
blocked-ELL, both DIA layouts and sparse-tile symmetric blocked-ELL (read
as its packed nonzeros) go to hand-written kernels
(``ops/cuda/bell_spmv.py``, ``ops/cuda/dia_spmv.py``) on a CUDA device, as
the JAX package sends the first two to its Pallas kernels on a TPU.  The
plain forms are deterministic on CUDA: no ``index_add_`` (which lands
through atomics there) — the CSR rows reduce with ``torch.segment_reduce``
(one thread per segment walks its values in order), the symmetric mirror
lands through a fixed-order gather of the transposed tile index, and SELL
reduces fixed (nb, k) slabs.  The multi-RHS forms (``*_spmv_multi``, X
of shape (n, R)) are plain torch on every device, as the JAX package's
are XLA on every backend.
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
    """a @ x in the common dtype of a and x, accumulated in at least
    float32 (the JAX package's ``preferred_element_type``)."""
    full_precision_matmul()
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    acc = _acc(out_dtype)
    return torch.mv(a.to(acc), x.to(acc)).to(out_dtype)


KERNEL_CHOICES = ("auto", "never", "always")


def _kernel_route(use_kernel: str, x: torch.Tensor, out_dtype) -> bool:
    """The dispatch rule of the kernel-backed SpMVs (``use_kernel="auto"``):
    a CUDA device and a float32 or bfloat16 result take the hand-written
    kernel (a bfloat16 operator its bf16 form, on float32 x; a bf16 result
    is the float32 one rounded); a float64 operator or vector, and CPU
    tensors, the plain form.
    ``"never"`` and ``"always"`` force one route (on CPU tensors a kernel's
    wrapper runs its plain version)."""
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
    nonzeros (``a.packed()``) instead of the tile stream: float32 or
    bfloat16 tiles whose view, a value and a 4-byte column a nonzero (8
    bytes, 6 in bf16) and 4 bytes a row, takes at most half of
    ``tile_bytes()`` (tiles of the same dtype), or whose width bn the dense
    kernels do not take.
    ``a.nnz`` (the whole operator's, also for symmetric storage, whose
    view holds D + U + Uᵀ) and the shapes decide, so choosing reads no
    tiles; the rule is the same on every device, so the CPU runs the
    packed kernels' plain versions where the card runs the kernels.  Both
    storages are read so by their SpMV (:func:`bell_spmv`,
    :func:`sym_bell_spmv`) and by every fused step that takes them (CG and
    MINRES in either storage, BiCGStab in full storage); symmetric
    storage's ``tile_bytes()`` counts its diagonal and upper tiles."""
    if a.dtype not in (torch.float32, torch.bfloat16):
        return False
    value = 4 if a.dtype == torch.float32 else 2
    return a.bn not in CUDA_BN or 2 * ((value + 4) * a.nnz + 4 * a.nrb * a.bm) <= a.tile_bytes()


def bell_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """Full blocked-ELL SpMV (``BlockedEllMatrix.matvec``): x padded to the
    operator's padded width, y cut to its ``n`` rows.

    A float32 or bfloat16 result on an operator that
    :func:`bell_packed_route` sends to the packed view takes the packed
    kernel (its plain version on CPU tensors) unless ``use_kernel="never"``.
    Otherwise ``use_kernel`` follows the JAX package's dispatch
    (:func:`_kernel_route`: float32 or bfloat16 on a CUDA device takes the
    dense-tile kernel, float64 and CPU tensors the plain einsum).  The JAX package's TPU gates (x fits VMEM ≤ 8 MB,
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
    if use_kernel != "never" and _acc(out_dtype) == torch.float32 and bell_packed_route(a):
        from .cuda.bell_spmv import bell_spmv_packed

        return bell_spmv_packed(a.packed(), xp.to(torch.float32))[:n].to(out_dtype)
    if kernel:
        from .cuda.bell_spmv import bell_spmv_tiles

        y = bell_spmv_tiles(a.blocks, a.block_cols, x2d.to(torch.float32))
    else:
        acc = _acc(out_dtype)
        y = bell_apply(a.blocks.to(acc), a.block_cols, x2d.to(acc)).reshape(-1)
    return y[:n].to(out_dtype)


def sym_bell_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """Symmetric blocked-ELL SpMV (``SymBellMatrix.matvec``): each stored
    upper tile applied twice, ``q[r] += B @ x[c]`` and ``q[c] += Bᵀ @ x[r]``.

    A float32 or bfloat16 result on an operator that
    :func:`bell_packed_route` sends to the packed view (the whole operator
    D + U + Uᵀ, ``a.packed()``) takes packed kernel 5 (its plain version on CPU tensors) unless
    ``use_kernel="never"``.  Otherwise the plain torch form, which is how
    the JAX package computes it (with XLA, no Pallas kernel): the mirror
    products land in their block-row through ``a.mirror_src``
    (types/bell.mirror_index), a padded gather summed over a small fixed
    axis, so the result is the same on every run.
    """
    if use_kernel not in KERNEL_CHOICES:
        raise ValueError(f"use_kernel must be one of {KERNEL_CHOICES}, got {use_kernel!r}")
    n, _ = a.shape
    _, mp = a.padded_shape
    xp = x if mp == x.shape[0] else torch.nn.functional.pad(x, (0, mp - x.shape[0]))
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    if use_kernel != "never" and _acc(out_dtype) == torch.float32 and bell_packed_route(a):
        from .cuda.bell_spmv import bell_spmv_packed

        return bell_spmv_packed(a.packed(), xp.to(torch.float32))[:n].to(out_dtype)
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


def _pad_rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """x (n,) or (n, R) with ``lo`` zero rows before and ``hi`` after."""
    return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (lo, hi))


def _rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A diagonal (n,) shaped to scale each row of x, (n,) or (n, R)."""
    return v if x.ndim == 1 else v[:, None]


def dia_apply(diags: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y (n,) = Σ_d diags[d] ⊙ x[i + offsets[d]] — the plain DIA product
    (the JAX package's XLA path): one zero-padded copy of x, then one
    multiply and one add per diagonal, in offset order, each rounded to the
    common dtype of ``diags`` and ``x``.  Columns outside [0, ncols) read
    the padding's zeros.  An (ncols, R) block x gives (n, R), each column
    with the same operations as a vector."""
    n = diags.shape[1]
    ncols = x.shape[0]
    lpad = max(0, -min(offsets)) if offsets else 0
    rpad = max(0, max(offsets) + n - ncols) if offsets else 0
    xp = _pad_rows(x, lpad, rpad) if (lpad or rpad) else x
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        lo = off + lpad
        y = y + _rows(diags[d], x) * xp[lo: lo + n]
    return y


def dia_spmv(a, x: torch.Tensor, use_kernel: str = "auto") -> torch.Tensor:
    """DIA SpMV (``DIAMatrix.matvec``): y[i] = Σ_d diags[d, i]·x[i + off_d].

    ``use_kernel`` as in :func:`bell_spmv`: float32 and bfloat16 operators
    on a CUDA device take the hand-written kernel at any offsets, float64
    and CPU tensors the plain form.  The JAX package's TPU gate (the Pallas kernel
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
    common dtype.  An (n, R) block x gives (n, R), column by column."""
    n = diags.shape[1]
    w = max(offsets) if offsets else 0
    xp = _pad_rows(x, 0, w) if w else x
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        dv = _rows(diags[d], x)
        y = y + dv * xp[off: off + n]
        if off > 0:
            m = max(n - off, 0)
            y = y + _pad_rows(dv[:m] * x[:m], n - m, 0)
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


# ---- multi-RHS forms: Y[:, j] = A @ X[:, j] for X (n, R) ------------------
# Plain torch, as the JAX package computes them (XLA, no Pallas kernel):
# the operator's stream is read once for all R columns.  Each column sees
# the operations of the single-RHS plain form, the tile products batched
# over the R columns.


def bell_spmv_multi(a, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS full blocked-ELL SpMV: X (n, R) padded to the operator's
    padded width, one (bm, bn) × (bn, R) product per tile, summed over a
    block-row's slots."""
    full_precision_matmul()
    n, _ = a.shape
    _, mp = a.padded_shape
    R = X.shape[1]
    Xp = X if mp == X.shape[0] else _pad_rows(X, 0, mp - X.shape[0])
    out_dtype = torch.promote_types(a.dtype, X.dtype)
    acc = _acc(out_dtype)
    x3d = Xp.reshape(mp // a.bn, a.bn, R).to(acc)
    gathered = x3d[a.block_cols.long()]  # (nrb, kmax, bn, R)
    Y = torch.einsum("rkmn,rknB->rkmB", a.blocks.to(acc), gathered).sum(dim=1)
    return Y.reshape(-1, R)[:n].to(out_dtype)


def sym_bell_spmv_multi(a, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS symmetric blocked-ELL SpMV: each stored upper tile read
    once and applied as B and Bᵀ to all R columns.  The mirror products
    land through ``a.mirror_src``, the fixed-order gather of
    :func:`sym_bell_apply` widened to R columns (the JAX package scatters
    them; a scatter on the card adds in a run-dependent order), so two
    calls give the same bits."""
    full_precision_matmul()
    n, _ = a.shape
    _, mp = a.padded_shape
    R = X.shape[1]
    Xp = X if mp == X.shape[0] else _pad_rows(X, 0, mp - X.shape[0])
    out_dtype = torch.promote_types(a.dtype, X.dtype)
    acc = _acc(out_dtype)
    bn = a.bn
    x3d = Xp.reshape(mp // bn, bn, R).to(acc)
    off = a.off_blocks.to(acc)
    qd = torch.einsum("rmn,rnB->rmB", a.diag_blocks.to(acc), x3d)
    qu = torch.einsum("rkmn,rknB->rkmB", off, x3d[a.off_cols.long()]).sum(dim=1)
    v = torch.einsum("rkmn,rmB->rknB", off, x3d).reshape(-1, bn, R)
    v = torch.cat([v, v.new_zeros(1, bn, R)])
    src = a.mirror_src.long()
    src = torch.where(src < 0, v.shape[0] - 1, src)
    qt = v[src].sum(dim=1)  # (nrb, bn, R)
    return (qd + qu + qt).reshape(-1, R)[:n].to(out_dtype)


def sell_spmv_multi(a, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS SELL SpMV: the flat gather fetches R contiguous values
    per stored column, then the per-bucket sums, the order restore and the
    diagonal stream of :func:`sell_spmv`."""
    n = a.shape[0]
    out_dtype = torch.promote_types(a.dtype, X.dtype)
    acc = _acc(out_dtype)
    Xa = X.to(acc)
    prods = a.vals_flat.to(acc)[:, None] * Xa.index_select(0, a.cols_flat)  # (slots, R)
    y_sorted = sell_bucket_reduce(prods, a.bucket_meta)
    Y_off = y_sorted[:n] if a.pos_identity else y_sorted.index_select(0, a.pos)
    return (a.diag.to(acc)[:, None] * Xa[:n] + Y_off).to(out_dtype)


def dia_spmv_multi(a, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS DIA SpMV: each diagonal multiplies a shifted (n, R)
    window of the zero-padded X, in offset order (:func:`dia_apply`)."""
    out_dtype = torch.promote_types(a.dtype, X.dtype)
    acc = _acc(out_dtype)
    return dia_apply(a.diags.to(acc), a.offsets, X.to(acc)).to(out_dtype)


def sym_dia_spmv_multi(a, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS symmetric DIA SpMV: each stored diagonal read once and
    applied both ways to all R columns (:func:`sym_dia_apply`)."""
    out_dtype = torch.promote_types(a.dtype, X.dtype)
    acc = _acc(out_dtype)
    return sym_dia_apply(a.diags.to(acc), a.offsets, X.to(acc)).to(out_dtype)
