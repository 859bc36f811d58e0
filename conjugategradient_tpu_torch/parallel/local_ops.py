"""Per-shard local matvecs and the ring halo of the row-sharded solves.
Counterpart of ``conjugategradient_tpu/parallel/local_ops.py``.

Each local product runs on one shard's operator arrays against the operand
its layout needs: the all-gathered vector (blocked-ELL, symmetric
blocked-ELL, SELL) or the shard's rows with a ring halo of the bandwidth
(DIA, symmetric DIA).  Each mirrors the JAX form in its order of
operations and its dtype promotion (at least float32 accumulation, the
result in the common dtype of the operator and the vector), so float64
runs keep oracle parity.  Two call an existing hand-written kernel where it
gives the plain form's bits: the blocked-ELL product (``bell_spmv``,
kernel 5) and the DIA product on the haloed window (``dia_spmv``, kernel 7,
bit-equal to its plain version, which is the JAX form); both on a CUDA
device for a float32 result, as ``ops/spmv._kernel_route`` decides.  The
blocked-ELL product takes the dense-tile kernel where the tiles' width bn
is one it takes (``CUDA_BN``), and packed kernel 5 on the shard's packed
view otherwise (the sharded AMG and FSAI levels' tiles of at most 8
columns), as the one-card ``ops/spmv.bell_spmv`` does; the view is built
once a solve (:func:`_bell_products`).  The multi-RHS products
(``_local_*_matvec_multi``, the operand (·, R)) are plain on every device,
the port's ``ops/spmv.*_spmv_multi`` forms on one shard, as the JAX ones
are XLA.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..ops.cuda._common import CUDA_BN, LAUNCHES
from ..ops.spmv import (_acc, _kernel_route, bell_apply, dia_apply, full_precision_matmul,
                        sell_bucket_reduce, sym_bell_apply)
from ..types.bell import pack_nonzeros


def ring_halo(p_local: Union[torch.Tensor, Sequence[torch.Tensor]], w: int, group):
    """Halo-extend row shards by ``w`` rows from each ring neighbour.

    ``p_local`` is the owned shards' vectors (a list, one per shard of
    ``group``), or one tensor when the group owns one shard (a
    ``DistributedGroup``).  Each comes back as ``[left tail, rows, right
    head]`` of length m + 2w, zeros past the first and the last shard —
    the zero padding the DIA layout expects.  In an ``InProcessGroup`` the
    halos are slices of the neighbours' shards; across processes, two
    point-to-point messages (``torch.distributed.batch_isend_irecv``).
    Raises ``ValueError`` when ``w`` exceeds the shard length (a one-hop
    ring cannot supply it), as the JAX function does."""
    if isinstance(p_local, torch.Tensor):
        if len(group.shards) != 1:
            raise ValueError(f"one tensor for a group that owns {len(group.shards)} shards; "
                             "pass one vector per owned shard")
        return group.ring_halo([p_local], w)[0]
    return group.ring_halo(list(p_local), w)


def _out_dtype(op_dtype, v_dtype):
    return torch.promote_types(op_dtype, v_dtype)


def _local_bell_matvec(blocks, block_cols, p_full_2d, packed=None):
    """(nrb·bm,) = shard tiles @ the gathered operand (ncb, bn): for a
    float32 result on a CUDA device kernel 5, the dense-tile kernel
    (``bell_spmv``) where bn is in ``CUDA_BN`` and the packed one
    (``bell_spmv_packed``) on ``packed``, the shard's view
    (:func:`_shard_packed`), otherwise; the plain einsum elsewhere."""
    out_dtype = _out_dtype(blocks.dtype, p_full_2d.dtype)
    if _kernel_route("auto", p_full_2d, out_dtype):
        from ..ops.cuda.bell_spmv import bell_spmv_packed, bell_spmv_tiles

        x = p_full_2d.to(torch.float32)
        if blocks.shape[-1] in CUDA_BN:
            return bell_spmv_tiles(blocks, block_cols, x)
        if packed is None:
            raise ValueError(f"tiles {blocks.shape[-1]} wide take packed kernel 5: pass the "
                             "shard's packed view (_shard_packed)")
        return bell_spmv_packed(packed, x.reshape(-1))
    acc = _acc(out_dtype)
    y = bell_apply(blocks.to(acc), block_cols, p_full_2d.to(acc))
    return y.reshape(-1).to(out_dtype)


def _shard_packed(blocks, block_cols, ncols: int):
    """One shard's packed view (``types/bell.pack_nonzeros``, global
    columns into the gathered operand of ``ncols`` entries) where its
    products on the card take packed kernel 5: float32 or bfloat16 tiles
    on a CUDA device whose width is not in ``CUDA_BN``.  None otherwise.
    Set-up work, counted in ``LAUNCHES["bell_pack"]``: it reads the tiles
    and the host reads the view's size."""
    if (blocks.is_cuda and blocks.dtype in (torch.float32, torch.bfloat16)
            and blocks.shape[-1] not in CUDA_BN):
        LAUNCHES["bell_pack"] += 1  # counted as the one-card views' builds are
        return pack_nonzeros(blocks, block_cols, ncols)
    return None


def _bell_products(blocks_s, cols_s, ncols: int):
    """The owned shards' products against one gathered operand,
    ``full (ncb, bn) -> [y_i]`` (:func:`_local_bell_matvec`), with each
    shard's packed view built here, once."""
    packs = [_shard_packed(b, c, ncols) for b, c in zip(blocks_s, cols_s)]
    return lambda full: [_local_bell_matvec(b, c, full, pk)
                         for b, c, pk in zip(blocks_s, cols_s, packs)]


def _local_symbell_matvec(diag_s, off_s, offcols_s, mirror_s, cross_s, crossrows_s,
                          crosscols_s, p_full_2d, base_block: int):
    """Per-shard symmetric blocked-ELL SpMV against the gathered operand.

    The intra-shard tiles apply twice, B along storage and Bᵀ into the
    shard's own rows (through ``mirror_s``, the shard's transposed index,
    ``types/bell.mirror_index``: a gather in a fixed order where the JAX
    form scatter-adds); the cross-shard tiles apply once against the global
    operand and land in their owning rows.  ``base_block``: the shard's
    first global block-row."""
    nrb = diag_s.shape[0]
    out_dtype = _out_dtype(diag_s.dtype, p_full_2d.dtype)
    acc = _acc(out_dtype)
    full = p_full_2d.to(acc)
    q = sym_bell_apply(diag_s.to(acc), off_s.to(acc), offcols_s, mirror_s,
                       full[base_block:base_block + nrb])
    qx = torch.einsum("rkmn,rkn->rm", cross_s.to(acc), full[crosscols_s.long()])
    # the padding cross slots hold zero tiles: their zeros change no sum
    q = q.index_add(0, crossrows_s.long(), qx)
    return q.reshape(-1).to(out_dtype)


def _local_dia_matvec(diags_s, offsets, offsets_dev, window):
    """Banded SpMV on one row shard from its haloed window (m + 2w,):
    y = Σ_d diags[d] ⊙ window[off_d + w : off_d + w + m], in offset order.
    ``offsets``/``offsets_dev`` are the shard's offsets shifted by w."""
    out_dtype = _out_dtype(diags_s.dtype, window.dtype)
    if _kernel_route("auto", window, out_dtype):
        from ..ops.cuda.dia_spmv import dia_spmv_diags

        y = dia_spmv_diags(diags_s, offsets, offsets_dev, window.to(torch.float32))
    else:
        acc = _acc(out_dtype)
        y = dia_apply(diags_s.to(acc), offsets, window.to(acc))
    return y.to(out_dtype)


def _symdia_left_halo(group, diags: Sequence[torch.Tensor], w: int):
    """Left neighbours' tails of every stored diagonal, (ndiag, w) a shard,
    zeros on shard 0: the mirror term needs the NEIGHBOUR's diagonal
    values.  Loop-invariant: fetched once per solve."""
    windows = group.ring_halo([d.T for d in diags], w)
    return [win[:w].T for win in windows]


def _local_symdia_matvec(diags_s, dleft, offsets, window):
    """Symmetric-DIA SpMV on one row shard: the stored (≥ 0 offset) half
    band applied both ways.  Forward terms read the haloed window; mirror
    terms y[i] += d[i−k]·x[i−k] read the left halo of x and ``dleft``."""
    m = diags_s.shape[1]
    w = max(max(offsets), 1) if offsets else 1
    acc = _acc(_out_dtype(diags_s.dtype, window.dtype))
    xe = window[: w + m].to(acc)  # left halo + local x
    y = torch.zeros(m, dtype=acc, device=window.device)
    for d, off in enumerate(offsets):
        dv = diags_s[d].to(acc)
        lo = off + w
        y = y + dv * window[lo: lo + m].to(acc)
        if off > 0:
            t = torch.cat([dleft[d].to(acc), dv]) * xe  # (m + w,)
            y = y + t[w - off: w - off + m]
    return y.to(_out_dtype(diags_s.dtype, window.dtype))


def _make_dia_mpk_basis(group, diags: Sequence[torch.Tensor], offsets, s: int):
    """Matrix-powers basis for banded shards (the s-step loop's ``basis_fn``,
    Demmel/Hoemmen): K = [r, Ar/ν, …, (A/ν)ˢr] from ONE ring halo of width
    s·w a block instead of s.  The neighbour rows' diagonal values are
    haloed once per solve (width (s−1)·w), so each level is a local banded
    apply on a window that shrinks by w a level, with the operations (and
    the per-level cast) of ``_local_dia_matvec`` chained s times.  Works on
    the owned shards' rows one after another, as ``_sharded_sstep_cg``
    hands them.  None when s·w exceeds the shard length: the loop then
    takes the matvec-at-a-time basis."""
    m = int(diags[0].shape[1])
    w = max(max(abs(o) for o in offsets), 1)
    if s * w > m:
        return None
    H = (s - 1) * w
    ext = [win.T for win in group.ring_halo([d.T for d in diags], H)] if H else list(diags)
    n_own = len(diags)

    def basis(r, inv_nu):
        vdt = _out_dtype(diags[0].dtype, r.dtype)
        acc = _acc(vdt)
        parts = [r[i * m:(i + 1) * m] for i in range(n_own)]
        curs = group.ring_halo(parts, s * w)  # rows [-sw, m+sw)
        out = []
        for i, cur in enumerate(curs):
            rows = [parts[i]]
            for level in range(s, 0, -1):
                lh = (level - 1) * w  # output halo width
                mm = m + 2 * lh
                y = torch.zeros(mm, dtype=acc, device=r.device)
                for d, off in enumerate(offsets):
                    dv = ext[i][d, H - lh: H - lh + mm]
                    y = y + dv.to(acc) * cur[off + w: off + w + mm].to(acc)
                cur = (y * inv_nu.to(acc)).to(vdt)
                rows.append(cur[lh: lh + m])
            out.append(torch.stack(rows, dim=0))
        return torch.cat(out, dim=1)

    return basis


def _local_sell_matvec(diag_s, pos_s, cols_s, vals_s, meta, p_full, p_local):
    """Bucketed-ELL SpMV on one row shard against the gathered operand:
    one flat gather at the stored GLOBAL columns, the per-bucket sums
    (``ops/spmv.sell_bucket_reduce``), the order-restore gather through
    ``pos``, and the diagonal on the shard's own rows."""
    out_dtype = _out_dtype(vals_s.dtype, p_local.dtype)
    acc = _acc(out_dtype)
    prods = vals_s.to(acc) * p_full.index_select(0, cols_s).to(acc)
    y_sorted = sell_bucket_reduce(prods, meta)
    y = diag_s.to(acc) * p_local.to(acc) + y_sorted.index_select(0, pos_s)
    return y.to(out_dtype)


# ---- multi-RHS forms: the operand (·, R), R lanes a row ----------------------------

def _local_bell_matvec_multi(blocks, block_cols, p_full_3d):
    """(nrb·bm, R) = shard tiles @ the gathered operand (ncb, bn, R): the
    tile stream read once for all R lanes, one (bm, bn) × (bn, R) product a
    tile, summed over a block row's slots (``ops/spmv.bell_spmv_multi``)."""
    full_precision_matmul()
    out_dtype = _out_dtype(blocks.dtype, p_full_3d.dtype)
    acc = _acc(out_dtype)
    gathered = p_full_3d[block_cols.long()].to(acc)  # (nrb, kmax, bn, R)
    y = torch.einsum("rkmn,rknB->rkmB", blocks.to(acc), gathered).sum(dim=1)
    return y.reshape(-1, y.shape[-1]).to(out_dtype)


def _local_sell_matvec_multi(diag_s, pos_s, cols_s, vals_s, meta, P_full, P_local):
    """Multi-RHS bucketed-ELL SpMV on one row shard: the flat gather at the
    stored GLOBAL columns fetches R contiguous lane values an index
    (``ops/spmv.sell_spmv_multi``), then the per-bucket sums, the order
    restore and the diagonal on the shard's own rows."""
    out_dtype = _out_dtype(vals_s.dtype, P_local.dtype)
    acc = _acc(out_dtype)
    prods = vals_s.to(acc)[:, None] * P_full.index_select(0, cols_s).to(acc)
    y_sorted = sell_bucket_reduce(prods, meta)
    y = diag_s.to(acc)[:, None] * P_local.to(acc) + y_sorted.index_select(0, pos_s)
    return y.to(out_dtype)


def _local_dia_matvec_multi(diags_s, offsets, window):
    """Multi-RHS banded SpMV on one row shard from its haloed (m + 2w, R)
    window, ``offsets`` shifted by w: each diagonal read once for all R
    lanes (``ops/spmv.dia_spmv_multi``)."""
    out_dtype = _out_dtype(diags_s.dtype, window.dtype)
    acc = _acc(out_dtype)
    return dia_apply(diags_s.to(acc), offsets, window.to(acc)).to(out_dtype)
