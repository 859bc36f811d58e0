"""The shard group: the collectives of the row-sharded solve.

In the JAX package each shard's loop runs inside ``shard_map`` and reaches
the other shards through ``jax.lax.all_gather`` (the SpMV operand) and
``jax.lax.psum`` (the dots).  Here the loop is written as "for each shard
this process owns: local work; then one collective", against this small
interface:

* ``n_shards``, ``device``, ``shards`` (the shard indices this process
  owns) and ``row_offset(s, m)`` (the first global row of shard ``s`` of
  ``m`` rows);
* ``all_gather(local_vectors)``: the owned shards' vectors in, the whole
  vector (every shard's, in shard order) out;
* ``psum(partials)``: the owned shards' partial sums in, the sum over every
  shard out, as one device tensor that has the same bits on every shard;
* ``ring_halo(local_vectors, w)``: each owned shard's vector extended by
  the ``w`` last rows of its left neighbour and the ``w`` first of its right
  one (zeros past the ends of the ring), the JAX package's two
  ``ppermute``s (``parallel/local_ops.ring_halo``).

* ``assemble(local_vectors)``: the whole vector at the end of a solve (an
  all_gather on a row group; on a 2-D group the row pieces joined, which
  is no collective of the loop and is counted as ``assemble``).

Two back ends:

* :class:`InProcessGroup` owns every shard, on one device (one H100 runs
  the P shards of the loop in turn).
* :class:`DistributedGroup` owns one shard, its rank in a
  ``torch.distributed`` process group (gloo on the CPU, NCCL across GPUs).

Each has a 2-D form for the p × p block decomposition (``make_mesh_2d``,
``DistributedGroup.mesh_2d``): block (i, j) of A, and the vectors as p ROW
pieces, piece i on every block of block row i.  The loop's shards are the
row pieces (``n_shards`` is p, ``psum`` sums over the row pieces only); a
product adds ``transpose`` (block (i, j) trades its piece i for piece j,
the JAX package's mesh-transpose ``ppermute``) and ``col_sum`` (the
partial products of a block row summed over j in order, its ``psum`` over
the column axis), and no all_gather.

Both sum in one fixed order, ``((p₀ + p₁) + p₂) + …``, with elementwise
device ops: no reduction over a stacked axis and no atomics, so the bits do
not depend on the back end and two runs agree bit for bit (the reference
pins that, ``tests/test_solver_api.py::test_deterministic_bitwise``).  The
distributed group all-gathers the partials and sums them itself rather
than calling ``all_reduce``, whose ring order would change with the group.
Both count their calls by kind in ``counts`` (a kind appears there once it
has been called).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..types.base import DEFAULT_DEVICE


def _left_to_right(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class ShardGroup:
    """What both back ends share: the size, the device, the counters."""

    n_shards: int
    device: torch.device
    shards: tuple

    def __init__(self, n_shards: int, device, shards):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        self.shards = tuple(shards)
        self.counts = {"all_gather": 0, "psum": 0}

    def own_op(self, a) -> torch.Tensor:
        """The owned part of an operator array, on the group's device: on a
        row group the owned shards' slices of its leading shard axis."""
        return torch.as_tensor(a[self.shards[0]:self.shards[-1] + 1], device=self.device)

    @staticmethod
    def row_offset(s: int, m: int) -> int:
        """First global row of shard ``s`` when every shard has ``m`` rows."""
        return s * m

    def assemble(self, local_vectors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole (flat) vector from the owned shards' pieces at the end
        of a solve: on a row group, one all_gather."""
        return self.all_gather(local_vectors)

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def ring_halo(self, local_vectors: Sequence[torch.Tensor], w: int):
        """Each owned shard's rows (axis 0) extended by its ring
        neighbours' ``w`` edge rows: [left tail, rows, right head], (m + 2w,
        ...) each, zeros past the first and the last shard."""
        self._count("ring_halo")
        for v in local_vectors:
            if w > v.shape[0]:
                raise ValueError(
                    f"halo width {w} exceeds the local shard length {v.shape[0]}; "
                    "a one-hop ring cannot supply it")
        lefts, rights = self._edges(local_vectors, int(w))
        return [torch.cat([lt, v, rt]) for lt, v, rt in zip(lefts, local_vectors, rights)]

    @staticmethod
    def _tail(v: torch.Tensor, w: int) -> torch.Tensor:
        return v[v.shape[0] - w:]


def _joined(vectors: Sequence[torch.Tensor]):
    """The one flat buffer that holds ``vectors`` one after another as
    contiguous views, or None."""
    base = vectors[0]._base
    if base is None or not base.is_contiguous():
        return None
    m = vectors[0].numel()
    o = vectors[0].storage_offset()
    for i, v in enumerate(vectors):
        if (v._base is not base or not v.is_contiguous() or v.numel() != m
                or v.storage_offset() != o + i * m):
            return None
    start = o - base.storage_offset()
    return base.reshape(-1)[start:start + len(vectors) * m]


def _gather_sum(gather, p: torch.Tensor, size: int, pg) -> torch.Tensor:
    """Σ over the ``size`` ranks of ``pg`` of ``p``: every rank's copy
    gathered, then summed in rank order on each rank."""
    flat = p.reshape(-1).contiguous()
    out = flat.new_empty(size * flat.numel())
    gather(out, flat, group=pg)
    parts = out.reshape(size, *p.shape)
    return _left_to_right([parts[i] for i in range(size)])


class InProcessGroup(ShardGroup):
    """Every shard in this process, on one device."""

    def __init__(self, n_shards: int, device=DEFAULT_DEVICE):
        super().__init__(n_shards, device, range(n_shards))

    def all_gather(self, local_vectors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards' vectors joined (flat).  Where the loop keeps them as
        contiguous views of one buffer, that buffer is the result (no
        copy); it counts as one gather all the same."""
        self.counts["all_gather"] += 1
        if len(local_vectors) != self.n_shards:
            raise ValueError(f"all_gather: {len(local_vectors)} vectors for "
                             f"{self.n_shards} shards")
        whole = _joined(local_vectors)
        if whole is not None:
            return whole
        return torch.cat([v.reshape(-1) for v in local_vectors])

    def psum(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        self.counts["psum"] += 1
        if len(partials) != self.n_shards:
            raise ValueError(f"psum: {len(partials)} partials for {self.n_shards} shards")
        return _left_to_right(partials)

    def _edges(self, vs: Sequence[torch.Tensor], w: int):
        """A slice of each neighbour's shard, zeros at the ends."""
        if len(vs) != self.n_shards:
            raise ValueError(f"ring_halo: {len(vs)} vectors for {self.n_shards} shards")
        zero = vs[0].new_zeros((w,) + tuple(vs[0].shape[1:]))
        lefts = [zero] + [self._tail(v, w) for v in vs[:-1]]
        rights = [v[:w] for v in vs[1:]] + [zero]
        return lefts, rights


class DistributedGroup(ShardGroup):
    """One shard per process: this process's rank in ``process_group``
    (None: the default group), whose tensors live on ``device``."""

    def __init__(self, process_group=None, device=DEFAULT_DEVICE):
        import torch.distributed as dist

        self._gather = dist.all_gather_into_tensor
        self._dist = dist
        self.process_group = process_group
        rank = dist.get_rank(process_group)
        super().__init__(dist.get_world_size(process_group), device, (rank,))

    @staticmethod
    def mesh_2d(p: int, process_group=None, device=DEFAULT_DEVICE) -> "DistributedMesh2D":
        """The p × p form over the p² ranks of ``process_group`` (None: the
        default group): :class:`DistributedMesh2D`."""
        return DistributedMesh2D(p, process_group, device)

    def all_gather(self, local_vectors: Sequence[torch.Tensor]) -> torch.Tensor:
        self.counts["all_gather"] += 1
        (v,) = local_vectors
        v = v.reshape(-1).contiguous()
        out = v.new_empty(self.n_shards * v.numel())
        self._gather(out, v, group=self.process_group)
        return out

    def psum(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        self.counts["psum"] += 1
        (p,) = partials
        return _gather_sum(self._gather, p, self.n_shards, self.process_group)

    def _edges(self, vs: Sequence[torch.Tensor], w: int):
        """The neighbours' edge rows by point-to-point messages: this rank's
        tail goes to rank + 1 and its head to rank - 1, in one batch."""
        dist, pg = self._dist, self.process_group
        (v,) = vs
        rank, last = self.shards[0], self.n_shards - 1
        left = v.new_zeros((w,) + tuple(v.shape[1:]))
        right = torch.zeros_like(left)
        ops = []

        def peer(r):
            return r if pg is None else dist.get_global_rank(pg, r)

        if rank > 0:
            ops += [dist.P2POp(dist.isend, v[:w].contiguous(), peer(rank - 1), pg),
                    dist.P2POp(dist.irecv, left, peer(rank - 1), pg)]
        if rank < last:
            ops += [dist.P2POp(dist.isend, self._tail(v, w).contiguous(), peer(rank + 1), pg),
                    dist.P2POp(dist.irecv, right, peer(rank + 1), pg)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [left], [right]


class _Grid:
    """What both 2-D back ends share (module doc): ``p``, the owned
    blocks' rows and columns, and the result's assembly."""

    p: int

    def assemble(self, local_vectors: Sequence[torch.Tensor]) -> torch.Tensor:
        self._count("assemble")
        return self._join(local_vectors)

    def ring_halo(self, local_vectors, w):
        raise ValueError("a 2-D group has no ring halo (use a row group for banded operators)")


class InProcessMesh2D(_Grid, InProcessGroup):
    """The p × p block grid in this process, on one device: every block,
    every row piece."""

    def __init__(self, p: int, device=DEFAULT_DEVICE):
        InProcessGroup.__init__(self, p, device)
        self.p = int(p)
        self.counts.update(transpose=0, col_sum=0)

    def own_op(self, a) -> torch.Tensor:
        """The owned blocks of a (p, p, ...) operator array: all of them."""
        return torch.as_tensor(a, device=self.device)

    def transpose(self, row_pieces: Sequence[torch.Tensor]):
        """[i][j] = the operand of block (i, j): row piece j."""
        self._count("transpose")
        return [list(row_pieces) for _ in range(self.p)]

    def col_sum(self, parts):
        """Each block row's partial products summed over j, in order."""
        self._count("col_sum")
        return [_left_to_right(row) for row in parts]

    @staticmethod
    def _join(vs):
        return torch.cat([v.reshape(-1) for v in vs])


class DistributedMesh2D(_Grid, DistributedGroup):
    """The p × p block grid over the p² ranks of a process group, rank
    i·p + j owning block (i, j) and row piece i (the JAX mesh's device
    order).  Dots sum over the ranks of its grid column (the row pieces),
    ``col_sum`` over the ranks of its grid row; both subgroups are made
    here, on every rank in the same order, as ``torch.distributed``
    requires.  Build it with :meth:`DistributedGroup.mesh_2d`."""

    def __init__(self, p: int, process_group=None, device=DEFAULT_DEVICE):
        import torch.distributed as dist

        self._gather = dist.all_gather_into_tensor
        self._dist = dist
        self.process_group = process_group
        p = int(p)
        world = dist.get_world_size(process_group)
        if world != p * p:
            raise ValueError(f"a {p} x {p} grid needs {p * p} ranks, the group has {world}")
        rank = dist.get_rank(process_group)
        self.p = p
        self.i, self.j = divmod(rank, p)

        def glob(r):
            return r if process_group is None else dist.get_global_rank(process_group, r)

        self._glob = glob
        cols = [dist.new_group([glob(a * p + c) for a in range(p)]) for c in range(p)]
        rows = [dist.new_group([glob(a * p + c) for c in range(p)]) for a in range(p)]
        self._rows_pg, self._cols_pg = cols[self.j], rows[self.i]
        ShardGroup.__init__(self, p, device, (self.i,))
        self.counts.update(transpose=0, col_sum=0)

    def own_op(self, a) -> torch.Tensor:
        """This rank's block of a (p, p, ...) operator array, as (1, 1, ...)."""
        i, j = self.i, self.j
        return torch.as_tensor(a[i:i + 1, j:j + 1], device=self.device)

    def all_gather(self, local_vectors) -> torch.Tensor:
        self.counts["all_gather"] += 1
        return self._join(local_vectors)

    def _join(self, local_vectors) -> torch.Tensor:
        (v,) = local_vectors
        v = v.reshape(-1).contiguous()
        out = v.new_empty(self.p * v.numel())
        self._gather(out, v, group=self._rows_pg)
        return out

    def psum(self, partials) -> torch.Tensor:
        self.counts["psum"] += 1
        (q,) = partials
        return _gather_sum(self._gather, q, self.p, self._rows_pg)

    def transpose(self, row_pieces):
        """Block (i, j) sends its piece i to rank (j, i) and takes piece j
        from it, in one batch (the diagonal keeps its own)."""
        self._count("transpose")
        (v,) = row_pieces
        if self.i == self.j:
            return [[v]]
        dist = self._dist
        peer = self._glob(self.j * self.p + self.i)
        got = torch.empty_like(v)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, v.contiguous(), peer),
                                       dist.P2POp(dist.irecv, got, peer)])
        for req in reqs:
            req.wait()
        return [[got]]

    def col_sum(self, parts):
        self._count("col_sum")
        ((q,),) = parts
        return [_gather_sum(self._gather, q, self.p, self._cols_pg)]
