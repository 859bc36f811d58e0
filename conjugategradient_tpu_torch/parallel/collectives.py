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
  shard out, as one device tensor that has the same bits on every shard.

Two back ends:

* :class:`InProcessGroup` owns every shard, on one device (one H100 runs
  the P shards of the loop in turn).
* :class:`DistributedGroup` owns one shard, its rank in a
  ``torch.distributed`` process group (gloo on the CPU, NCCL across GPUs).

Both sum in one fixed order, ``((p₀ + p₁) + p₂) + …``, with elementwise
device ops: no reduction over a stacked axis and no atomics, so the bits do
not depend on the back end and two runs agree bit for bit (the reference
pins that, ``tests/test_solver_api.py::test_deterministic_bitwise``).  The
distributed group all-gathers the partials and sums them itself rather
than calling ``all_reduce``, whose ring order would change with the group.
Both count their calls by kind in ``counts``.
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

    @staticmethod
    def row_offset(s: int, m: int) -> int:
        """First global row of shard ``s`` when every shard has ``m`` rows."""
        return s * m


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


class DistributedGroup(ShardGroup):
    """One shard per process: this process's rank in ``process_group``
    (None: the default group), whose tensors live on ``device``."""

    def __init__(self, process_group=None, device=DEFAULT_DEVICE):
        import torch.distributed as dist

        self._gather = dist.all_gather_into_tensor
        self.process_group = process_group
        rank = dist.get_rank(process_group)
        super().__init__(dist.get_world_size(process_group), device, (rank,))

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
        flat = p.reshape(-1).contiguous()
        out = flat.new_empty(self.n_shards * flat.numel())
        self._gather(out, flat, group=self.process_group)
        parts = out.reshape(self.n_shards, *p.shape)
        return _left_to_right([parts[i] for i in range(self.n_shards)])
