"""The day mesh of the sharded solve (counterpart of
`copula_var_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` whose 'days' axis carries
the out-of-sample days. The port runs one process per rank
(`parallel/distributed.py`), and a `DayMesh` is what one rank knows of
the world: the process group, its rank, the world's size and its device.
Each rank owns one contiguous block of days, JAX's ceil(T / D) blocks
(`pad_days`) with the short last block sliced, not padded; a rank whose
block is empty still joins every collective.

The reductions (`max`, `all`, `any`, `sum`) and `broadcast_object` use
only `all_reduce` and `broadcast`, the two collectives that both NCCL and
gloo serve on CUDA tensors. Without a process group (one process) they
return their input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from copula_var_tpu_torch.parallel.distributed import rank_device


@dataclass(frozen=True)
class DayMesh:
    """One rank's view of the day-sharded world: `group` (None for one
    process with no group), `rank`, `size` and the rank's `device`."""

    group: Optional[Any]
    rank: int
    size: int
    device: torch.device

    def day_block(self, T: int):
        """This rank's days [start, stop) of T: blocks of ceil(T / size),
        the last one short (or empty)."""
        block = -(-int(T) // self.size)
        start = min(self.rank * block, T)
        return start, min(start + block, T)

    def days(self, T: int) -> slice:
        return slice(*self.day_block(T))

    def _reduce(self, t, op):
        if self.group is None:
            return t
        out = t.reshape(-1).clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out.reshape(t.shape)

    def sum(self, t):
        """Elementwise sum over the ranks."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t):
        """Elementwise max over the ranks."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def all(self, flags):
        """Elementwise AND of bool `flags` over the ranks (JAX's `gall`,
        a `pmin`)."""
        return self._reduce(flags.to(torch.int32), dist.ReduceOp.MIN) > 0

    def any(self, flags):
        """Elementwise OR of bool `flags` over the ranks (JAX's `gany`, a
        `pmax`)."""
        return self._reduce(flags.to(torch.int32), dist.ReduceOp.MAX) > 0

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable `obj` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DayMesh:
    """The day mesh over the initialized world, or a world of one process
    when none is (`distributed.initialize` first). `n_devices`, when
    given, must equal the world's size (one device per rank). `device`
    "cuda" gives each rank `cuda:{local_rank % device_count}` (and raises
    without a GPU), "cpu" the CPU."""
    joined = dist.is_initialized()
    size = dist.get_world_size() if joined else 1
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"n_devices={n_devices} but the world has {size} rank(s): the "
            "port runs one process per device, so launch n_devices ranks "
            "(torchrun --nproc-per-node, or parallel.distributed.run_world) "
            "and call distributed.initialize() in each")
    rank = dist.get_rank() if joined else 0
    return DayMesh(dist.group.WORLD if joined else None, rank, size,
                   rank_device(device, rank))
