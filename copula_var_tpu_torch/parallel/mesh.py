"""The meshes of the sharded solves (counterpart of
`copula_var_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` whose 'days' axis carries
the out-of-sample days, and for grid sharding a 2-D ('days', 'grid')
mesh whose 'grid' axis splits the outer grid axis. The port runs one
process per rank (`parallel/distributed.py`), and a mesh is what one
rank knows of the world.

A `DayMesh` holds the process group, the rank, the world's size and the
rank's device. Each rank owns one contiguous block of days, JAX's
ceil(T / D) blocks (`pad_days`) with the short last block sliced, not
padded; a rank whose block is empty still joins every collective.

A `GridMesh` of shape (d, g) puts rank r at (r // g, r % g): its grid
groups join the g ranks of one day row, and its day mesh (a `DayMesh`)
the d ranks of one grid column. Each rank owns n / g contiguous outer
grid rows, and `grid_sum` adds the ranks' shares of a sweep exactly and
in rank order, so every grid rank gets the same bits.

The reductions (`max`, `all`, `any`, `sum`) and `broadcast_object` use
only `all_reduce` and `broadcast`, the two collectives that both NCCL and
gloo serve on CUDA tensors. Without a process group (one process) they
return their input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

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


@dataclass(frozen=True)
class GridMesh:
    """One rank's view of a ('days', 'grid') mesh of `shape` (d, g):
    `rank` in the world, `grid_group` (the g ranks of its day row; None
    without a process group), `day_mesh` (a `DayMesh` over the d ranks
    of its grid column, rank r // g of them), the world's `group` and the
    rank's `device`."""

    shape: Tuple[int, int]
    rank: int
    grid_group: Optional[Any]
    day_mesh: DayMesh
    group: Optional[Any]
    device: torch.device

    @property
    def grid_size(self) -> int:
        return self.shape[1]

    @property
    def grid_rank(self) -> int:
        return self.rank % self.shape[1]

    def rows(self, n: int):
        """This rank's outer grid rows [i0, i1) of n: blocks of n / g.
        Raises JAX's "not divisible" when g does not divide n."""
        g = self.grid_size
        if int(n) % g:
            raise ValueError(f"num_points {n} not divisible by the mesh's "
                             f"{g}-device grid axis")
        block = int(n) // g
        return self.grid_rank * block, (self.grid_rank + 1) * block

    def grid_sum(self, t):
        """The sum of every grid rank's `t` on every grid rank, exact and
        in rank order: an all_reduce SUM of zero-filled (g, ...) buffers,
        each rank's slot holding its `t` (x + 0 = x), then the slots
        added 0, 1, ..., g - 1, so the result has the same bits on every
        rank whatever order the backend reduces in."""
        if self.grid_group is None:
            return t
        buf = t.new_zeros((self.grid_size,) + tuple(t.shape))
        buf[self.grid_rank] = t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.grid_group)
        out = buf[0]
        for k in range(1, self.grid_size):
            out = out + buf[k]
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable `obj` on every rank of the world."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def _world(device):
    joined = dist.is_initialized()
    size = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    return joined, size, rank, rank_device(device, rank)


def _need_world(what, size):
    raise ValueError(
        f"{what} but the world has {size} rank(s): the port runs one "
        "process per device, so launch that many ranks (torchrun "
        "--nproc-per-node, or parallel.distributed.run_world) and call "
        "distributed.initialize() in each")


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis_names: Tuple[str, ...] = ("days",), shape=None):
    """The mesh over the initialized world, or a world of one process
    when none is (`distributed.initialize` first). `n_devices`, when
    given, must equal the world's size (one device per rank). `device`
    "cuda" gives each rank `cuda:{local_rank % device_count}` (and raises
    without a GPU), "cpu" the CPU.

    axis_names ("days",): a `DayMesh`. ("days", "grid") with `shape`
    (d, g), d * g the world's size: a `GridMesh`, JAX's
    `make_mesh(axis_names=("days", "grid"), shape=(d, g))`; ("grid",)
    the (1, size) `GridMesh`. Every rank creates every process group of
    the mesh, in the same order."""
    joined, size, rank, dev = _world(device)
    if n_devices is not None and int(n_devices) != size:
        _need_world(f"n_devices={n_devices}", size)
    world = dist.group.WORLD if joined else None
    axis_names = tuple(axis_names)
    if axis_names == ("days",):
        return DayMesh(world, rank, size, dev)
    if axis_names == ("grid",):
        shape = (1, size)
    elif axis_names != ("days", "grid"):
        raise ValueError(f"axis_names={axis_names!r}: the port's meshes are "
                         "('days',), ('grid',) and ('days', 'grid')")
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    d, g = (int(v) for v in shape)
    if d < 1 or g < 1 or d * g != size:
        _need_world(f"a ({d}, {g}) mesh", size)
    grid_group = day_group = None
    if joined and d == 1:
        grid_group = world
    elif joined and g == 1:
        day_group = world
    elif joined:
        # every rank creates every group, in the same order
        rows = [dist.new_group([a * g + k for k in range(g)])
                for a in range(d)]
        cols = [dist.new_group([a * g + k for a in range(d)])
                for k in range(g)]
        grid_group, day_group = rows[rank // g], cols[rank % g]
    return GridMesh((d, g), rank, grid_group,
                    DayMesh(day_group, rank // g, d, dev), world, dev)
