"""Placing and gathering the day axis across ranks (counterpart of
`put_global` / `fetch`, `copula_var_tpu/parallel/multiprocess.py`).

Every rank holds the full replicated host state, as every JAX process
holds the full host copy: `shard_days` slices a rank's block out of it,
and `gather_days` gives every rank the full day axis back. gloo has no
CUDA `all_gather`, so the gather is an `all_reduce`: each rank writes its
block into a zero-filled buffer and the buffers are summed, exact since
x + 0 = x (up to the sign of a zero); bool flags gather under MAX. The
JAX module's remote-tunnel placement has no counterpart.
"""

from __future__ import annotations

import torch

from copula_var_tpu_torch.parallel.mesh import DayMesh


def shard_days(t, mesh: DayMesh, axis: int = 0):
    """This rank's block of the day axis `axis` of the replicated `t`
    (a view)."""
    start, stop = mesh.day_block(t.shape[axis])
    return t.narrow(axis, start, stop - start)


def gather_days(local, mesh: DayMesh, T: int, axis: int = -1):
    """The full day axis (length T) on every rank, from each rank's block
    `local` along `axis`."""
    axis %= local.dim()
    start, stop = mesh.day_block(T)
    if local.shape[axis] != stop - start:
        raise ValueError(
            f"gather_days: rank {mesh.rank} holds {local.shape[axis]} days "
            f"on axis {axis}, its block of T={T} is {stop - start}")
    flags = local.dtype == torch.bool
    shape = list(local.shape)
    shape[axis] = T
    buf = torch.zeros(shape, dtype=torch.int32 if flags else local.dtype,
                      device=local.device)
    buf.narrow(axis, start, stop - start).copy_(local)
    return mesh.any(buf) if flags else mesh.sum(buf)
