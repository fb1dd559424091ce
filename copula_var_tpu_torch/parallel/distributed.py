"""Process groups for day-sharded serving over several GPUs (counterpart
of `copula_var_tpu/parallel/distributed.py`).

The JAX package drives every device of a mesh from one controller and
joins hosts with `jax.distributed.initialize`. The port runs one process
per rank, the PyTorch idiom of one process per card, joined by
`torch.distributed`:

    from copula_var_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()   # a no-op for one process given nothing
    mesh = make_mesh()         # spans the world

Under `torchrun --nproc-per-node N` the rendezvous comes from the
environment (`env://`); elsewhere the caller names `init_method`,
`world_size` and `rank`. `run_world` spawns a world of ranks on this
host and runs one function in each.

The backend is NCCL for CUDA ranks and gloo for the CPU, unless the
caller names one; nothing switches quietly from one to the other. Ranks
that share one card must name gloo: NCCL refuses two ranks on the same
GPU. gloo serves CUDA tensors for `all_reduce` and `broadcast` only,
staged through the host, and the port uses no other collective. Every
group gets a timeout, so a rank that dies fails the others instead of
hanging them.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from copula_var_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


def rank_device(device="cuda", rank=None) -> torch.device:
    """The device of this process's rank: `cuda:{local_rank %
    device_count}` for a CUDA request (local rank from `LOCAL_RANK`, else
    `rank`, else the group's rank, else 0), the CPU for "cpu". A CUDA
    request without a GPU raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif rank is not None:
        local = int(rank)
    else:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout_s=DEFAULT_TIMEOUT_S, device="cuda") -> None:
    """Join this process to the world once. A no-op when a group exists,
    or for one process given nothing (no `init_method`, `world_size` None
    or 1, no `WORLD_SIZE` in the environment). Otherwise
    `init_process_group` with `init_method` (default `env://`, as
    torchrun sets it), the backend (default NCCL for a CUDA `device`,
    gloo for the CPU) and a timeout of `timeout_s` seconds; a CUDA rank
    first makes its `rank_device` current."""
    if dist.is_initialized():
        return
    if (init_method is None and world_size in (None, 1)
            and "WORLD_SIZE" not in os.environ):
        return
    dev = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the world (destroy the default group), if joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> dict:
    """The JAX function's keys. One process serves one device, so
    `local_device_count` is 1 and `global_device_count` the world's
    size."""
    joined = dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_device_count": 1,
        "global_device_count": count,
    }


def _rank_main(rank, fn, args, world_size, init_method, backend, timeout_s,
               device):
    initialize(init_method, world_size, rank, backend, timeout_s, device)
    try:
        fn(*args)
    finally:
        shutdown()


def run_world(fn, world_size: int, args=(), backend=None, device="cuda",
              timeout_s=DEFAULT_TIMEOUT_S) -> None:
    """Spawn `world_size` ranks on this host, join them through a file
    store in a fresh temporary directory, and run `fn(*args)` in each
    (`fn` importable by name: the ranks start from a fresh interpreter).
    Returns when every rank has finished; a rank that raises fails the
    call, and the others are terminated."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.start_processes(
            _rank_main,
            args=(fn, tuple(args), world_size, init, backend, timeout_s,
                  device),
            nprocs=world_size, join=True, start_method="spawn",
        )
