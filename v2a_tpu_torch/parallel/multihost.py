"""Multi-process start-up and the hybrid (nodes x ranks) mesh.

Counterpart of `v2a_tpu/parallel/multihost.py`. JAX's `jax.distributed`
becomes `torch.distributed.init_process_group`: under `torchrun` its
environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`) names the
cluster; a single process without it stays a single process. The JAX mesh
whose outer axis is DCN (across slices) and inner axis ICI becomes nodes on
the outer axis and the ranks of one node (`LOCAL_WORLD_SIZE`, NVLink) on
the inner one. `spawn_ranks` starts n local ranks on a file store (the
tests' gloo worlds, the card's NCCL ones) with no fixed port.
"""

from __future__ import annotations

import gc
import logging
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from v2a_tpu_torch.device import DeviceLike
from v2a_tpu_torch.parallel.mesh import Mesh, backend_of, make_mesh, rank_device

_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """`init_process_group` on this rank's device's backend (NCCL on the
    card, gloo with `device="cpu"`); `False` in a single process with no
    cluster environment (all arguments None and no `torchrun` variables).
    A partial or wrong cluster environment raises, as does a failed
    rendezvous. `coordinator_address` is `host:port` of rank 0."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not any(k in os.environ for k in _CLUSTER_ENV):
            logging.getLogger(__name__).info(
                "torch.distributed not initialized (single process: no cluster environment)")
            return False
        missing = [k for k in _CLUSTER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"incomplete cluster environment: {missing} not set")
        dev = rank_device(device)
        dist.init_process_group(backend_of(dev), init_method="env://", device_id=(
            dev if dev.type == "cuda" else None))
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("coordinator_address, num_processes and process_id go together")
    dev = rank_device(device)
    dist.init_process_group(backend_of(dev), init_method=f"tcp://{coordinator_address}",
                            rank=int(process_id), world_size=int(num_processes))
    return True


def make_hybrid_mesh(
    ici_axis: str = "dp_ici",
    dcn_axis: str = "dp_dcn",
    device: DeviceLike = None,
) -> Mesh:
    """2-D (nodes x ranks of a node) mesh: the outer axis over nodes
    (`LOCAL_WORLD_SIZE` ranks a node, torchrun's), the inner over one node's
    ranks. Batches split over BOTH axes for pure data parallelism."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_node < 1 or world % per_node:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_node} does not divide the world {world}")
    return make_mesh((dcn_axis, ici_axis), (world // per_node, per_node), device=device)


def _rank_main(rank: int, world: int, store: str, device: str, fn: Callable, args) -> None:
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dev = rank_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend_of(dev), init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        # the groups' last references may sit in reference cycles: a group
        # freed only at interpreter exit aborts the process (its threads)
        gc.collect()


def spawn_ranks(fn: Callable, world: int, store: str, args: tuple = (),
                device: str = "cpu") -> None:
    """Run `fn(rank, *args)` on `world` spawned ranks of one process group
    (gloo on the CPU, one card a rank with NCCL on `device="cuda"`), its
    rendezvous a file `store` that must not exist yet. `fn` is a module-level
    function; the ranks import only what unpickling it needs (the parent's
    main module is hidden). A rank's exception fails the call."""
    import torch.multiprocessing as mp

    from v2a_tpu_torch.envs.subproc import _bare_main

    if os.path.exists(store):
        raise FileExistsError(store)
    with _bare_main():
        ctx = mp.spawn(_rank_main, args=(world, store, device, fn, tuple(args)),
                       nprocs=world, join=False)
    while not ctx.join():
        pass
