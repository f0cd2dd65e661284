"""Process-group set-up and the cross-rank helpers of the distributed path
(port of ``paris_tpu/parallel/multihost.py``).

Every rank:
  * joins the default ``torch.distributed`` group (``initialize``) before
    it queries a device;
  * walks the projection stream's headers but decodes only the frames of
    its own chunk slots (``ProjectionSource(slot_filter=...)``);
  * writes only its own z-slab of each block into the shared ddbvf, at its
    global offset, by positional pwrite (``write_local_shards``).

The collectives here (``barrier``, ``agree_min``) are called from the
main thread only: collectives issued from two threads can be enqueued in
different orders on different ranks, and the run deadlocks.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import traceback
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..io import ddbvf

from ..pipeline import resolve_backend
from .mesh import group_backend, rank_device, world_and_rank

logger = logging.getLogger("paris_tpu_torch.multihost")

__all__ = ["initialize", "shutdown", "is_multihost", "barrier", "agree_min",
           "crash_diagnostics", "write_local_shards"]

# how long the ranks wait for each other to join: a rendezvous that is
# stuck fails instead of hanging
RENDEZVOUS_TIMEOUT = timedelta(seconds=60)
# how long a collective waits for the slowest rank: a block's barrier
# waits for every rank's ddbvf write, which takes minutes at 2048-class
COLLECTIVE_TIMEOUT = timedelta(minutes=30)

_INT64_MAX = np.iinfo(np.int64).max


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "auto") -> torch.device:
    """Create the default process group; returns this rank's device.

    The group's settings come from, in this order: ``coordinator``
    ("HOST:PORT", rank 0 serves the rendezvous there), ``num_processes``
    and ``process_id``; torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); else a group of
    one.  ``backend`` (auto/cuda/torch) picks NCCL on the card or gloo on
    the CPU.  Must run before the first device query.
    """
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    backend, _ = resolve_backend(backend)
    explicit = (coordinator, num_processes, process_id)
    kw = {}
    if any(v is not None for v in explicit):
        if None in explicit:
            raise ValueError("--coordinator, --num-processes and "
                             "--process-id go together")
        host, _, port = coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator {coordinator!r} is not HOST:PORT")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} is not in "
                             f"[0, {num_processes})")
        rank, world = process_id, num_processes
        kw["store"] = dist.TCPStore(host, int(port), world,
                                    is_master=rank == 0,
                                    timeout=RENDEZVOUS_TIMEOUT)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        kw["init_method"] = "env://"
    else:
        rank, world = 0, 1
        kw["store"] = dist.HashStore()
    device = rank_device(backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(group_backend(backend), rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT,
                            **kw)
    logger.info("process group initialized: rank %d of %d (%s) on %s",
                rank, world, dist.get_backend(), device)
    return device


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def barrier(name: str) -> None:
    """Block until every rank reaches this point (a collective, also at
    world size 1)."""
    logger.debug("barrier %s", name)
    dist.barrier()


def agree_min(*values: Optional[int], device: torch.device) -> tuple:
    """Every rank gets the elementwise minimum of ``values`` over the
    ranks: one ``all_reduce(MIN)`` of an int64 tensor on ``device`` (the
    rank's card under NCCL, the CPU under gloo).

    Values probed per rank (free device memory, the budget made from it)
    can differ; fed unagreed into the block planner or the write-overlap
    gate they would give the ranks different block maps or a different
    order of collectives.  None (no information) wins only when no rank
    has a value, as in the JAX package.
    """
    enc = torch.tensor([_INT64_MAX if v is None else int(v) for v in values],
                       dtype=torch.int64, device=device)
    dist.all_reduce(enc, op=dist.ReduceOp.MIN)
    return tuple(None if v == _INT64_MAX else int(v) for v in enc.tolist())


@contextlib.contextmanager
def crash_diagnostics(stage: str, marker_dir: Optional[str] = None):
    """Name the failing rank when a distributed run dies: log ``rank <r>/<n>
    on <host>`` with the exception, drop a ``crash.p<r>.log`` marker into
    ``marker_dir`` when one is given (on a shared filesystem every rank's
    failure is then visible from any host), and re-raise.

    Copied from ``paris_tpu/parallel/multihost.py:crash_diagnostics``,
    with the rank in place of the process index."""
    try:
        yield
    except Exception as e:
        world, rank = world_and_rank() if dist.is_initialized() else (1, 0)
        host = socket.gethostname()
        logger.error(
            "DISTRIBUTED FAILURE in stage %r: rank %d/%d on %s (pid %d): "
            "%s: %s", stage, rank, world, host, os.getpid(),
            type(e).__name__, e)
        if marker_dir:
            try:
                os.makedirs(marker_dir, exist_ok=True)
                with open(os.path.join(marker_dir, f"crash.p{rank}.log"),
                          "w") as f:
                    f.write(f"stage: {stage}\nrank: {rank}/{world}\n"
                            f"host: {host}\npid: {os.getpid()}\n\n")
                    f.write(traceback.format_exc())
            except OSError:
                logger.warning("could not write crash marker to %s",
                               marker_dir)
        raise


def write_local_shards(path: str, slab: torch.Tensor, z0: int,
                       max_z: Optional[int] = None) -> int:
    """Write this rank's (dz, ny, nx) z-slab into the ddbvf at global
    slice ``z0``, stopping before global slice ``max_z``; returns the
    slices written.  Only those slices are copied to the host."""
    dz = slab.shape[0] if max_z is None else min(slab.shape[0], max_z - z0)
    if dz <= 0:
        return 0
    ddbvf.write_slices(path, slab[:dz].cpu().numpy(), z0)
    return dz

