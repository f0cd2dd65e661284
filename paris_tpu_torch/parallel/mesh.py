"""The ranks of the distributed path (the counterpart of
``paris_tpu/parallel/mesh.py``).

The JAX package runs one controller per host over a 1-D device mesh
(``make_z_mesh``).  PyTorch's idiom is one process per card: rank r owns
one card and the ranks share a ``torch.distributed`` group, over NCCL
when the backend is the CUDA kernel and over gloo for the plain PyTorch
backend on the CPU.  The volume's z axis is sharded over the ranks.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["world_and_rank", "rank_device", "group_backend"]


def world_and_rank(group=None) -> Tuple[int, int]:
    """(world size, this process's rank) of ``group`` (default: the
    default group, which must exist)."""
    return dist.get_world_size(group), dist.get_rank(group)


def rank_device(backend: str, rank: int) -> torch.device:
    """The device of ``rank`` for a resolved backend: ``cuda:LOCAL_RANK``
    (as torchrun sets it; else rank modulo the cards this host sees) for
    ``cuda``, the CPU for ``torch``."""
    if backend != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        rank % max(1, torch.cuda.device_count())
    return torch.device("cuda", index)


def group_backend(backend: str) -> str:
    """The ``torch.distributed`` backend for a resolved backend."""
    return "nccl" if backend == "cuda" else "gloo"
