"""Distributed FDK: the volume block sharded over the ranks in z, the
projections all-gathered (port of ``paris_tpu/parallel/dist.py``).

Per step, mirroring the JAX package's shard step (``dist.py:186-222``):
  1. rank r owns chunk slots [r*C/n, (r+1)*C/n) (``owned_slots``) and
     stages only those frames: in fast mode it quantizes u16 only over
     them;
  2. it cuts the detector-row band, dequantizes, weights and filters its
     frames;
  3. ``all_gather_into_tensor`` gives every rank the whole banded,
     filtered chunk (bf16 in fast mode, float32 in exact mode), with its
     sines and cosines; the collective carries only the rows the block
     can sample;
  4. each rank backprojects all C frames into its own (dz/n, ny, nx)
     slab, at global z ``z0 + r*dz/n``.

The JAX package's Pallas path shards y instead, because its kernel
layout keeps z padded to 128 per shard (``dist.py:7-12``); this
accumulator is the unpadded (dz, ny, nx) layout, so a rank's z-slab is
contiguous in the ddbvf and is written with one pwrite
(``multihost.write_local_shards``).  The kernel takes the slab's z
offset as it takes a block's, so sharding costs the kernel nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import DetectorGeometry, VolumeGeometry

from ..ops.backprojection_cuda import backproject_chunk
from ..pipeline import (Reconstructor, _STAGE_WORKERS, identity_qparams,
                        quantize_chunk_u16)
from . import multihost
from .mesh import group_backend, world_and_rank

__all__ = ["DistributedReconstructor", "owned_slots"]


def owned_slots(rank: int, world: int, chunk_size: int) -> Tuple[int, int]:
    """The [lo, hi) chunk slots of ``rank``: slots are dealt out blockwise,
    C/n to each rank.  Raises ValueError when ``world`` does not divide
    ``chunk_size``."""
    if chunk_size % world:
        raise ValueError(f"chunk_size {chunk_size} not divisible by the "
                         f"world size {world}")
    local = chunk_size // world
    return rank * local, (rank + 1) * local


class DistributedReconstructor(Reconstructor):
    """FDK over the ranks of ``group`` (default: the default group): the
    volume block sharded in z, the projections gathered.

    ``block_shape`` is the (dz, ny, nx) block, dz (default: the volume's)
    divisible by the world size; ``chunk_size`` the projections per step,
    divisible by it too.  ``device`` is the rank's: a card under an NCCL
    group, the CPU under gloo.  The rest is ``Reconstructor``'s.
    """

    def __init__(
        self,
        det: DetectorGeometry,
        vol: VolumeGeometry,
        *,
        chunk_size: int = 16,
        block_shape: Optional[Tuple[int, int, int]] = None,  # (dz, ny, nx)
        backend: str = "auto",
        v_band_width: Optional[int] = None,
        accuracy: str = "exact",
        group=None,
        device=None,
    ):
        self.group = group
        self.world, self.rank = world_and_rank(group)
        block_shape = tuple(block_shape or vol.shape_zyx)
        if block_shape[0] % self.world:
            raise ValueError(f"block dz {block_shape[0]} not divisible by "
                             f"the world size {self.world}")
        self.local_dz = block_shape[0] // self.world
        self._slots = owned_slots(self.rank, self.world, int(chunk_size))
        super().__init__(det, vol, chunk_size=chunk_size,
                         block_shape=block_shape, backend=backend,
                         accuracy=accuracy, device=device,
                         v_band_width=v_band_width)
        want = group_backend(self.backend)
        if dist.get_backend(group) != want:
            raise ValueError(f"a reconstruction on {self.device} needs a "
                             f"{want} process group, not "
                             f"{dist.get_backend(group)}")

    def init_block(self) -> torch.Tensor:
        """This rank's (dz/n, ny, nx) slab of a block."""
        _, ny, nx = self.block_shape
        return torch.zeros((self.local_dz, ny, nx), dtype=torch.float32,
                           device=self.device)

    def stage_chunk(self, chunk, ang):
        """Start the host-to-device copy of this rank's slots of one
        (chunk, angles) pair; the other ranks' rows are never read (they
        may be zero rows that were not decoded)."""
        lo, hi = self._slots
        chunk = np.asarray(chunk, dtype=np.float32)
        ang = np.asarray(ang, dtype=np.float32)
        if ang.shape[0] < self.chunk_size:
            ang = np.pad(ang, (0, self.chunk_size - ang.shape[0]))
        own = chunk[lo:hi]
        if self.accuracy == "fast" and own.shape[0]:
            own, qparams = quantize_chunk_u16(
                np.ascontiguousarray(own), hi - lo,
                concurrency=_STAGE_WORKERS)
        elif self.accuracy == "fast":       # past the stream's end
            own = np.zeros((hi - lo,) + chunk.shape[1:], np.uint16)
            qparams = np.zeros((hi - lo, 2), np.float32)
        else:
            qparams = identity_qparams(hi - lo)
            own = np.pad(own, ((0, hi - lo - own.shape[0]), (0, 0), (0, 0)))
        phi = np.deg2rad(ang[lo:hi]).astype(np.float32)
        return tuple(self._put(a) for a in
                     (own, np.sin(phi), np.cos(phi), qparams))

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def step_staged(self, volume: torch.Tensor, staged, *,
                    z_offset: int = 0,
                    roi_offset: Tuple[int, int, int] = (0, 0, 0)
                    ) -> torch.Tensor:
        """Accumulate one staged chunk into this rank's slab IN PLACE.
        Runs three collectives: call it from one thread only."""
        chunk, sin, cos, qparams = staged
        rx1, ry1, rz1 = roi_offset
        z0 = rz1 + z_offset
        filtered, v_lo = self._filter_band(chunk, qparams, z0)
        return backproject_chunk(
            volume, self._gather(filtered), self._gather(sin),
            self._gather(cos), self.grid,
            z_offset=z0 + self.rank * self.local_dz,
            roi_offset=(rx1, ry1, 0), v_lo=v_lo)

    def write_shards(self, volume: torch.Tensor, path: str, z_base: int,
                     dim_z_valid: int) -> int:
        """Write this rank's slab of the block at global slice ``z_base``
        into the ddbvf, up to the block's ``dim_z_valid`` slices."""
        return multihost.write_local_shards(
            path, volume, z_base + self.rank * self.local_dz,
            max_z=z_base + dim_z_valid)

    def finalize(self, volume: torch.Tensor) -> np.ndarray:
        """The block as a (dz, ny, nx) ndarray; one rank holds it only at
        world size 1 (else use ``write_shards``)."""
        if self.world > 1:
            raise RuntimeError(
                "finalize() needs the whole block, which one rank holds only "
                "at world size 1; use write_shards()")
        return super().finalize(volume)

    def reconstruct(self, projections, angles_deg, **kw) -> np.ndarray:
        out = self.accumulate(self.init_block(), projections, angles_deg, **kw)
        return self.finalize(out)[: self.vol.dim_z]
