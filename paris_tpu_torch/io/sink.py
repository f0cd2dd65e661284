"""Volume sink: writes reconstructed z-blocks into one ddbvf file.

Reference equivalent: ``class sink`` (src/sink.cpp:39-94) — which
serialized all writers behind a global mutex and, due to the lost
subvolume offset (SURVEY.md §5 bug 1), wrote every block at slice 0.
Here each block is written at its global z offset via positional
``pwrite`` (no lock needed for disjoint ranges), and a sidecar
completion MANIFEST makes reconstruction restartable per block
(SURVEY.md §5 checkpoint/resume: a task = a restartable unit).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Set

import numpy as np

from . import ddbvf

__all__ = ["VolumeSink"]


def _read_manifest(manifest_path: str, dims: tuple) -> dict:
    """The manifest at ``manifest_path`` when it describes a volume of
    ``dims``, else {}."""
    if not os.path.exists(manifest_path):
        return {}
    with open(manifest_path) as f:
        m = json.load(f)
    return m if tuple(m.get("dims", ())) == dims else {}


class VolumeSink:
    """Create-or-resume a ddbvf output with per-block completion tracking.

    Blocks are marked by index, so the manifest also records the block
    extent they were cut to (``block_dz``, when the writer gives it): a
    resumed job must take the same extent, or its block indices would
    name other slices.  A manifest without the key (written by a sink
    given no extent, as the JAX package's) resumes as before."""

    def __init__(self, output_dir: str, prefix: str, dim_x: int, dim_y: int,
                 dim_z: int, *, resume: bool = False,
                 block_dz: Optional[int] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{prefix}.ddbvf")
        self.manifest_path = self.path + ".manifest.json"
        self.dims = (dim_x, dim_y, dim_z)
        self._done: Set[int] = set()
        self.block_dz = block_dz

        if resume and os.path.exists(self.path):
            if ddbvf.open_meta(self.path) != self.dims:
                raise ValueError(
                    f"existing {self.path} has different dimensions; "
                    "cannot resume")
            m = _read_manifest(self.manifest_path, self.dims)
            recorded = m.get("block_dz")
            if None not in (recorded, block_dz) and recorded != block_dz:
                raise ValueError(
                    f"{self.manifest_path} records blocks of {recorded} "
                    f"slices, not {block_dz}; cannot resume")
            self._done = set(m.get("completed_blocks", []))
            if block_dz is None:
                self.block_dz = recorded
        else:
            ddbvf.create(self.path, dim_x, dim_y, dim_z)
            self._write_manifest()

    @staticmethod
    def recorded_block_dz(output_dir: str, prefix: str, dim_x: int,
                          dim_y: int, dim_z: int) -> Optional[int]:
        """The block extent the manifest of an existing output of these
        dimensions records; None when there is no such output, or its
        manifest records none."""
        path = os.path.join(output_dir, f"{prefix}.ddbvf")
        if not os.path.exists(path):
            return None
        return _read_manifest(path + ".manifest.json",
                              (dim_x, dim_y, dim_z)).get("block_dz")

    @classmethod
    def attach(cls, output_dir: str, prefix: str, dim_x: int, dim_y: int,
               dim_z: int) -> "VolumeSink":
        """Open an EXISTING sink without truncating (multi-host followers).

        On a pod, process 0 creates the shared ddbvf and every other
        process attaches after a barrier; all of them then write their
        own disjoint shard ranges.
        """
        self = cls.__new__(cls)
        self.path = os.path.join(output_dir, f"{prefix}.ddbvf")
        self.manifest_path = self.path + ".manifest.json"
        self.dims = (dim_x, dim_y, dim_z)
        if ddbvf.open_meta(self.path) != self.dims:
            raise ValueError(
                f"existing {self.path} has different dimensions")
        m = _read_manifest(self.manifest_path, self.dims)
        self._done = set(m.get("completed_blocks", []))
        self.block_dz = m.get("block_dz")
        return self

    def _write_manifest(self):
        tmp = self.manifest_path + ".tmp"
        m = {"dims": self.dims, "completed_blocks": sorted(self._done)}
        if self.block_dz is not None:
            m["block_dz"] = self.block_dz
        with open(tmp, "w") as f:
            json.dump(m, f)
        os.replace(tmp, self.manifest_path)

    def is_done(self, block_index: int) -> bool:
        return block_index in self._done

    def write_block(self, block_index: int, volume: np.ndarray, z0: int
                    ) -> None:
        """Write a (dz, dim_y, dim_x) block at global slice z0; mark done.
        The JAX package's sink API, kept for callers that hold a block on
        the host; the jobs drain through ``io/drain.py`` and call
        ``mark_done``."""
        ddbvf.write_slices(self.path, volume, z0)
        self.mark_done(block_index)

    def mark_done(self, block_index: int) -> None:
        """Record block completion (data written through another path)."""
        self._done.add(block_index)
        self._write_manifest()

    @property
    def completed_blocks(self) -> Set[int]:
        return set(self._done)
