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


class VolumeSink:
    """Create-or-resume a ddbvf output with per-block completion tracking."""

    def __init__(self, output_dir: str, prefix: str, dim_x: int, dim_y: int,
                 dim_z: int, *, resume: bool = False):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{prefix}.ddbvf")
        self.manifest_path = self.path + ".manifest.json"
        self.dims = (dim_x, dim_y, dim_z)
        self._done: Set[int] = set()

        if resume and os.path.exists(self.path):
            if ddbvf.open_meta(self.path) != self.dims:
                raise ValueError(
                    f"existing {self.path} has different dimensions; "
                    "cannot resume")
            if os.path.exists(self.manifest_path):
                with open(self.manifest_path) as f:
                    m = json.load(f)
                if tuple(m.get("dims", ())) == self.dims:
                    self._done = set(m.get("completed_blocks", []))
        else:
            ddbvf.create(self.path, dim_x, dim_y, dim_z)
            self._write_manifest()

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
        self._done = set()
        if ddbvf.open_meta(self.path) != self.dims:
            raise ValueError(
                f"existing {self.path} has different dimensions")
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                m = json.load(f)
            if tuple(m.get("dims", ())) == self.dims:
                self._done = set(m.get("completed_blocks", []))
        return self

    def _write_manifest(self):
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"dims": self.dims,
                       "completed_blocks": sorted(self._done)}, f)
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
