"""ddbvf reader (src/ddbvf.cpp:45-58): a 32-byte header (u32 magic
0xEFDDDAFA, u16 version, u32 dim_x, dim_y, dim_z, u32 offset), then
float32 voxels, x fastest, slice by slice."""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xEFDDDAFA
DATA_START = 32


def read_volume(path: str) -> np.ndarray:
    """The (dim_z, dim_y, dim_x) float32 volume of a ddbvf file."""
    with open(path, "rb") as f:
        magic, _version, nx, ny, nz, _off = struct.unpack(
            "<IHIIII", f.read(struct.calcsize("<IHIIII")))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ddbvf file")
        f.seek(DATA_START)
        data = np.fromfile(f, dtype="<f4", count=nx * ny * nz)
    if data.size != nx * ny * nz:
        raise ValueError(f"{path}: truncated ({data.size} of "
                         f"{nx * ny * nz} voxels)")
    return data.reshape(nz, ny, nx)
