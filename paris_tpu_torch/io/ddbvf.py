"""ddbvf volume format — slice-addressable binary volume file.

Byte layout per the reference (src/ddbvf.cpp:45-58):

    u32 magic   = 0xEFDDDAFA
    u16 version = 0x0010
    u32 dim_x, dim_y, dim_z
    u32 offset          (header padding size; data starts at byte 32)
    ... zero padding to byte 32 ...
    float32 voxels, x-minor, slice-major: data[z][y][x]

``write`` is slice-addressed (seek to slice ``first``), which makes each
z-block an independently writable, restartable unit — the property the
reference had but failed to use (its subvolume offset bug, SURVEY.md §5
bug 1: every block landed at slice 0).  Our sink always writes blocks at
their global z offset.

Writes use ``os.pwrite`` so multiple processes/hosts can write disjoint
slice ranges of one file concurrently without a shared lock (the
reference serialized all writers behind a global mutex, sink.cpp:79-81).
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

__all__ = ["create", "open_meta", "write_slices", "read_slices", "read_volume",
           "DDBVF_MAGIC", "DDBVF_VERSION", "DATA_START"]

DDBVF_MAGIC = 0xEFDDDAFA
DDBVF_VERSION = 0x0010
DATA_START = 32
_HEADER_FMT = "<IHIIII"


class DdbvfFormatError(ValueError):
    pass


def create(path: str, dim_x: int, dim_y: int, dim_z: int) -> str:
    """Create (truncate) a ddbvf file, preallocated to full size.

    Unlike the reference (which appends ``.ddbvf`` to the prefix at the
    sink level, sink.cpp:44-55), the caller passes the full path.
    """
    header = struct.pack(
        _HEADER_FMT, DDBVF_MAGIC, DDBVF_VERSION, dim_x, dim_y, dim_z,
        DATA_START - struct.calcsize(_HEADER_FMT),
    )
    header += b"\x00" * (DATA_START - len(header))
    total = DATA_START + 4 * dim_x * dim_y * dim_z
    with open(path, "wb") as f:
        f.write(header)
        f.truncate(total)
    return path


def open_meta(path: str) -> Tuple[int, int, int]:
    """Validate magic/version; return (dim_x, dim_y, dim_z)."""
    with open(path, "rb") as f:
        buf = f.read(DATA_START)
    if len(buf) < struct.calcsize(_HEADER_FMT):
        raise DdbvfFormatError(f"{path}: truncated ddbvf header")
    magic, version, dim_x, dim_y, dim_z, _off = struct.unpack_from(_HEADER_FMT, buf)
    if magic != DDBVF_MAGIC:
        raise DdbvfFormatError(f"{path}: not a ddbvf file (magic {magic:#x})")
    if version != DDBVF_VERSION:
        raise DdbvfFormatError(f"{path}: unsupported ddbvf version {version:#x}")
    return dim_x, dim_y, dim_z


def write_slices(path: str, volume: np.ndarray, first: int) -> None:
    """Write a (dz, dim_y, dim_x) block at slice index ``first``."""
    dim_x, dim_y, dim_z = open_meta(path)
    dz, vy, vx = volume.shape
    if vx != dim_x or vy != dim_y or dz > dim_z:
        raise DdbvfFormatError(
            f"block {vx}x{vy}x{dz} incompatible with file {dim_x}x{dim_y}x{dim_z}"
        )
    if first < 0 or first >= dim_z or first + dz > dim_z:
        raise DdbvfFormatError(f"slice range [{first}, {first + dz}) out of bounds")
    from . import native
    if native.available():
        native.ddbvf_write(path, volume, first)
        return
    payload = np.ascontiguousarray(volume, dtype="<f4").tobytes()
    offset = DATA_START + 4 * dim_x * dim_y * first
    fd = os.open(path, os.O_WRONLY)
    try:
        written = 0
        while written < len(payload):
            written += os.pwrite(fd, payload[written:], offset + written)
    finally:
        os.close(fd)


def read_slices(path: str, first: int, count: int) -> np.ndarray:
    dim_x, dim_y, dim_z = open_meta(path)
    if first < 0 or first + count > dim_z:
        raise DdbvfFormatError(f"slice range [{first}, {first + count}) out of bounds")
    nbytes = 4 * dim_x * dim_y * count
    offset = DATA_START + 4 * dim_x * dim_y * first
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read(nbytes)
    if len(buf) != nbytes:
        raise DdbvfFormatError(f"{path}: truncated volume data")
    return np.frombuffer(buf, dtype="<f4").reshape(count, dim_y, dim_x).copy()


def read_volume(path: str) -> np.ndarray:
    _, _, dim_z = open_meta(path)
    return read_slices(path, 0, dim_z)
