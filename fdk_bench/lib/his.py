"""HIS writer (the reference's reader layout, src/his.cpp:46-67): a
68-byte file header, then per frame a 32-byte image header and its
pixels.  A frozen copy of the repository's writer, for uint16 frames."""

from __future__ import annotations

import os
import struct

import numpy as np

HIS_FILE_ID = 0x7000
FILE_HEADER = 68
IMAGE_HEADER = 32
_FMT = "<HHHIHHHHHHHdH"
NUMBER_TYPE_U16 = 4


def his_bytes(n: int, h: int, w: int) -> int:
    """Bytes of a file of ``n`` uint16 frames of h x w."""
    return FILE_HEADER + n * (IMAGE_HEADER + 2 * h * w)


def write_his_u16(path: str, frames: np.ndarray) -> int:
    """Write (n, h, w) uint16 ``frames`` to ``path`` and fsync it, so that
    its writeback is over when this returns; returns the bytes written."""
    n, h, w = frames.shape
    size = his_bytes(n, h, w)
    header = struct.pack(_FMT, HIS_FILE_ID, FILE_HEADER, 100, size,
                         IMAGE_HEADER, 0, 0, w - 1, h - 1, n, 0, 0.0,
                         NUMBER_TYPE_U16)
    header += b"\x00" * (FILE_HEADER - len(header))
    with open(path, "wb") as f:
        f.write(header)
        for i in range(n):
            f.write(b"\x00" * IMAGE_HEADER)
            f.write(np.ascontiguousarray(frames[i], np.uint16).tobytes())
        f.flush()
        os.fsync(f.fileno())
    return size
