"""HIS detector-image format: reader and writer.

Byte layout per the reference reader (src/his.cpp:46-67,105-198):

  file header, 68 bytes, little-endian, packed:
      u16 file_type          == 0x7000
      u16 header_size        == 68
      u16 header_version
      u32 file_size
      u16 image_header_size
      u16 ulx, uly, brx, bry (inclusive bounding box; w = brx-ulx+1)
      u16 frame_number
      u16 correction
      f64 integration_time
      u16 number_type        (2=u8, 4=u16, 32=u32, 64=f64, 128=f32)
      34 bytes padding
  then per frame: image_header_size bytes (skipped) + w*h pixels.

All frames are converted to float32 (reference his.cpp:166-191).  The
writer exists for round-trip tests and for generating synthetic scans —
the reference has no writer.

If the native IO library (native/paris_io.cpp) is built, bulk pixel
decode is delegated to it; otherwise NumPy does the conversion.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

__all__ = ["HisHeader", "read_his", "read_his_selective", "write_his",
           "HIS_FILE_ID"]

# observability: frames actually pixel-decoded by this process (the
# multi-host disjoint-read path asserts each host decodes only its
# chunk shard's frames; tests/test_multihost_2proc.py)
DECODE_STATS = {"frames": 0}

HIS_FILE_ID = 0x7000
_FILE_HEADER_SIZE = 68
_HEADER_FMT = "<HHHIHHHHHHHdH"  # up to number_type; then 34 pad bytes
_HEADER_FMT_SIZE = struct.calcsize(_HEADER_FMT)  # 34

_NUMBER_TYPES = {
    2: np.uint8,
    4: np.uint16,
    32: np.uint32,
    64: np.float64,
    128: np.float32,
}
_DTYPE_TO_NUMBER_TYPE = {np.dtype(v): k for k, v in _NUMBER_TYPES.items()}


@dataclasses.dataclass
class HisHeader:
    header_version: int
    image_header_size: int
    ulx: int
    uly: int
    brx: int
    bry: int
    frame_number: int
    correction: int
    integration_time: float
    number_type: int

    @property
    def width(self) -> int:
        return self.brx - self.ulx + 1

    @property
    def height(self) -> int:
        return self.bry - self.uly + 1


class HisFormatError(ValueError):
    pass


def _parse_header(buf: bytes, path: str) -> HisHeader:
    if len(buf) < _FILE_HEADER_SIZE:
        raise HisFormatError(f"{path}: truncated HIS header")
    (file_type, header_size, header_version, _file_size, image_header_size,
     ulx, uly, brx, bry, frame_number, correction, integration_time,
     number_type) = struct.unpack_from(_HEADER_FMT, buf, 0)
    if file_type != HIS_FILE_ID:
        raise HisFormatError(f"{path}: not a HIS file (magic {file_type:#x})")
    if header_size != _FILE_HEADER_SIZE:
        raise HisFormatError(f"{path}: header size mismatch ({header_size})")
    if number_type not in _NUMBER_TYPES:
        raise HisFormatError(f"{path}: unsupported number_type {number_type}")
    return HisHeader(
        header_version, image_header_size, ulx, uly, brx, bry,
        frame_number, correction, integration_time, number_type,
    )


def read_his_header(path: str) -> HisHeader:
    """Parse just the 68-byte file header (cheap frame/shape probe)."""
    with open(path, "rb") as f:
        return _parse_header(f.read(_FILE_HEADER_SIZE), path)


def read_his(path: str) -> np.ndarray:
    """Read a HIS file -> (frames, height, width) float32 array."""
    from . import native
    if native.available():
        try:
            frames = native.his_read(path)
            DECODE_STATS["frames"] += frames.shape[0]
            return frames
        except native.NativeIoError as e:
            if e.rc in (-2, -3):          # format errors -> HisFormatError
                raise HisFormatError(str(e)) from e
            raise
    with open(path, "rb") as f:
        data = f.read()
    header = _parse_header(data, path)
    w, h = header.width, header.height
    dtype = np.dtype(_NUMBER_TYPES[header.number_type]).newbyteorder("<")
    frame_bytes = w * h * dtype.itemsize

    frames = np.empty((header.frame_number, h, w), dtype=np.float32)
    pos = _FILE_HEADER_SIZE
    for i in range(header.frame_number):
        pos += header.image_header_size
        end = pos + frame_bytes
        if end > len(data):
            raise HisFormatError(f"{path}: truncated frame {i}")
        frames[i] = (
            np.frombuffer(data, dtype=dtype, count=w * h, offset=pos)
            .reshape(h, w)
            .astype(np.float32)
        )
        pos = end
    DECODE_STATS["frames"] += header.frame_number
    return frames


def read_his_selective(path: str, want) -> tuple:
    """Read a HIS file decoding ONLY the frames ``want(j)`` asks for.

    Returns ``(n_frames, frames_dict)`` where ``frames_dict`` maps frame
    index -> (h, w) float32 array for wanted frames only.  Skipped
    frames cost a seek, not a pixel decode — the multi-host input path
    uses this so each host only decodes the frames of its chunk shard
    (reference analog: every worker decoded the whole stream,
    src/source.cpp:88-130; at pod scale that makes input bandwidth
    independent of host count).
    """
    with open(path, "rb") as f:
        header = _parse_header(f.read(_FILE_HEADER_SIZE), path)
        w, h = header.width, header.height
        dtype = np.dtype(_NUMBER_TYPES[header.number_type]).newbyteorder("<")
        frame_bytes = w * h * dtype.itemsize
        out = {}
        for i in range(header.frame_number):
            f.seek(header.image_header_size, 1)
            if want(i):
                buf = f.read(frame_bytes)
                if len(buf) < frame_bytes:
                    raise HisFormatError(f"{path}: truncated frame {i}")
                out[i] = (np.frombuffer(buf, dtype=dtype)
                          .reshape(h, w).astype(np.float32))
                DECODE_STATS["frames"] += 1
            else:
                f.seek(frame_bytes, 1)
        # a trailing seek past EOF does not raise; validate total length
        if f.seek(0, 2) < (_FILE_HEADER_SIZE + header.frame_number
                           * (header.image_header_size + frame_bytes)):
            raise HisFormatError(f"{path}: truncated file")
    return header.frame_number, out


def write_his(
    path: str,
    frames: np.ndarray,
    *,
    number_dtype=np.float32,
    image_header_size: int = 32,
    integration_time: float = 0.0,
) -> None:
    """Write (frames, height, width) to a HIS file (reference-compatible)."""
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    n, h, w = frames.shape
    dtype = np.dtype(number_dtype)
    if dtype not in _DTYPE_TO_NUMBER_TYPE:
        raise HisFormatError(f"unsupported dtype {dtype}")
    number_type = _DTYPE_TO_NUMBER_TYPE[dtype]
    file_size = (
        _FILE_HEADER_SIZE + n * (image_header_size + w * h * dtype.itemsize)
    )
    header = struct.pack(
        _HEADER_FMT,
        HIS_FILE_ID, _FILE_HEADER_SIZE, 100, file_size, image_header_size,
        0, 0, w - 1, h - 1, n, 0, float(integration_time), number_type,
    )
    header += b"\x00" * (_FILE_HEADER_SIZE - len(header))
    with open(path, "wb") as f:
        f.write(header)
        img_hdr = b"\x00" * image_header_size
        for i in range(n):
            f.write(img_hdr)
            f.write(np.ascontiguousarray(frames[i], dtype=dtype).tobytes())
