"""ctypes bindings for the port's native I/O libraries
(``paris_tpu_torch/csrc/paris_io.cpp``, a copy of ``native/paris_io.cpp``,
and ``csrc/paris_ingest.cpp``, the raw HIS reader of the ingest stage).

Port of ``paris_tpu/io/native.py``.  The library is built at first use
with the host C++ compiler by ``paris_tpu_torch._build`` (no ``nvcc``
needed) and exposes fast HIS decode (to float32, or raw in the stored
type into a caller's buffer), threaded ddbvf block I/O and the u16
quantizer.  Every entry point answers ``available()`` so callers
(io/his.py, io/ddbvf.py, pipeline.quantize_chunk_u16) can fall back to
the pure-Python implementations — behavior is identical either way; the
native path just decodes/writes without the GIL and in parallel.  A
build that fails (no compiler) is logged once and leaves the fallback.
``PARIS_IO_NO_NATIVE=1`` forces the fallback.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("paris_tpu_torch.io")

OK = 0
_ERRORS = {
    -1: "cannot open file",
    -2: "bad file format",
    -3: "truncated file",
    -4: "out of bounds",
    -5: "I/O error",
}


class _HisInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("frames", ctypes.c_int32),
        ("number_type", ctypes.c_int32),
        ("image_header_size", ctypes.c_int32),
    ]


_lock = threading.Lock()
_state = {}          # library name -> the loaded library, or None


def _library(name: str = "paris_io") -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` (``paris_io``, or ``paris_ingest``, the
    raw HIS reader), built on the first call; None if it cannot be built
    or loaded (the first failure is logged, and not retried)."""
    with _lock:
        if name not in _state:
            _state[name] = None
            from .. import _build
            try:
                _state[name] = _build.load_library(name)
            except (OSError, RuntimeError) as e:
                logger.warning("native library %s unavailable, using the "
                               "pure-Python path: %s", name, e)
        return _state[name]


def available() -> bool:
    if os.environ.get("PARIS_IO_NO_NATIVE") == "1":
        return False
    return _library() is not None


def raw_available() -> bool:
    """Is the raw HIS reader (``his_read_raw``, ``his_read_frames``)
    built?"""
    if os.environ.get("PARIS_IO_NO_NATIVE") == "1":
        return False
    return _library("paris_ingest") is not None


class NativeIoError(OSError):
    def __init__(self, rc: int, path: str):
        super().__init__(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
        self.rc = rc


def his_read(path: str) -> np.ndarray:
    """Native HIS decode -> (frames, height, width) f32."""
    lib = _library()
    info = _HisInfo()
    rc = lib.paris_his_info(path.encode(), ctypes.byref(info))
    if rc != OK:
        raise NativeIoError(rc, path)
    out = np.empty((info.frames, info.height, info.width), dtype=np.float32)
    rc = lib.paris_his_read(path.encode(), out.ctypes.data, out.size)
    if rc != OK:
        raise NativeIoError(rc, path)
    return out


def his_read_raw(path: str, out: np.ndarray) -> None:
    """Native raw HIS read of every frame into ``out`` (C-contiguous, the
    file's raw type: ``his.raw_dtype``)."""
    rc = _library("paris_ingest").paris_his_read_raw(
        path.encode(), out.ctypes.data, out.nbytes)
    if rc != OK:
        raise NativeIoError(rc, path)


def his_read_frames(path: str, number_type: int, image_header_size: int,
                    first: int, out: np.ndarray, n_threads: int = 0) -> None:
    """Native raw read of frames [first, first + len(out)) of a HIS file
    whose header the caller parsed, into ``out`` ((count, h, w),
    C-contiguous, the raw type), without parsing the header again.
    ``n_threads``: 0 = one per hardware thread."""
    count = out.shape[0]
    rc = _library("paris_ingest").paris_his_read_frames(
        path.encode(), number_type, image_header_size,
        out[0].size if count else 1, first, count, out.ctypes.data,
        out.nbytes, n_threads)
    if rc != OK:
        raise NativeIoError(rc, path)


def quantize_u16_available() -> bool:
    return available()


def quantize_u16(chunk: np.ndarray, out: np.ndarray,
                 qparams: np.ndarray, n_threads: int = 0) -> None:
    """Per-frame affine-u16 quantization (fused native two-pass loop).

    ``chunk``: (n, V, H) f32 C-contiguous; ``out``: (>=n, V, H) u16;
    ``qparams``: (>=n, 2) f32 — rows [scale, lo] for the first n frames.
    ``n_threads``: 0 = one per hardware thread; callers running several
    quantize calls concurrently (``pipeline.stage_stream``'s worker
    pool) pass their per-call share to avoid oversubscription.
    """
    n = chunk.shape[0]
    rc = _library().paris_quantize_u16(
        chunk.ctypes.data, n, chunk.size // n, out.ctypes.data,
        qparams.ctypes.data, n_threads)
    if rc != OK:
        raise NativeIoError(rc, "<quantize>")


def ddbvf_create(path: str, dim_x: int, dim_y: int, dim_z: int) -> None:
    rc = _library().paris_ddbvf_create(path.encode(), dim_x, dim_y, dim_z)
    if rc != OK:
        raise NativeIoError(rc, path)


def ddbvf_open(path: str) -> Tuple[int, int, int]:
    dims = (ctypes.c_uint32 * 3)()
    rc = _library().paris_ddbvf_open(path.encode(), dims)
    if rc != OK:
        raise NativeIoError(rc, path)
    return tuple(int(d) for d in dims)


def ddbvf_write(path: str, volume: np.ndarray, first: int) -> None:
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    rc = _library().paris_ddbvf_write(path.encode(), vol.ctypes.data,
                                      vol.shape[0], first)
    if rc != OK:
        raise NativeIoError(rc, path)


def ddbvf_read(path: str, first: int, count: int) -> np.ndarray:
    dims = ddbvf_open(path)
    out = np.empty((count, dims[1], dims[0]), dtype=np.float32)
    rc = _library().paris_ddbvf_read(path.encode(), out.ctypes.data,
                                     first, count)
    if rc != OK:
        raise NativeIoError(rc, path)
    return out
