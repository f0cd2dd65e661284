"""ctypes bindings for the port's native I/O library
(``paris_tpu_torch/csrc/paris_io.cpp``, a copy of ``native/paris_io.cpp``).

Port of ``paris_tpu/io/native.py``.  The library is built at first use
with the host C++ compiler by ``paris_tpu_torch._build`` (no ``nvcc``
needed) and exposes fast HIS decode, threaded ddbvf block I/O and the
u16 quantizer.  Every entry point answers ``available()`` so callers
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
_state = {"tried": False, "lib": None}


def _library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None if it cannot be
    built or loaded (the first failure is logged, and not retried)."""
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            from .. import _build
            try:
                _state["lib"] = _build.load_library("paris_io")
            except (OSError, RuntimeError) as e:
                logger.warning("native I/O library unavailable, using the "
                               "pure-Python path: %s", e)
        return _state["lib"]


def available() -> bool:
    if os.environ.get("PARIS_IO_NO_NATIVE") == "1":
        return False
    return _library() is not None


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
