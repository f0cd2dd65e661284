"""Builds ``csrc/backproject.cu`` into a shared library and loads it.

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
library with a plain C interface, bound with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  The library goes to
``paris_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags: the first use after a change of either
rebuilds it.  A missing or failing ``nvcc`` raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build",
           "load_library"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "backproject.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``nvcc`` from PATH, else under $CUDA_HOME / $CUDA_PATH, else the
    CUDA toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, $CUDA_PATH, /usr/local/cuda): "
        "the backprojection kernel cannot be built")


def _library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libparis_bp_{digest.hexdigest()[:16]}.so")


def build(force: bool = False) -> Tuple[str, float, str]:
    """Compile the kernel unless an up-to-date library exists (or
    ``force``).  Returns (library path, build seconds, compiler log);
    the log holds ptxas's register and spill report."""
    path = _library_path()
    log_path = path + ".log"
    if os.path.exists(path) and not force:
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return path, seconds, log


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(path)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.paris_bp_launch.argtypes = (
                [i, p, p, p, i, p, p]          # device, stream, buffers
                + [i] * 9                      # C, n_col, n_row, dz, ny, nx, rx1, ry1, z0
                + [f] * 13)                    # geometry constants
            lib.paris_bp_launch.restype = i
            lib.paris_bp_error_string.argtypes = [i]
            lib.paris_bp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
