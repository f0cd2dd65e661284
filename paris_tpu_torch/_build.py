"""Builds the sources under ``csrc/`` into shared libraries and loads them.

Each CUDA source (``LIBRARIES``) is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a library of its own with a plain C interface, bound
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The host
I/O library (``HOST_LIBRARIES``: ``csrc/paris_io.cpp``, HIS decode, ddbvf
block I/O and u16 quantization) is compiled the same way with the host
C++ compiler (``c++``), so a machine without ``nvcc`` builds it too.  The
libraries go to ``paris_tpu_torch/_build/`` (listed in ``.gitignore``),
each named by a hash of its source and the flags: the first use after a
change of either rebuilds it.  ``build`` starts one compiler per source,
all at once.  A missing or failing compiler raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["LIBRARIES", "HOST_LIBRARIES", "BUILD_DIR", "NVCC_FLAGS",
           "CXX_FLAGS", "find_nvcc", "find_cxx", "source_path", "build",
           "load_library"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the flags of native/build.sh, which builds the JAX package's copy
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread", "-fno-math-errno", "-Wall", "-Wextra")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> {C function: (argtypes, restype)}; the source is
# csrc/<name>.cu.  Pointers and the stream are c_void_p, so ctypes passes
# them whole.
LIBRARIES: Dict[str, Dict[str, tuple]] = {
    "backproject": {
        "paris_bp_launch": (
            [_i, _p, _p, _p, _i, _p, _p]   # device, stream, buffers
            + [_i] * 11                    # C, n_col, n_row, vp, v_lo,
                                           # dz, ny, nx, rx1, ry1, z0
            + [_f] * 13                    # geometry constants
            + [_i] * 5,                    # shape, copy, pitch, tile_h, smem
            _i),
        # device, shape, bf16, copy, smem
        "paris_bp_blocks_per_sm": ([_i] * 5, _i),
        "paris_bp_shapes": ([_p, _i], _i),
        "paris_bp_ring": ([], _i),
        "paris_bp_error_string": ([_i], ctypes.c_char_p),
    },
    "gather_micro": {
        # device, stream, mode, S, tab, idx, out, blocks
        "paris_gm1_launch": ([_i, _p, _i, _i, _p, _p, _p, _i], _i),
        # device, stream, mode, k0, tab, idx, out, blocks
        "paris_gm2_launch": ([_i, _p, _i, _p, _p, _p, _p, _i], _i),
        "paris_gm_error_string": ([_i], ctypes.c_char_p),
    },
}
_s, _u32, _i64 = ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int64
# the host library; the source is csrc/<name>.cpp.  Every function returns
# 0 or a negative error code (io/native.py names them).
HOST_LIBRARIES: Dict[str, Dict[str, tuple]] = {
    "paris_io": {
        "paris_his_info": ([_s, _p], _i),          # path, HisInfo*
        "paris_his_read": ([_s, _p, _i64], _i),    # path, out, capacity
        "paris_ddbvf_create": ([_s, _u32, _u32, _u32], _i),
        "paris_ddbvf_open": ([_s, _p], _i),        # path, uint32 dims[3]
        "paris_ddbvf_write": ([_s, _p, _u32, _u32], _i),  # path, data, dz, first
        "paris_ddbvf_read": ([_s, _p, _u32, _u32], _i),   # path, out, first, count
        # in, n_frames, frame_elems, out, qparams, n_threads
        "paris_quantize_u16": ([_p, _i64, _i64, _p, _p, _i], _i),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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
        "the CUDA kernels cannot be built")


def find_cxx() -> str:
    """The host C++ compiler: ``c++``, else ``g++``, from PATH."""
    for cxx in ("c++", "g++"):
        found = shutil.which(cxx)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++, g++) on PATH: the I/O "
                       "library cannot be built")


def source_path(name: str) -> str:
    if name in LIBRARIES:
        return os.path.join(_HERE, "csrc", f"{name}.cu")
    if name in HOST_LIBRARIES:
        return os.path.join(_HERE, "csrc", f"{name}.cpp")
    raise ValueError(f"unknown library {name!r}; known: "
                     f"{sorted(LIBRARIES) + sorted(HOST_LIBRARIES)}")


def _flags(name: str) -> tuple:
    return CXX_FLAGS if name in HOST_LIBRARIES else NVCC_FLAGS


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR,
                        f"libparis_{name}_{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None, force: bool = False
          ) -> Dict[str, Tuple[str, float, str]]:
    """Compile the named libraries (all, CUDA and host, by default) unless
    an up-to-date library exists (or ``force``): one compiler per source,
    all started together.  Returns name -> (library path, build seconds,
    compiler log); a CUDA library's log holds ptxas's register and spill
    report."""
    names = list([*LIBRARIES, *HOST_LIBRARIES] if names is None else names)
    done: Dict[str, Tuple[str, float, str]] = {}
    running = {}
    for name in names:
        path = _library_path(name)
        if os.path.exists(path) and not force:
            with open(path + ".log") as f:
                done[name] = (path, 0.0, f.read())
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        compiler = find_cxx() if name in HOST_LIBRARIES else find_nvcc()
        cmd = [compiler, *_flags(name), "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, cmd, path, tmp, time.perf_counter())
    failures = []
    for name, (proc, cmd, path, tmp, t0) in running.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(cmd[0])} failed with exit "
                            f"code {proc.returncode}:"
                            f"\n{' '.join(cmd)}\n{out}{err}")
            continue
        with open(path + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, path)
        done[name] = (path, seconds, out + err)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: done[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``LIBRARIES`` or
    ``HOST_LIBRARIES``), built on first use, with the argtypes and restype
    of each of its functions."""
    with _lock:
        if name not in _libs:
            path, _, _ = build([name])[name]
            lib = ctypes.CDLL(path)
            table = LIBRARIES.get(name) or HOST_LIBRARIES[name]
            for fn, (argtypes, restype) in table.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]
