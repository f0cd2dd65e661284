"""Wrapper of the hand-written CUDA backprojection kernel
(``csrc/backproject.cu``, the port of the Pallas kernel
``paris_tpu/ops/backprojection_pallas.py:_bp_kernel``), and the
dispatcher the pipeline calls.

``backproject_chunk_cuda`` checks its tensors, launches the kernel on the
current stream and raises if the launch was refused.  It never falls back
to the plain version; ``backproject_chunk`` sends CPU tensors there, and
CUDA tensors to the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .backprojection_torch import (BpGrid, backproject_chunk_torch,
                                   kernel_constants)

__all__ = ["backproject_chunk_cuda", "backproject_chunk"]


def _check(volume, projections, sin_phi, cos_phi, grid, v_lo):
    dev = volume.device
    if dev.type != "cuda":
        raise ValueError(f"backproject_chunk_cuda needs CUDA tensors, "
                         f"got a volume on {dev}")
    if volume.dtype != torch.float32 or volume.dim() != 3:
        raise ValueError(f"volume must be (dz, ny, nx) float32, got "
                         f"{tuple(volume.shape)} {volume.dtype}")
    if projections.dtype not in (torch.float32, torch.bfloat16) \
            or projections.dim() != 3:
        raise ValueError(f"projections must be (C, vp, n_row) float32 "
                         f"or bfloat16, got {tuple(projections.shape)} "
                         f"{projections.dtype}")
    C, vp, n_row = projections.shape
    n_col = grid.det.n_col
    if C < 1 or vp < 2 or n_row < 2:
        raise ValueError(f"projections shape {tuple(projections.shape)} "
                         "needs C >= 1 and a band of at least 2 x 2")
    if n_row != grid.det.n_row:
        raise ValueError(f"projections have {n_row} columns, the detector "
                         f"{grid.det.n_row}")
    if not 0 <= v_lo <= n_col - vp:
        raise ValueError(f"band of {vp} rows from v_lo={v_lo} does not lie "
                         f"on the detector's {n_col} rows")
    for name, a in (("sin_phi", sin_phi), ("cos_phi", cos_phi)):
        if a.dtype != torch.float32 or tuple(a.shape) != (C,):
            raise ValueError(f"{name} must be ({C},) float32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for name, a in (("volume", volume), ("projections", projections),
                    ("sin_phi", sin_phi), ("cos_phi", cos_phi)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, volume on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def backproject_chunk_cuda(
    volume: torch.Tensor,          # (dz, ny, nx) f32, contiguous, on the card
    projections: torch.Tensor,     # (C, vp, n_row) f32 or bf16, contiguous
    sin_phi: torch.Tensor,         # (C,) f32
    cos_phi: torch.Tensor,         # (C,) f32
    grid: BpGrid,
    z_offset: int = 0,
    roi_offset: Tuple[int, int, int] = (0, 0, 0),
    v_lo: int = 0,                 # detector row of the band's first row
) -> torch.Tensor:
    """Accumulate C projections (detector rows [v_lo, v_lo + vp)) into
    ``volume`` IN PLACE with the kernel; returns ``volume``.  Adds one to
    ``backproject_chunk_cuda.launches`` per launch."""
    v_lo = int(v_lo)
    _check(volume, projections, sin_phi, cos_phi, grid, v_lo)
    dz, ny, nx = volume.shape
    C, vp, n_row = projections.shape
    rx1, ry1, rz1 = roi_offset
    k = kernel_constants(grid)
    lib = _build.load_library("backproject")
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    rc = lib.paris_bp_launch(
        volume.device.index, stream, volume.data_ptr(),
        projections.data_ptr(), int(projections.dtype == torch.bfloat16),
        sin_phi.data_ptr(), cos_phi.data_ptr(),
        C, grid.det.n_col, n_row, vp, v_lo, dz, ny, nx,
        int(rx1), int(ry1), int(rz1 + z_offset),
        k["off_x"], k["off_y"], k["off_z"],
        k["l_vx_x"], k["l_vx_y"], k["l_vx_z"],
        k["d_so"], k["d_sd"], k["safe_min"],
        k["h_min"], k["inv_lpr"], k["inv_lpc"], k["vb"])
    if rc != 0:
        raise RuntimeError(
            f"backprojection kernel launch failed: CUDA error {rc} "
            f"({lib.paris_bp_error_string(rc).decode()})")
    backproject_chunk_cuda.launches += 1
    return volume


backproject_chunk_cuda.launches = 0


def backproject_chunk(volume, projections, sin_phi, cos_phi, grid,
                      z_offset: int = 0,
                      roi_offset: Tuple[int, int, int] = (0, 0, 0),
                      v_lo: int = 0) -> torch.Tensor:
    """In-place backprojection of one chunk: the CUDA kernel for tensors
    on the card, the plain PyTorch version for tensors on the CPU."""
    if volume.device.type == "cuda":
        return backproject_chunk_cuda(volume, projections, sin_phi, cos_phi,
                                      grid, z_offset, roi_offset, v_lo)
    if volume.device.type == "cpu":
        return backproject_chunk_torch(volume, projections, sin_phi, cos_phi,
                                       grid, z_offset, roi_offset, v_lo)
    raise ValueError(f"no backprojection for device {volume.device}")
