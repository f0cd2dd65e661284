"""Wrapper of the hand-written CUDA backprojection kernel
(``csrc/backproject.cu``, the port of the Pallas kernel
``paris_tpu/ops/backprojection_pallas.py:_bp_kernel``), its tile planner,
and the dispatcher the pipeline calls.

The kernel stages, per thread block and angle, the detector rectangle its
voxels read into a ring of shared-memory tiles.  ``plan_tile`` bounds that
rectangle on the host for every block and angle of a launch, from the
geometry alone, and picks the largest compiled block shape whose ring
fits a block's shared memory; where none fits, the kernel's ``COPY_GLOBAL``
instantiation, which reads its taps from global memory.
``backproject_chunk_cuda`` checks its tensors, plans, launches the kernel
on the current stream and raises if the launch was refused.  It never
falls back to the plain version; ``backproject_chunk`` sends CPU tensors
there, and CUDA tensors to the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..utils.profiling import span
from .backprojection_torch import (BpGrid, backproject_chunk_torch,
                                   kernel_constants)

__all__ = ["SHAPES", "RING", "SMEM_LIMIT", "FAST_PITCH", "COPY_ELEMENT",
           "COPY_ASYNC", "COPY_GLOBAL", "COPY_NAMES", "TilePlan", "plan_tile",
           "launch_plan",
           "backproject_chunk_cuda", "backproject_chunk", "blocks_per_sm",
           "compiled_shapes"]

# The compiled block shapes (BX, BY, ZR) of csrc/backproject.cu, largest
# first (its paris_bp_shapes), and the tiles in its ring (paris_bp_ring).
SHAPES = ((32, 8, 16), (32, 4, 8))
RING = 3
SMEM_LIMIT = 232448          # shared memory one block may use (227 KB)
_VEC = 16                    # bytes per asynchronous copy
_FOOTPRINT = 32              # shared bytes per angle of footprints
# Tile rows start a multiple of 128 B (32 banks) apart, so that the taps
# of a warp's neighbouring columns fall in distinct banks whatever rows
# they read
_ROW_BYTES = 128
# The tile pitch for which the kernel compiles the largest shape's cp.async
# instantiation with a constant pitch (its FAST_PITCH); other pitches take
# the instantiation that reads the launch's pitch
FAST_PITCH = 64
# How a launch's taps reach the projections (the kernel's copy modes):
# staged into the ring element by element or by cp.async, or read from
# global memory where no ring fits (block shape 0, no shared memory).
COPY_ELEMENT, COPY_ASYNC, COPY_GLOBAL = 0, 1, 2
COPY_NAMES = ("element", "async", "global")
# The kernel's floor of h and v is exact below 2^22 pixels
MAX_DETECTOR_SIDE = 1 << 22


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch's tile ring: block shape ``SHAPES[shape]``, copy mode
    ``copy``, tiles of ``tile_h`` rows of ``pitch`` elements, ``smem`` bytes
    of dynamic shared memory.  A ``COPY_GLOBAL`` plan has no ring: its
    "tile" is the whole band (``pitch`` n_row, ``tile_h`` vp)."""
    shape: int
    copy: int
    pitch: int
    tile_h: int
    smem: int


def _tile_bound(grid: BpGrid, dz: int, ny: int, nx: int, z_first: int,
                roi_xy: Tuple[int, int], vp: int, by: int, zr: int
                ) -> Tuple[int, int]:
    """(columns, rows) that the taps of any (32, by, zr) block of the
    launch read for any angle, rotation included.

    Over a block whose voxel centres span a diagonal D in (x, y) and dZ in
    z, inside a volume of radius R about the axis and |z| <= Z: every voxel
    has s + d_so >= d_so - R, so f = d_sd / (s + d_so) <= f_max =
    d_sd / (d_so - R), and f varies by at most d_sd D / (d_so - R)^2.  So
    t f varies by at most D f_max + R d_sd D / (d_so - R)^2 and z f by at
    most dZ f_max + Z d_sd D / (d_so - R)^2.  The kernel stages columns
    floor(h) - 1 .. floor(h) + 2 over its corner voxels' h (one pixel
    each side for the float32 rounding of the other voxels' h), i.e. at
    most floor(width) + 5 columns, and 1 more covers the rounding of the
    corners' own h.  Rows alike.  A volume that reaches within
    1e-3 |d_so| of the source gets the whole band."""
    det, vol = grid.det, grid.vol
    k = kernel_constants(grid)
    rx1, ry1 = roi_xy
    xs = [(rx1 + i) * k["l_vx_x"] + k["off_x"] for i in (0, nx - 1)]
    ys = [(ry1 + j) * k["l_vx_y"] + k["off_y"] for j in (0, ny - 1)]
    zs = [(z_first + i) * k["l_vx_z"] + k["off_z"] for i in (0, dz - 1)]
    R = math.hypot(max(map(abs, xs)), max(map(abs, ys)))
    Z = max(map(abs, zs))
    d_so, d_sd = grid.d_so, grid.d_sd
    full = (det.n_row, vp)
    if not d_so - R > 1e-3 * abs(d_so):
        return full
    D = math.hypot((32 - 1) * vol.l_vx_x, (by - 1) * vol.l_vx_y)
    f_max = d_sd / (d_so - R)
    df = d_sd * D / (d_so - R) ** 2
    w_h = (D * f_max + R * df) / det.l_px_row
    w_v = ((zr - 1) * vol.l_vx_z * f_max + Z * df) / det.l_px_col
    return (min(math.floor(w_h) + 6, det.n_row),
            min(math.floor(w_v) + 6, vp))


def plan_tile(grid: BpGrid, dz: int, ny: int, nx: int, z_first: int,
              roi_xy: Tuple[int, int], vp: int, C: int, elem_bytes: int,
              async_copy: bool) -> TilePlan:
    """The tile ring of one launch: the first of ``SHAPES`` whose ring of
    ``RING`` tiles (plus 32 B per angle of footprints) fits
    ``SMEM_LIMIT``, else a ``COPY_GLOBAL`` plan.  A tile row holds the
    footprint's aligned width; its pitch is rounded up to 128 B where the
    ring still fits.
    ``z_first`` is the global z of the block's first slice; ``elem_bytes``
    the projections' element size; ``async_copy`` says whether rows can be
    copied 16 B at a time.  Raises ValueError, naming the geometry, when
    no ring fits and the band is too large for the kernel's 32-bit tap
    offsets."""
    n_row = grid.det.n_row
    align = _VEC // elem_bytes if async_copy else 1
    head = -(-_FOOTPRINT * C // 128) * 128
    for i, (_, by, zr) in enumerate(SHAPES):
        width, tile_h = _tile_bound(grid, dz, ny, nx, z_first, roi_xy, vp,
                                    by, zr)
        width = min(-(-(width + align - 1) // align) * align,
                    -(-n_row // align) * align)
        row = -(-width * elem_bytes // _ROW_BYTES) * _ROW_BYTES
        for pitch in (row // elem_bytes, width):
            smem = head + RING * tile_h * pitch * elem_bytes
            if smem <= SMEM_LIMIT:
                return TilePlan(i, COPY_ASYNC if async_copy
                                else COPY_ELEMENT, pitch, tile_h, smem)
    if grid.det.n_col * n_row >= 2 ** 31:
        raise ValueError(
            f"no block shape's tile ring fits {SMEM_LIMIT} B of shared "
            f"memory, and detector {grid.det} is too large for the kernel's "
            f"32-bit tap offsets in global memory (volume {grid.vol}, block "
            f"of {dz} slices from z={z_first}, band of {vp} rows)")
    return TilePlan(0, COPY_GLOBAL, n_row, vp, 0)


def launch_plan(grid: BpGrid, volume_shape: Tuple[int, int, int],
                projections: torch.Tensor, z_first: int,
                roi_xy: Tuple[int, int] = (0, 0)) -> TilePlan:
    """``plan_tile`` for a launch on these projections: cp.async copies
    when their rows and their pointer are 16-B aligned."""
    dz, ny, nx = volume_shape
    C, vp, n_row = projections.shape
    esize = projections.element_size()
    return plan_tile(grid, dz, ny, nx, z_first, roi_xy, vp, C, esize,
                     n_row * esize % _VEC == 0
                     and projections.data_ptr() % _VEC == 0)


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
    if max(n_row, n_col) > MAX_DETECTOR_SIDE:
        raise ValueError(f"detector {grid.det} has more than "
                         f"{MAX_DETECTOR_SIDE} pixels a side, beyond the "
                         "kernel's floor of h and v")
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
    plan: Optional[TilePlan] = None,
) -> torch.Tensor:
    """Accumulate C projections (detector rows [v_lo, v_lo + vp)) into
    ``volume`` IN PLACE with the kernel; returns ``volume``.  ``plan``
    (default ``launch_plan``'s) is for holding one copy mode against
    another.  Adds one to ``backproject_chunk_cuda.launches`` per launch,
    and to ``backproject_chunk_cuda.launches_by_copy[COPY_NAMES[copy]]``."""
    v_lo = int(v_lo)
    _check(volume, projections, sin_phi, cos_phi, grid, v_lo)
    dz, ny, nx = volume.shape
    C, vp, n_row = projections.shape
    rx1, ry1, rz1 = roi_offset
    k = kernel_constants(grid)
    bf16 = projections.dtype == torch.bfloat16
    if plan is None:
        plan = launch_plan(grid, (dz, ny, nx), projections,
                           int(rz1 + z_offset), (int(rx1), int(ry1)))
    lib = _build.load_library("backproject")
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    rc = lib.paris_bp_launch(
        volume.device.index, stream, volume.data_ptr(),
        projections.data_ptr(), int(bf16),
        sin_phi.data_ptr(), cos_phi.data_ptr(),
        C, grid.det.n_col, n_row, vp, v_lo, dz, ny, nx,
        int(rx1), int(ry1), int(rz1 + z_offset),
        k["off_x"], k["off_y"], k["off_z"],
        k["l_vx_x"], k["l_vx_y"], k["l_vx_z"],
        k["d_so"], k["d_sd"], k["safe_min"],
        k["h_min"], k["inv_lpr"], k["inv_lpc"], k["vb"],
        plan.shape, plan.copy, plan.pitch, plan.tile_h, plan.smem)
    if rc != 0:
        raise RuntimeError(
            f"backprojection kernel launch failed: CUDA error {rc} "
            f"({lib.paris_bp_error_string(rc).decode()})")
    backproject_chunk_cuda.launches += 1
    backproject_chunk_cuda.launches_by_copy[COPY_NAMES[plan.copy]] += 1
    return volume


backproject_chunk_cuda.launches = 0
backproject_chunk_cuda.launches_by_copy = dict.fromkeys(COPY_NAMES, 0)


def blocks_per_sm(plan: TilePlan, bf16: bool, device=None) -> int:
    """Resident thread blocks per SM of the kernel that ``plan`` launches
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load_library("backproject")
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n = lib.paris_bp_blocks_per_sm(index, plan.shape, int(bf16), plan.copy,
                                   plan.smem)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n} "
                           f"({lib.paris_bp_error_string(-n).decode()})")
    return n


def compiled_shapes() -> Tuple[Tuple[Tuple[int, int, int], ...], int]:
    """(block shapes, ring depth) as the built library reports them; they
    must equal ``SHAPES`` and ``RING``."""
    lib = _build.load_library("backproject")
    out = (ctypes.c_int * (3 * 8))()
    n = lib.paris_bp_shapes(out, 8)
    return (tuple(tuple(out[3 * i:3 * i + 3]) for i in range(n)),
            lib.paris_bp_ring())


def backproject_chunk(volume, projections, sin_phi, cos_phi, grid,
                      z_offset: int = 0,
                      roi_offset: Tuple[int, int, int] = (0, 0, 0),
                      v_lo: int = 0) -> torch.Tensor:
    """In-place backprojection of one chunk, the "step.k1" span (plan,
    library, launch; timed on the card by its events): the CUDA kernel for
    tensors on the card, the plain PyTorch version for tensors on the
    CPU."""
    if volume.device.type == "cuda":
        with span("step.k1", device=True):
            return backproject_chunk_cuda(volume, projections, sin_phi,
                                          cos_phi, grid, z_offset,
                                          roi_offset, v_lo)
    if volume.device.type == "cpu":
        with span("step.k1"):
            return backproject_chunk_torch(volume, projections, sin_phi,
                                           cos_phi, grid, z_offset,
                                           roi_offset, v_lo)
    raise ValueError(f"no backprojection for device {volume.device}")
