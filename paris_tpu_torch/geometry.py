"""Scan / volume geometry for cone-beam CT (FDK) reconstruction.

The port's own copy of ``paris_tpu/geometry.py`` (the reference geometry
engine: src/geometry.{h,cpp}, src/region_of_interest.h,
src/subvolume_information.h), kept identical so that both packages plan
the same blocks and bands.  All quantities are plain Python floats / ints
computed on the host once per run.

Conventions (match reference src/geometry.h:30-57):
  * detector rows are the HORIZONTAL axis (``n_row`` pixels wide, pixel
    pitch ``l_px_row`` mm) — a projection image is ``n_col`` x ``n_row``
    (height x width).
  * ``delta_s`` / ``delta_t`` are detector offsets measured in PIXELS
    (reference: geometry.cpp:43).
  * ``d_so`` = source->rotation-center distance, ``d_od`` =
    center->detector distance, both mm.  ``d_sd = |d_so| + |d_od|``.
  * volume is cubic-voxel, centered on the rotation axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

__all__ = [
    "DetectorGeometry",
    "VolumeGeometry",
    "RegionOfInterest",
    "SubvolumeInfo",
    "ZBlock",
    "derive_volume_geometry",
    "apply_roi",
    "plan_z_blocks",
    "detector_row_band",
    "weighting_constants",
    "filter_size_for",
]


@dataclasses.dataclass(frozen=True)
class DetectorGeometry:
    """Flat-panel detector + circular trajectory description.

    Field names/meaning mirror the reference geometry file keys
    (reference: src/program_options.cpp:83-91) so existing ``.geo``
    files work unchanged.
    """

    n_row: int          # pixels per detector row (projection width)
    n_col: int          # pixels per detector column (projection height)
    l_px_row: float     # horizontal pixel pitch [mm]
    l_px_col: float     # vertical pixel pitch [mm]
    delta_s: float      # horizontal detector offset [px]
    delta_t: float      # vertical detector offset [px]
    d_so: float         # source -> object distance [mm]
    d_od: float         # object -> detector distance [mm]
    delta_phi: float    # angle increment between projections [deg]

    @property
    def d_sd(self) -> float:
        """Source->detector distance (reference: weighting.cpp:41)."""
        return abs(self.d_so) + abs(self.d_od)


@dataclasses.dataclass(frozen=True)
class VolumeGeometry:
    """Reconstruction volume: dims in voxels, cubic voxel size in mm."""

    dim_x: int
    dim_y: int
    dim_z: int
    l_vx_x: float
    l_vx_y: float
    l_vx_z: float

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        return (self.dim_z, self.dim_y, self.dim_x)

    @property
    def voxels(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z

    @property
    def nbytes_f32(self) -> int:
        return 4 * self.voxels


@dataclasses.dataclass(frozen=True)
class RegionOfInterest:
    """Inclusive voxel-coordinate ROI (reference: region_of_interest.h:30-38)."""

    x1: int = 0
    x2: int = 0
    y1: int = 0
    y2: int = 0
    z1: int = 0
    z2: int = 0


def derive_volume_geometry(det: DetectorGeometry) -> VolumeGeometry:
    """Derive the full reconstructable volume from detector geometry alone.

    Same math as the reference (src/geometry.cpp:36-67): the in-slice
    radius of the reconstructable cylinder is ``r = d_so*sin(alpha)``
    with ``alpha`` the half fan angle including the horizontal offset;
    voxels are cubic with ``l_vx = r / ((n_row*l_px_row/2 + delta_s_mm)
    / l_px_row)``; z extent follows from the cone half-height scaled to
    the rotation center.
    """
    n_row = float(det.n_row)
    n_col = float(det.n_col)
    delta_s_mm = abs(det.delta_s * det.l_px_row)
    delta_t_mm = abs(det.delta_t * det.l_px_col)
    d_so = abs(det.d_so)
    d_sd = abs(det.d_od) + d_so

    half_width = (n_row * det.l_px_row) / 2.0 + delta_s_mm
    alpha = math.atan(half_width / d_sd)
    r = d_so * math.sin(alpha)

    l_vx = r / (half_width / det.l_px_row)
    dim_x = int((2.0 * r) / l_vx)
    dim_z = int(
        ((n_col * det.l_px_col / 2.0) + delta_t_mm) * (d_so / d_sd) * (2.0 / l_vx)
    )
    return VolumeGeometry(
        dim_x=dim_x, dim_y=dim_x, dim_z=dim_z,
        l_vx_x=l_vx, l_vx_y=l_vx, l_vx_z=l_vx,
    )


def apply_roi(vol: VolumeGeometry, roi: RegionOfInterest) -> VolumeGeometry:
    """Crop the volume geometry to an inclusive-coordinate ROI.

    The reference (src/geometry.cpp:86-130) computes ``dim = hi - lo``
    and then adds 1 only when ``lo == 0`` — an asymmetry documented as a
    quirk (SURVEY.md §5 bug 5).  The documented *intent* is inclusive
    coordinates, so we use ``dim = hi - lo + 1`` uniformly.  Invalid or
    oversized ROIs are rejected with ``ValueError`` instead of the
    reference's warn-and-ignore.
    """
    for lo, hi, name in ((roi.x1, roi.x2, "x"), (roi.y1, roi.y2, "y"),
                         (roi.z1, roi.z2, "z")):
        if not lo < hi:
            raise ValueError(f"invalid ROI: {name}1={lo} must be < {name}2={hi}")
    dim_x = roi.x2 - roi.x1 + 1
    dim_y = roi.y2 - roi.y1 + 1
    dim_z = roi.z2 - roi.z1 + 1
    if dim_x > vol.dim_x or dim_y > vol.dim_y or dim_z > vol.dim_z:
        raise ValueError(
            f"ROI {dim_x}x{dim_y}x{dim_z} exceeds volume "
            f"{vol.dim_x}x{vol.dim_y}x{vol.dim_z}"
        )
    return dataclasses.replace(vol, dim_x=dim_x, dim_y=dim_y, dim_z=dim_z)


# ---------------------------------------------------------------------------
# z-block (subvolume) planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZBlock:
    """One z-slab of the output volume: a restartable unit of work."""

    index: int       # block id
    z0: int          # first global z-slice covered by this block
    dim_z: int       # number of VALID slices (may be < padded dim_z)
    dim_z_padded: int  # compute shape (uniform across blocks, XLA-friendly)


@dataclasses.dataclass(frozen=True)
class SubvolumeInfo:
    """Plan for splitting the volume into z-blocks.

    TPU-native replacement for the reference's memory-probing planner
    (src/cuda/subvolume_information.cpp:63-119): instead of halving until
    a trial ``cudaMalloc`` succeeds, we compute the block count
    deterministically from an HBM budget, and pad all blocks to one
    uniform shape so XLA compiles a single program (the reference's
    remainder-block would trigger a recompile).
    """

    blocks: Tuple[ZBlock, ...]
    dim_x: int
    dim_y: int
    dim_z_padded: int

    @property
    def num(self) -> int:
        return len(self.blocks)


def plan_z_blocks(
    vol: VolumeGeometry,
    *,
    hbm_budget_bytes: Optional[int] = None,
    proj_buffer_bytes: int = 0,
    num_shards: int = 1,
    z_align: int = 8,
    max_blocks: int = 4096,
    block_dz: Optional[int] = None,
) -> SubvolumeInfo:
    """Split the volume along z into uniform blocks fitting an HBM budget.

    ``hbm_budget_bytes`` is the per-device budget for the volume block
    (defaults to "whole volume in one block").  ``proj_buffer_bytes``
    accounts for projection-chunk residency (the reference reserves
    10 projection buffers, src/cuda/subvolume_information.cpp:72).
    ``num_shards`` is the size of the device mesh z-axis: each block is
    further divided across shards, so block z-size is aligned to
    ``num_shards * z_align`` slices.  ``block_dz`` forces the block
    extent directly (e.g. to narrow the per-block detector-row band),
    overriding the budget-derived split.
    """
    if vol.dim_z <= 0:
        raise ValueError("volume has no z extent")
    align = max(1, num_shards * z_align)

    if block_dz is not None:
        if block_dz < 1:
            raise ValueError(f"block_dz must be >= 1, got {block_dz}")
        n_blocks = -(-vol.dim_z // (-(-block_dz // align) * align))
        if n_blocks > max_blocks:
            raise ValueError(f"z-split needs {n_blocks} blocks (> {max_blocks})")
    elif hbm_budget_bytes is None:
        n_blocks = 1
    else:
        usable = hbm_budget_bytes - proj_buffer_bytes
        if usable <= 0:
            raise ValueError("HBM budget smaller than projection buffers")
        slice_bytes = 4 * vol.dim_x * vol.dim_y
        max_slices = max(align, (usable // slice_bytes // align) * align)
        n_blocks = max(1, -(-vol.dim_z // max_slices))
        if n_blocks > max_blocks:
            raise ValueError(f"z-split needs {n_blocks} blocks (> {max_blocks})")

    dim_z_padded = -(-vol.dim_z // (n_blocks * align)) * align
    blocks = []
    z0 = 0
    for i in range(n_blocks):
        valid = min(dim_z_padded, vol.dim_z - z0)
        if valid <= 0:
            break
        blocks.append(ZBlock(index=i, z0=z0, dim_z=valid, dim_z_padded=dim_z_padded))
        z0 += valid
    return SubvolumeInfo(
        blocks=tuple(blocks), dim_x=vol.dim_x, dim_y=vol.dim_y,
        dim_z_padded=dim_z_padded,
    )


def detector_row_band(
    det: DetectorGeometry,
    vol: VolumeGeometry,
    z0: int,
    dim_z: int,
    *,
    margin_px: int = 2,
) -> Tuple[int, int]:
    """Detector row range ``[lo, hi)`` that a z-block can ever sample.

    The cone magnification is largest for voxels nearest the source
    (``s = -r``): ``v_max_factor = d_sd / (d_so - r)``.  Only detector
    rows within the magnified z-band of the block are touched, so a
    z-sharded backprojection only needs this band of each projection —
    the banded-broadcast optimization derived (but never implemented) in
    the reference docs (SURVEY.md §5 long-context,
    doc/"Geometrie - Definitionen für Subvolumen.pdf").
    """
    d_so = abs(det.d_so)
    # corner (half-diagonal) radius, not the inscribed FOV radius: the
    # kernels compute every voxel of the square x/y extent (like the
    # reference, cuda/backprojection.cu:96-128), and a corner voxel's
    # magnification exceeds the inscribed bound — its detector row can
    # land on-detector but outside an inscribed-radius band, which would
    # sample garbage.  Must match the kernel's den_floor bound
    # (ops/backprojection_pallas.py).
    r = (vol.dim_x / 2.0) * vol.l_vx_x * math.sqrt(2.0)
    r = min(r, d_so * 0.95)
    denom = max(d_so - r, 1e-6)
    max_factor = det.d_sd / denom

    half_z = vol.dim_z * vol.l_vx_z / 2.0
    z_lo_mm = -half_z + vol.l_vx_z / 2.0 + z0 * vol.l_vx_z
    z_hi_mm = z_lo_mm + (dim_z - 1) * vol.l_vx_z
    # worst-case detector v coordinate over the block (mm -> fractional px)
    t_lo = min(z_lo_mm * max_factor, z_lo_mm * det.d_sd / (d_so + r))
    t_hi = max(z_hi_mm * max_factor, z_hi_mm * det.d_sd / (d_so + r))
    v_min_mm = det.delta_t * det.l_px_col - det.n_col * det.l_px_col / 2.0
    lo = int(math.floor((t_lo - v_min_mm) / det.l_px_col - 0.5)) - margin_px
    hi = int(math.ceil((t_hi - v_min_mm) / det.l_px_col + 0.5)) + 1 + margin_px
    return max(0, lo), min(det.n_col, max(0, hi))


def weighting_constants(det: DetectorGeometry) -> Tuple[float, float, float]:
    """(h_min, v_min, d_sd) for FDK cosine weighting.

    Matches reference src/weighting.cpp:37-42:
      h_min = delta_s*l_px_row - n_row*l_px_row/2   [mm]
      v_min = delta_t*l_px_col - n_col*l_px_col/2   [mm]
    """
    h_min = det.delta_s * det.l_px_row - det.n_row * det.l_px_row / 2.0
    v_min = det.delta_t * det.l_px_col - det.n_col * det.l_px_col / 2.0
    return h_min, v_min, det.d_sd


def filter_size_for(n_row: int) -> int:
    """Ramp-filter FFT length: 2 * next_pow2(n_row) (reference filtering.cpp:37)."""
    return int(2 * 2 ** math.ceil(math.log2(max(2, n_row))))
