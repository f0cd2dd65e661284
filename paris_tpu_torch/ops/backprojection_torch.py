"""Voxel-driven FDK backprojection in plain PyTorch (port of
``paris_tpu/ops/backprojection_xla.py``).

It is the plain version of the CUDA kernel in ``csrc/backproject.cu``:
the CPU path of the pipeline, and the reference the kernel is held
against on the card.  Math (reference src/openmp/backprojection.cpp:96-152):

  centered voxel coords    x_k = -dim*l/2 + l/2 + k*l        (similarly y, z)
  rotate by angle phi      s =  x*cos + y*sin
                           t = -x*sin + y*cos
  perspective              f = d_sd / (s + d_so)
  detector coords [px]     h = (t*f - h_min)/l_px_row - 1/2
                           v = (z*f - v_min)/l_px_col - 1/2
  sample                   bilinear(P, v, h), zero if any corner is off the detector
  accumulate               vol += 1/2 * (d_so/(s + d_so))^2 * sample

plus the Pallas kernel's clamp (backprojection_pallas.py:397-401): a
voxel with s + d_so <= 1e-3*|d_so| adds 0.

Detector-row band: the projections may hold only rows [v_lo, v_lo + vp)
of the detector (``geometry.detector_row_band`` gives the rows a z-block
can sample).  Validity is still decided on the whole detector (0 <=
floor(v) <= n_col - 2, n_col from the grid); the tap row is floor(v) -
v_lo, clamped into the band, so a band that does not cover a block reads
wrong rows but never outside the buffer.  With v_lo = 0 and vp = n_col
the band is the whole detector.

The coordinates that decide a floor or the detector-border test are
computed with the same float32 operations, in the same order and from
the same float32 constants (``kernel_constants``) as the kernel, so the
two pick the same taps on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..geometry import DetectorGeometry, VolumeGeometry

__all__ = ["BpGrid", "make_bp_grid", "kernel_constants",
           "backproject_chunk_torch"]


class BpGrid:
    """Static per-run constants for backprojection, all Python floats.

    Copied from ``paris_tpu/ops/backprojection_xla.py:BpGrid``, whose
    module imports JAX.  Note the sign: h_min carries ``-delta_s``
    (the reference's proj_real_coordinate), while the cosine weighting
    uses ``+delta_s`` (``geometry.weighting_constants``).  Both are the
    reference's conventions and are kept as they are.
    """

    def __init__(self, det: DetectorGeometry, vol: VolumeGeometry):
        self.det = det
        self.vol = vol
        self.d_so = float(det.d_so)
        self.d_sd = float(det.d_sd)
        # proj_real_coordinate offsets (reference backprojection.cpp:49-50:
        # delta_s converted px -> mm before entering the kernel)
        self.delta_s_mm = float(det.delta_s * det.l_px_row)
        self.delta_t_mm = float(det.delta_t * det.l_px_col)
        self.h_min = -(det.n_row * det.l_px_row) / 2.0 - self.delta_s_mm
        self.v_min = -(det.n_col * det.l_px_col) / 2.0 - self.delta_t_mm


def make_bp_grid(det: DetectorGeometry, vol: VolumeGeometry) -> BpGrid:
    return BpGrid(det, vol)


def _f32(x: float) -> float:
    return float(np.float32(x))


def kernel_constants(grid: BpGrid) -> dict:
    """The float32 scalars both backprojection versions compute with."""
    det, vol = grid.det, grid.vol
    return dict(
        off_x=_f32(-(vol.dim_x * vol.l_vx_x) / 2.0 + vol.l_vx_x / 2.0),
        off_y=_f32(-(vol.dim_y * vol.l_vx_y) / 2.0 + vol.l_vx_y / 2.0),
        off_z=_f32(-(vol.dim_z * vol.l_vx_z) / 2.0 + vol.l_vx_z / 2.0),
        l_vx_x=_f32(vol.l_vx_x),
        l_vx_y=_f32(vol.l_vx_y),
        l_vx_z=_f32(vol.l_vx_z),
        d_so=_f32(grid.d_so),
        d_sd=_f32(grid.d_sd),
        safe_min=_f32(1e-3 * abs(grid.d_so)),
        h_min=_f32(grid.h_min),
        inv_lpr=_f32(1.0 / det.l_px_row),
        inv_lpc=_f32(1.0 / det.l_px_col),
        # v = z*f/l_px_col + vb, the v affine chain folded as in the
        # Pallas kernel (backprojection_pallas.py:546-553)
        vb=_f32(-grid.v_min / det.l_px_col - 0.5),
    )


def _coords(n: int, first: int, step: float, off: float, device):
    """float32 voxel-centre coordinates (first + k)*step + off."""
    idx = torch.arange(first, first + n, dtype=torch.float32, device=device)
    return idx * step + off


def backproject_chunk_torch(
    volume: torch.Tensor,          # (dz, ny, nx) f32 z-block accumulator
    projections: torch.Tensor,     # (C, vp, n_row) f32 or bf16, filtered
    sin_phi: torch.Tensor,         # (C,) f32
    cos_phi: torch.Tensor,         # (C,) f32
    grid: BpGrid,
    z_offset: int = 0,             # global z of this block's first slice
    roi_offset: Tuple[int, int, int] = (0, 0, 0),  # (x1, y1, z1) ROI origin
    v_lo: int = 0,                 # detector row of the band's first row
    max_temp_bytes: int = 256 << 20,
) -> torch.Tensor:
    """Accumulate a chunk of projections into ``volume`` IN PLACE and
    return it.

    bf16 projections are widened to float32 before sampling, as the
    kernel widens each tap.  The per-angle temporaries are (slab, ny, nx);
    ``max_temp_bytes`` bounds one of them by walking the block in z-slabs.
    """
    k = kernel_constants(grid)
    dz, ny, nx = volume.shape
    C, vp, n_row = projections.shape
    n_col = grid.det.n_col
    dev = volume.device
    rx1, ry1, rz1 = roi_offset
    flat = projections.to(torch.float32).reshape(C, vp * n_row)

    xs = _coords(nx, rx1, k["l_vx_x"], k["off_x"], dev)[None, :]
    ys = _coords(ny, ry1, k["l_vx_y"], k["off_y"], dev)[:, None]
    zs = _coords(dz, rz1 + z_offset, k["l_vx_z"], k["off_z"], dev)
    neg_xs = -xs
    zc = max(1, int(max_temp_bytes) // (4 * ny * nx))

    for c in range(C):
        sin_c, cos_c = sin_phi[c], cos_phi[c]
        s = xs * cos_c + ys * sin_c                          # (ny, nx)
        t = neg_xs * sin_c + ys * cos_c
        denom = s + k["d_so"]
        safe = denom > k["safe_min"]
        inv = torch.where(safe, torch.reciprocal(denom), 0.0)
        factor = inv * k["d_sd"]
        u = inv * k["d_so"]
        weight = 0.5 * (u * u)
        h = (t * factor - k["h_min"]) * k["inv_lpr"] - 0.5
        h0f = torch.floor(h)
        fh = h - h0f
        valid_h = safe & (h0f >= 0.0) & (h0f <= n_row - 2)
        h0 = h0f.clamp(0, n_row - 2).to(torch.int64)
        fscale = factor * k["inv_lpc"]
        p = flat[c]
        for z0 in range(0, dz, zc):
            v = zs[z0:z0 + zc, None, None] * fscale + k["vb"]  # (slab, ny, nx)
            v0f = torch.floor(v)
            fv = v - v0f
            valid = valid_h & (v0f >= 0.0) & (v0f <= n_col - 2)
            row = (v0f - v_lo).clamp(0, vp - 2)
            base = row.to(torch.int64) * n_row + h0
            q11 = p[base]
            q21 = p[base + 1]
            q12 = p[base + n_row]
            q22 = p[base + (n_row + 1)]
            top = q11 * (1.0 - fh) + q21 * fh
            bot = q12 * (1.0 - fh) + q22 * fh
            val = weight * (top * (1.0 - fv) + bot * fv)
            # in place: the JAX package donated this buffer instead
            volume[z0:z0 + zc] += torch.where(valid, val, 0.0)
    return volume
