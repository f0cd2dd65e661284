"""The plain FDK the benchmark holds the program to, at chosen voxels.

Written from the reference's formulas (cosine weighting,
src/cuda/weighting.cu:49-56; the Ram-Lak ramp filter,
src/cuda/filtering.cu:45-121; voxel-driven backprojection with
border-zero bilinear interpolation, src/openmp/backprojection.cpp:52-152)
in plain PyTorch, float64 throughout, with no kernel, band, cache or
quantization.  It imports nothing of the program: it gets the raw counts
from the benchmark's generator and derives everything else itself.

``lowp`` rounds the filtered projections to a lower precision before the
backprojection, the control of ``correct``: ``"bfloat16"``, or
``"float8_e4m3fn"`` under one scale per frame (its largest magnitude at
448, the format's largest finite value).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..lib.geometry import Scan, Volume, filter_size

LOWP = ("bfloat16", "float8_e4m3fn")


def weight_map(det: Scan, device) -> torch.Tensor:
    """(n_col, n_row) cosine weights d_sd / sqrt(d_sd^2 + h^2 + v^2) at
    the pixel centres, the detector at +delta_s, +delta_t."""
    h_min = det.delta_s * det.l_px_row - det.n_row * det.l_px_row / 2.0
    v_min = det.delta_t * det.l_px_col - det.n_col * det.l_px_col / 2.0
    h = h_min + (torch.arange(det.n_row, dtype=torch.float64, device=device)
                 + 0.5) * det.l_px_row
    v = v_min + (torch.arange(det.n_col, dtype=torch.float64, device=device)
                 + 0.5) * det.l_px_col
    d = det.d_sd
    return d / torch.sqrt(d * d + h[None, :] ** 2 + v[:, None] ** 2)


def ramp_spectrum(n_row: int, tau: float, device) -> torch.Tensor:
    """tau * |rfft(r)| of the discrete Ram-Lak kernel r(j): 1/(8 tau^2) at
    0, -1/(2 j^2 pi^2 tau^2) at odd j, 0 at even j, over the filter
    length centred at (size - 2) / 2."""
    size = filter_size(n_row)
    j = np.arange(size, dtype=np.int64) - (size - 2) // 2
    r = np.zeros(size, np.float64)
    r[j == 0] = 1.0 / (8.0 * tau * tau)
    odd = (j % 2) != 0
    r[odd] = -1.0 / (2.0 * j[odd].astype(np.float64) ** 2 * math.pi ** 2
                     * tau * tau)
    return torch.from_numpy(np.abs(np.fft.rfft(r)) * tau).to(device)


def filtered(frames: torch.Tensor, det: Scan, weights: torch.Tensor,
             spectrum: torch.Tensor, lowp: Optional[str] = None
             ) -> torch.Tensor:
    """Weighted and ramp-filtered (C, n_col, n_row) float64 frames, each
    row zero-padded to the filter length; rounded to ``lowp`` if given."""
    size = filter_size(det.n_row)
    out = torch.fft.irfft(torch.fft.rfft(frames * weights, n=size, dim=-1)
                          * spectrum, n=size, dim=-1)[..., :det.n_row]
    if lowp is None:
        return out
    if lowp == "bfloat16":
        return out.to(torch.bfloat16).to(torch.float64)
    if lowp == "float8_e4m3fn":
        amax = out.abs().amax(dim=(1, 2), keepdim=True)
        scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        return (out / scale).to(torch.float8_e4m3fn).to(
            torch.float64) * scale
    raise ValueError(f"lowp must be one of {LOWP}, not {lowp!r}")


def fdk_at_voxels(frames: Callable[[np.ndarray], torch.Tensor],
                  idx: Sequence[int], det: Scan, vol: Volume,
                  voxels: torch.Tensor, *, device, chunk: int = 16,
                  lowp: Optional[str] = None) -> torch.Tensor:
    """FDK values (float64, N) at ``voxels`` (N, 3) global (z, y, x)
    indices of ``vol``, from the projections ``idx`` at angles
    ``idx * det.delta_phi``; ``frames(idx)`` returns them as float64
    (n, n_col, n_row) on ``device``."""
    device = torch.device(device)
    voxels = voxels.to(device)
    l = vol.l_vx

    def centre(i, dim):
        return -(dim * l) / 2.0 + l / 2.0 + i.to(torch.float64) * l

    z = centre(voxels[:, 0], vol.dim_z)[None]
    y = centre(voxels[:, 1], vol.dim_y)[None]
    x = centre(voxels[:, 2], vol.dim_x)[None]
    # the backprojection's detector origin: -delta_s, -delta_t
    h_min = -(det.n_row * det.l_px_row) / 2.0 - det.delta_s * det.l_px_row
    v_min = -(det.n_col * det.l_px_col) / 2.0 - det.delta_t * det.l_px_col
    weights = weight_map(det, device)
    spectrum = ramp_spectrum(det.n_row, det.l_px_row, device)
    acc = torch.zeros(voxels.shape[0], dtype=torch.float64, device=device)
    idx = np.asarray(idx, np.int64)
    n_row, n_col = det.n_row, det.n_col
    for i0 in range(0, len(idx), chunk):
        part = idx[i0:i0 + chunk]
        p = filtered(frames(part), det, weights, spectrum, lowp)
        flat = p.reshape(len(part), -1)
        phi = torch.from_numpy(np.deg2rad(part * det.delta_phi)).to(
            device)[:, None]
        sin, cos = torch.sin(phi), torch.cos(phi)
        s = x * cos + y * sin
        t = -x * sin + y * cos
        factor = det.d_sd / (s + det.d_so)
        u2 = 0.5 * (det.d_so / (s + det.d_so)) ** 2
        h = (t * factor - h_min) / det.l_px_row - 0.5
        v = (z * factor - v_min) / det.l_px_col - 0.5
        h1, v1 = torch.floor(h), torch.floor(v)
        fh, fv = h - h1, v - v1
        ok = (h1 >= 0) & (h1 + 1 < n_row) & (v1 >= 0) & (v1 + 1 < n_col)
        base = (v1.clamp(0, n_col - 2).to(torch.int64) * n_row
                + h1.clamp(0, n_row - 2).to(torch.int64))
        q11 = torch.gather(flat, 1, base)
        q21 = torch.gather(flat, 1, base + 1)
        q12 = torch.gather(flat, 1, base + n_row)
        q22 = torch.gather(flat, 1, base + n_row + 1)
        top = q11 * (1 - fh) + q21 * fh
        bot = q12 * (1 - fh) + q22 * fh
        val = top * (1 - fv) + bot * fv
        acc += torch.where(ok, u2 * val, 0.0).sum(dim=0)
    return acc
