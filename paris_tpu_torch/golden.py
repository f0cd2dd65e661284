"""Golden NumPy FDK oracle — the role the reference's OpenMP backend plays.

The port's own copy of ``paris_tpu/golden.py``.  Deliberately written
against the doc/ formulas with plain NumPy (no JAX, no torch) so it is an
INDEPENDENT implementation to test the device path against
(SURVEY.md §4: the reference ships no tests; its OpenMP backend is the
de-facto oracle — this module is our equivalent).

Implements the same three stages as the device path:
  cosine weighting (src/cuda/weighting.cu:49-56),
  ramp filtering   (src/cuda/filtering.cu:45-121),
  voxel-driven backprojection with border-zero bilinear interpolation
                   (src/openmp/backprojection.cpp:52-152).
"""

from __future__ import annotations

import numpy as np

from .geometry import DetectorGeometry, VolumeGeometry, filter_size_for

__all__ = ["golden_weight", "golden_filter", "golden_backproject",
           "golden_fdk", "golden_fdk_stream"]


def golden_weight(proj: np.ndarray, det: DetectorGeometry) -> np.ndarray:
    """proj: (n_col, n_row) -> weighted copy."""
    n_col, n_row = proj.shape
    h_min = det.delta_s * det.l_px_row - n_row * det.l_px_row / 2.0
    v_min = det.delta_t * det.l_px_col - n_col * det.l_px_col / 2.0
    d_sd = det.d_sd
    s = np.arange(n_row, dtype=np.float64)
    t = np.arange(n_col, dtype=np.float64)
    h_s = det.l_px_row / 2.0 + s * det.l_px_row + h_min
    v_t = det.l_px_col / 2.0 + t * det.l_px_col + v_min
    w = d_sd / np.sqrt(d_sd**2 + h_s[None, :] ** 2 + v_t[:, None] ** 2)
    return (proj.astype(np.float64) * w).astype(np.float32)


def golden_filter(proj: np.ndarray, det: DetectorGeometry) -> np.ndarray:
    """Ramp-filter each detector row of (n_col, n_row)."""
    n_col, n_row = proj.shape
    tau = det.l_px_row
    size = filter_size_for(n_row)
    j = np.arange(size, dtype=np.int64) - (size - 2) // 2
    r = np.zeros(size, dtype=np.float64)
    r[j == 0] = 1.0 / (8.0 * tau * tau)
    odd = (j % 2) != 0
    r[odd] = -1.0 / (2.0 * j[odd].astype(np.float64) ** 2 * np.pi**2 * tau**2)
    k = np.abs(np.fft.rfft(r)) * tau

    padded = np.zeros((n_col, size), dtype=np.float64)
    padded[:, :n_row] = proj
    filtered = np.fft.irfft(np.fft.rfft(padded, axis=1) * k[None, :], n=size, axis=1)
    return filtered[:, :n_row].astype(np.float32)


def golden_backproject(
    volume: np.ndarray,            # (dz, ny, nx) accumulator, modified copy returned
    proj: np.ndarray,              # (n_col, n_row) weighted+filtered
    phi_deg: float,
    det: DetectorGeometry,
    vol: VolumeGeometry,
    z_offset: int = 0,
    roi_offset=(0, 0, 0),
) -> np.ndarray:
    dz, ny, nx = volume.shape
    n_col, n_row = proj.shape
    rx1, ry1, rz1 = roi_offset

    phi = np.deg2rad(phi_deg)
    sin, cos = np.sin(phi), np.cos(phi)
    d_so = det.d_so
    d_sd = det.d_sd
    delta_s_mm = det.delta_s * det.l_px_row
    delta_t_mm = det.delta_t * det.l_px_col

    def centered(idx, dim, size):
        return -(dim * size) / 2.0 + size / 2.0 + idx * size

    xs = centered(np.arange(nx, dtype=np.float64) + rx1, vol.dim_x, vol.l_vx_x)
    ys = centered(np.arange(ny, dtype=np.float64) + ry1, vol.dim_y, vol.l_vx_y)
    zs = centered(
        np.arange(dz, dtype=np.float64) + rz1 + z_offset, vol.dim_z, vol.l_vx_z
    )

    s = xs[None, :] * cos + ys[:, None] * sin            # (ny, nx)
    t = -xs[None, :] * sin + ys[:, None] * cos
    factor = d_sd / (s + d_so)
    u2 = (d_so / (s + d_so)) ** 2

    # proj_real_coordinate (openmp/backprojection.cpp:45-50)
    h_min = -(n_row * det.l_px_row) / 2.0 - delta_s_mm
    v_min = -(n_col * det.l_px_col) / 2.0 - delta_t_mm
    h = (t * factor - h_min) / det.l_px_row - 0.5        # (ny, nx)

    out = volume.astype(np.float64).copy()
    h1 = np.floor(h)
    fh = h - h1
    h_ok = (h1 >= 0) & (h1 + 1 < n_row)
    h1i = np.clip(h1.astype(np.int64), 0, n_row - 2)

    for m in range(dz):
        v = (zs[m] * factor - v_min) / det.l_px_col - 0.5    # (ny, nx)
        v1 = np.floor(v)
        fv = v - v1
        ok = h_ok & (v1 >= 0) & (v1 + 1 < n_col)
        v1i = np.clip(v1.astype(np.int64), 0, n_col - 2)
        q11 = proj[v1i, h1i]
        q21 = proj[v1i, h1i + 1]
        q12 = proj[v1i + 1, h1i]
        q22 = proj[v1i + 1, h1i + 1]
        top = q11 * (1 - fh) + q21 * fh
        bot = q12 * (1 - fh) + q22 * fh
        val = np.where(ok, top * (1 - fv) + bot * fv, 0.0)
        out[m] += 0.5 * u2 * val
    return out.astype(np.float32)


def golden_fdk(
    projections: np.ndarray,       # (n_proj, n_col, n_row) raw
    angles_deg: np.ndarray,        # (n_proj,)
    det: DetectorGeometry,
    vol: VolumeGeometry,
    dz: int | None = None,
    z_offset: int = 0,
    roi_offset=(0, 0, 0),
    dy: int | None = None,
    dx: int | None = None,
) -> np.ndarray:
    """Full weight->filter->backproject chain; returns (dz, dy, dx)."""
    dz = vol.dim_z if dz is None else dz
    ny = vol.dim_y if dy is None else dy
    nx = vol.dim_x if dx is None else dx
    out = np.zeros((dz, ny, nx), dtype=np.float32)
    for p, phi in zip(projections, angles_deg):
        wf = golden_filter(golden_weight(p, det), det)
        out = golden_backproject(out, wf, phi, det, vol, z_offset, roi_offset)
    return out


def golden_fdk_stream(
    pairs,                          # iterable of (proj (n_col,n_row), phi_deg)
    det: DetectorGeometry,
    vol: VolumeGeometry,
    slabs,                          # [(z_offset, dz), ...] — slabs to build
    roi_offset=(0, 0, 0),
    dtype=np.float64,
) -> list:
    """Streaming multi-slab golden FDK: ONE pass over the projections,
    the weight+filter computed once per projection, every requested
    z-slab accumulated together.  Returns ``[ (dz, ny, nx) f32, ...]``.

    Built for full-scale gating (BASELINE config 5: 2048-class, 3600
    projections) where ``golden_fdk`` per slab is prohibitive: the
    per-projection maps (s, t, factor, u2, h and the h-interpolation
    indices) are z-independent, so they are computed once per
    projection instead of once per (slab, projection); gathers use
    flat indexing into the projection; and ``dtype=np.float32`` runs
    the hot path in f32 (validated against the f64 oracle to <1e-5
    relative in tests/test_golden_fdk_e2e.py — far under the 1e-3
    reconstruction gates).  Results match ``golden_fdk`` (same math,
    same border-zero bilinear; reference src/openmp/backprojection.cpp:
    52-152) to accumulation-order rounding.
    """
    dtype = np.dtype(dtype)
    ny, nx = vol.dim_y, vol.dim_x
    n_col, n_row = det.n_col, det.n_row
    rx1, ry1, rz1 = roi_offset

    d_so, d_sd = det.d_so, det.d_sd
    delta_s_mm = det.delta_s * det.l_px_row
    delta_t_mm = det.delta_t * det.l_px_col
    h_min = -(n_row * det.l_px_row) / 2.0 - delta_s_mm
    v_min = -(n_col * det.l_px_col) / 2.0 - delta_t_mm

    def centered(idx, dim, size):
        return -(dim * size) / 2.0 + size / 2.0 + idx * size

    xs = centered(np.arange(nx, dtype=np.float64) + rx1, vol.dim_x,
                  vol.l_vx_x).astype(dtype)
    ys = centered(np.arange(ny, dtype=np.float64) + ry1, vol.dim_y,
                  vol.l_vx_y).astype(dtype)
    slab_zs = [
        centered(np.arange(dz, dtype=np.float64) + rz1 + z0, vol.dim_z,
                 vol.l_vx_z).astype(dtype)
        for z0, dz in slabs
    ]
    outs = [np.zeros((len(zs), ny, nx), np.float64) for zs in slab_zs]

    inv_lr = dtype.type(1.0 / det.l_px_row)
    inv_lc = dtype.type(1.0 / det.l_px_col)
    for p, phi_deg in pairs:
        phi = np.deg2rad(float(phi_deg))
        sin, cos = dtype.type(np.sin(phi)), dtype.type(np.cos(phi))
        wf = golden_filter(golden_weight(p, det), det).astype(dtype)
        pf = np.ascontiguousarray(wf).ravel()

        s = xs[None, :] * cos + ys[:, None] * sin            # (ny, nx)
        t = -xs[None, :] * sin + ys[:, None] * cos
        factor = dtype.type(d_sd) / (s + dtype.type(d_so))
        u2 = dtype.type(0.5) * (dtype.type(d_so) / (s + dtype.type(d_so))) ** 2
        h = (t * factor - dtype.type(h_min)) * inv_lr - dtype.type(0.5)
        h1 = np.floor(h)
        fh = h - h1
        h_ok = (h1 >= 0) & (h1 + 1 < n_row)
        h1i = np.clip(h1.astype(np.int64), 0, n_row - 2)

        for zs, out in zip(slab_zs, outs):
            for m in range(len(zs)):
                v = (zs[m] * factor - dtype.type(v_min)) * inv_lc \
                    - dtype.type(0.5)
                v1 = np.floor(v)
                fv = v - v1
                ok = h_ok & (v1 >= 0) & (v1 + 1 < n_col)
                base = np.clip(v1.astype(np.int64), 0, n_col - 2) * n_row \
                    + h1i
                q11 = pf[base]
                q21 = pf[base + 1]
                q12 = pf[base + n_row]
                q22 = pf[base + n_row + 1]
                top = q11 + (q21 - q11) * fh
                bot = q12 + (q22 - q12) * fh
                val = top + (bot - top) * fv
                val *= u2
                out[m] += np.where(ok, val, dtype.type(0.0))
    return [o.astype(np.float32) for o in outs]
