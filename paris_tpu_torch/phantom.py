"""3D Shepp-Logan phantom + analytic cone-beam forward projector.

The port's own copy of the NumPy half of ``paris_tpu/phantom.py``: the
test-data generator for the reconstruction pipeline (BASELINE.md config 1
calls for a synthetic Shepp-Logan cone-beam scan as the correctness
gate).  ``cone_beam_project_torch`` is the counterpart of the JAX
package's accelerator-batched projector (``cone_beam_project_jax``): the
same float32 formula as plain torch ops on the card, for scans at full
size.

The forward projector computes line integrals through the ellipsoid
phantom ANALYTICALLY (ray/ellipsoid intersection chord lengths), so the
projections are exact and independent of any voxelization or of the
backprojection code under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .geometry import DetectorGeometry, VolumeGeometry

__all__ = ["SHEPP_LOGAN_ELLIPSOIDS", "shepp_logan_volume", "cone_beam_project",
           "cone_beam_project_torch", "projector_device"]

# (value, x0, y0, z0, a, b, c, rot_deg) — canonical Kak-Slaney 3D variant,
# coordinates in units of the phantom half-extent (= 1.0).
SHEPP_LOGAN_ELLIPSOIDS = np.array([
    #  A      x0     y0     z0     a      b      c     phi
    [ 1.00,  0.00,  0.00,  0.00, 0.690, 0.920, 0.810,  0.0],
    [-0.80,  0.00, -0.0184, 0.00, 0.6624, 0.874, 0.780, 0.0],
    [-0.20,  0.22,  0.00,  0.00, 0.110, 0.310, 0.220, -18.0],
    [-0.20, -0.22,  0.00,  0.00, 0.160, 0.410, 0.280,  18.0],
    [ 0.10,  0.00,  0.35, -0.15, 0.210, 0.250, 0.410,  0.0],
    [ 0.10,  0.00,  0.10,  0.25, 0.046, 0.046, 0.050,  0.0],
    [ 0.10,  0.00, -0.10,  0.25, 0.046, 0.046, 0.050,  0.0],
    [ 0.10, -0.08, -0.605, 0.00, 0.046, 0.023, 0.050,  0.0],
    [ 0.10,  0.00, -0.605, 0.00, 0.023, 0.023, 0.020,  0.0],
    [ 0.10,  0.06, -0.605, 0.00, 0.023, 0.046, 0.020,  0.0],
], dtype=np.float64)


def shepp_logan_volume(vol: VolumeGeometry, scale_mm: float) -> np.ndarray:
    """Voxelized phantom (dz, ny, nx); ``scale_mm`` maps unit coords to mm."""
    def centered(n, l):
        return (np.arange(n) - n / 2.0 + 0.5) * l

    xs = centered(vol.dim_x, vol.l_vx_x) / scale_mm
    ys = centered(vol.dim_y, vol.l_vx_y) / scale_mm
    zs = centered(vol.dim_z, vol.l_vx_z) / scale_mm
    X = xs[None, None, :]
    Y = ys[None, :, None]
    Z = zs[:, None, None]
    out = np.zeros((vol.dim_z, vol.dim_y, vol.dim_x), dtype=np.float32)
    for A, x0, y0, z0, a, b, c, rot in SHEPP_LOGAN_ELLIPSOIDS:
        th = np.deg2rad(rot)
        ct, st = np.cos(th), np.sin(th)
        xr = (X - x0) * ct + (Y - y0) * st
        yr = -(X - x0) * st + (Y - y0) * ct
        zr = Z - z0
        inside = (xr / a) ** 2 + (yr / b) ** 2 + (zr / c) ** 2 <= 1.0
        out += np.where(inside, np.float32(A), np.float32(0.0))
    return out


def cone_beam_project(
    det: DetectorGeometry,
    angles_deg: np.ndarray,
    scale_mm: float,
    dtype=np.float32,
) -> np.ndarray:
    """Analytic cone-beam projections of the phantom, (n_proj, n_col, n_row).

    Geometry matches the backprojector's conventions exactly: for
    rotation angle phi, the source sits at distance d_so along the
    rotated -s axis, the detector plane at +d_od; detector pixel (t_idx
    s_idx) center has in-plane coordinate h = h_min + (s_idx+0.5)*l_px_row
    (h_min from weighting_constants) and axial coordinate v likewise.
    """
    n_row, n_col = det.n_row, det.n_col
    d_so, d_sd = abs(det.d_so), det.d_sd
    h_min = det.delta_s * det.l_px_row - n_row * det.l_px_row / 2.0
    v_min = det.delta_t * det.l_px_col - n_col * det.l_px_col / 2.0

    h = h_min + (np.arange(n_row) + 0.5) * det.l_px_row    # (n_row,)
    v = v_min + (np.arange(n_col) + 0.5) * det.l_px_col    # (n_col,)
    H = h[None, :]                                         # broadcast over n_col
    V = v[:, None]

    out = np.zeros((len(angles_deg), n_col, n_row), dtype=dtype)
    for i, ang in enumerate(np.asarray(angles_deg, dtype=np.float64)):
        phi = np.deg2rad(ang)
        sin, cos = np.sin(phi), np.cos(phi)
        # Source and detector-pixel positions in WORLD coordinates.
        # In the rotated frame: source at (s,t,z) = (-d_so, 0, 0); pixel at
        # (d_sd - d_so, h, v).  Rotate frame->world by +phi:
        #   world_x = s*cos - t*sin ; world_y = s*sin + t*cos
        # (inverse of s = x*cos + y*sin, t = -x*sin + y*cos)
        src = np.array([-d_so * cos, -d_so * sin, 0.0])
        px = (d_sd - d_so) * cos - H * sin
        py = (d_sd - d_so) * sin + H * cos
        pz = np.broadcast_to(V, (n_col, n_row))
        # ray directions (not normalized; chord length scales with |d|)
        dx = px - src[0]
        dy = py - src[1]
        dz = pz - src[2]
        norm = np.sqrt(dx * dx + dy * dy + dz * dz)
        acc = np.zeros((n_col, n_row), dtype=np.float64)
        for A, x0, y0, z0, a, b, c, rot in SHEPP_LOGAN_ELLIPSOIDS:
            th = np.deg2rad(rot)
            ct, st = np.cos(th), np.sin(th)
            # transform ray into the ellipsoid's unit-sphere frame
            ox, oy, oz = src[0] - x0 * scale_mm, src[1] - y0 * scale_mm, -z0 * scale_mm
            oxr = (ox * ct + oy * st) / (a * scale_mm)
            oyr = (-ox * st + oy * ct) / (b * scale_mm)
            ozr = oz / (c * scale_mm)
            dxr = (dx * ct + dy * st) / (a * scale_mm)
            dyr = (-dx * st + dy * ct) / (b * scale_mm)
            dzr = dz / (c * scale_mm)
            # |o + u d|^2 = 1
            qa = dxr * dxr + dyr * dyr + dzr * dzr
            qb = 2.0 * (oxr * dxr + oyr * dyr + ozr * dzr)
            qc = oxr * oxr + oyr * oyr + ozr * ozr - 1.0
            disc = qb * qb - 4.0 * qa * qc
            hit = disc > 0.0
            sq = np.sqrt(np.where(hit, disc, 0.0))
            # chord length in world mm = |u2-u1| * |d|
            chord = np.where(hit, sq / qa, 0.0) * norm
            acc += A * chord
        out[i] = acc.astype(dtype)
    return out


@functools.lru_cache(maxsize=8)
def _projector_constants(det: DetectorGeometry, scale_mm: float,
                         device: torch.device):
    """Per-geometry constants of ``cone_beam_project_torch``, built once:
    the pixel centres h (1, 1, n_row) and v (1, n_col, 1) as float32
    tensors on ``device``, and per ellipsoid its float32 scalars, cast
    where ``paris_tpu/phantom.py:_jax_projector`` casts them."""
    n_row, n_col = det.n_row, det.n_col
    # +delta_s, as the JAX projector and the cosine weighting have it
    h_min = det.delta_s * det.l_px_row - n_row * det.l_px_row / 2.0
    v_min = det.delta_t * det.l_px_col - n_col * det.l_px_col / 2.0
    h = (h_min + (np.arange(n_row) + 0.5) * det.l_px_row).astype(np.float32)
    v = (v_min + (np.arange(n_col) + 0.5) * det.l_px_col).astype(np.float32)
    table = []
    for A, x0, y0, z0, a, b, c, rot in SHEPP_LOGAN_ELLIPSOIDS:
        th = np.deg2rad(rot)
        table.append(tuple(np.float32(x) for x in (
            A, np.cos(th), np.sin(th), x0 * scale_mm, y0 * scale_mm,
            -z0 * scale_mm, 1.0 / (a * scale_mm), 1.0 / (b * scale_mm),
            1.0 / (c * scale_mm))))
    return (torch.from_numpy(h).to(device).view(1, 1, n_row),
            torch.from_numpy(v).to(device).view(1, n_col, 1), tuple(table))


def projector_device(device=None) -> torch.device:
    """``device`` as a torch.device; None is the current card, and raises
    when there is none (the CPU is asked for with ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the torch projector runs on the card by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "project on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def cone_beam_project_torch(det: DetectorGeometry, angles_deg, scale_mm: float,
                            *, device=None) -> torch.Tensor:
    """Analytic cone-beam projections of the phantom as a (B, n_col, n_row)
    float32 tensor on ``device`` (default: the card; with no card it
    raises, and ``device="cpu"`` asks for the CPU).

    The counterpart of ``paris_tpu/phantom.py:cone_beam_project_jax``: the
    same float32 arithmetic as its jitted batch function, in its order,
    with the cancellation-stable ``(qb/2)^2 - qa*qc`` discriminant, as
    plain torch ops (no kernel: the JAX package's is an XLA function, not
    a Pallas kernel).  Terms that depend on the detector row only, or on
    the column only, stay broadcast instead of materialised; the values
    are the same.  Float32 rounding differs from the float64 NumPy
    ``cone_beam_project`` on the one-pixel rims of tangent rays; a golden
    oracle that reads the same stored frames is not affected.
    """
    device = projector_device(device)
    h, v, table = _projector_constants(det, float(scale_mm), device)
    d_so, d_sd = abs(det.d_so), det.d_sd
    phis = np.deg2rad(np.asarray(angles_deg, np.float64)).astype(np.float32)
    phis = torch.from_numpy(phis).to(device)
    sin = torch.sin(phis)[:, None, None]
    cos = torch.cos(phis)[:, None, None]
    sx = -d_so * cos                                   # (B, 1, 1)
    sy = -d_so * sin
    dx = (d_sd - d_so) * cos - h * sin - sx            # (B, 1, n_row)
    dy = (d_sd - d_so) * sin + h * cos - sy
    dz = v                                             # (1, n_col, 1)
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)     # (B, n_col, n_row)
    acc = torch.zeros_like(norm)
    for A, ct, st, x0s, y0s, oz, ia, ib, ic in table:
        ox = sx - x0s
        oy = sy - y0s
        oxr = (ox * ct + oy * st) * ia
        oyr = (-ox * st + oy * ct) * ib
        ozr = oz * ic
        dxr = (dx * ct + dy * st) * ia
        dyr = (-dx * st + dy * ct) * ib
        dzr = dz * ic
        qa = dxr * dxr + dyr * dyr + dzr * dzr
        hb = oxr * dxr + oyr * dyr + ozr * dzr           # qb / 2
        qc = oxr * oxr + oyr * oyr + ozr * ozr - 1.0
        disc4 = hb * hb - qa * qc                        # disc / 4
        hit = disc4 > 0.0
        chord = torch.where(hit, 2.0 * torch.sqrt(
            torch.where(hit, disc4, 0.0)) / qa, 0.0) * norm
        acc += A * chord
    return acc
