"""The benchmark's scan generator: a seeded Shepp-Logan phantom, its
analytic cone-beam projections on the card, and the uint16 count rule.

A frozen copy of the repository's float32 torch projector
(``cone_beam_project_torch``: ray/ellipsoid chords, the
cancellation-stable ``(qb/2)^2 - qa*qc`` discriminant) and of its count
rule (``synth_c5_3600.count_scale``: one scale per scan, from a bound on
every line integral, so no count clips).  The seed moves the small
features by up to 0.02 of the half extent and scales the positive small
densities by 0.8-1.2; the outer shells and every size stay as published,
so every seed gives the same work and a scale that holds for all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Scan, Volume

U16_MAX = 65535

# (density, x0, y0, z0, a, b, c, rotation deg) in units of the half extent
# (the Kak-Slaney 3D Shepp-Logan)
SHEPP_LOGAN = np.array([
    [1.00, 0.00, 0.00, 0.00, 0.690, 0.920, 0.810, 0.0],
    [-0.80, 0.00, -0.0184, 0.00, 0.6624, 0.874, 0.780, 0.0],
    [-0.20, 0.22, 0.00, 0.00, 0.110, 0.310, 0.220, -18.0],
    [-0.20, -0.22, 0.00, 0.00, 0.160, 0.410, 0.280, 18.0],
    [0.10, 0.00, 0.35, -0.15, 0.210, 0.250, 0.410, 0.0],
    [0.10, 0.00, 0.10, 0.25, 0.046, 0.046, 0.050, 0.0],
    [0.10, 0.00, -0.10, 0.25, 0.046, 0.046, 0.050, 0.0],
    [0.10, -0.08, -0.605, 0.00, 0.046, 0.023, 0.050, 0.0],
    [0.10, 0.00, -0.605, 0.00, 0.023, 0.023, 0.020, 0.0],
    [0.10, 0.06, -0.605, 0.00, 0.023, 0.046, 0.020, 0.0],
], dtype=np.float64)

SHIFT = 0.02          # largest move of a small feature's centre
DENSITY_SPREAD = 0.2  # largest relative change of a positive small density


def ellipsoids(seed: int) -> np.ndarray:
    """The phantom of ``seed``: Shepp-Logan with its small features
    (rows 2..9) moved and its positive small densities scaled."""
    rng = np.random.default_rng(int(seed))
    e = SHEPP_LOGAN.copy()
    e[2:, 1:4] += rng.uniform(-SHIFT, SHIFT, size=(len(e) - 2, 3))
    pos = np.arange(len(e)) >= 2
    pos &= e[:, 0] > 0
    e[pos, 0] *= 1.0 + rng.uniform(-DENSITY_SPREAD, DENSITY_SPREAD,
                                   size=int(pos.sum()))
    return e


def phantom_scale(vol: Volume) -> float:
    """The phantom's half extent in mm: 90 % of the volume's half width."""
    return vol.dim_x * vol.l_vx / 2 * 0.9


def count_scale(scale_mm: float) -> float:
    """Line integral per count: a bound on every ray's integral for every
    seed (each positive density at its largest, over its longest chord),
    at 65535 counts."""
    e = SHEPP_LOGAN
    pos = e[:, 0] > 0
    dens = e[pos, 0] * np.where(np.arange(len(e))[pos] >= 2,
                                1.0 + DENSITY_SPREAD, 1.0)
    bound = float(np.sum(dens * 2.0 * e[pos, 4:7].max(axis=1)) * scale_mm)
    return bound / U16_MAX


class Projector:
    """Projections of one seed's phantom under one scan, on ``device``:
    ``line_integrals(idx)`` (float32) and ``counts(idx)`` (uint16 counts
    as int16 bits, as a flat panel stores them), for projection indices
    ``idx`` at angles ``idx * delta_phi``."""

    def __init__(self, det: Scan, vol: Volume, seed: int, device):
        self.det = det
        self.device = torch.device(device)
        self.scale_mm = phantom_scale(vol)
        self.qscale = count_scale(self.scale_mm)
        n_row, n_col = det.n_row, det.n_col
        h_min = det.delta_s * det.l_px_row - n_row * det.l_px_row / 2.0
        v_min = det.delta_t * det.l_px_col - n_col * det.l_px_col / 2.0
        h = (h_min + (np.arange(n_row) + 0.5) * det.l_px_row)
        v = (v_min + (np.arange(n_col) + 0.5) * det.l_px_col)
        self.h = torch.from_numpy(h.astype(np.float32)).to(
            self.device).view(1, 1, n_row)
        self.v = torch.from_numpy(v.astype(np.float32)).to(
            self.device).view(1, n_col, 1)
        s = self.scale_mm
        self.table = []
        for A, x0, y0, z0, a, b, c, rot in ellipsoids(seed):
            th = np.deg2rad(rot)
            self.table.append(tuple(float(np.float32(x)) for x in (
                A, np.cos(th), np.sin(th), x0 * s, y0 * s, -z0 * s,
                1.0 / (a * s), 1.0 / (b * s), 1.0 / (c * s))))

    def line_integrals(self, idx) -> torch.Tensor:
        """(len(idx), n_col, n_row) float32 line integrals."""
        det = self.det
        d_so, d_sd = abs(det.d_so), det.d_sd
        phis = np.deg2rad(np.asarray(idx, np.float64) * det.delta_phi)
        phis = torch.from_numpy(phis.astype(np.float32)).to(self.device)
        sin = torch.sin(phis)[:, None, None]
        cos = torch.cos(phis)[:, None, None]
        sx = -d_so * cos
        sy = -d_so * sin
        dx = (d_sd - d_so) * cos - self.h * sin - sx
        dy = (d_sd - d_so) * sin + self.h * cos - sy
        dz = self.v
        norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
        acc = torch.zeros_like(norm)
        for A, ct, st, x0s, y0s, oz, ia, ib, ic in self.table:
            ox = sx - x0s
            oy = sy - y0s
            oxr = (ox * ct + oy * st) * ia
            oyr = (-ox * st + oy * ct) * ib
            ozr = oz * ic
            dxr = (dx * ct + dy * st) * ia
            dyr = (-dx * st + dy * ct) * ib
            dzr = dz * ic
            qa = dxr * dxr + dyr * dyr + dzr * dzr
            hb = oxr * dxr + oyr * dyr + ozr * dzr
            qc = oxr * oxr + oyr * oyr + ozr * ozr - 1.0
            disc4 = hb * hb - qa * qc
            hit = disc4 > 0.0
            chord = torch.where(hit, 2.0 * torch.sqrt(
                torch.where(hit, disc4, 0.0)) / qa, 0.0) * norm
            acc += A * chord
        return acc

    def counts(self, idx) -> torch.Tensor:
        """(len(idx), n_col, n_row) int16 holding the uint16 counts
        ``rint(p / qscale)``; raises if a count falls outside 0..65535."""
        c = torch.round(self.line_integrals(idx) / self.qscale)
        if bool(((c < 0) | (c > U16_MAX)).any()):
            raise RuntimeError("a count fell outside 0..65535")
        return torch.where(c > 32767, c - 65536, c).to(torch.int16)


def as_float(counts: torch.Tensor) -> torch.Tensor:
    """int16-held uint16 counts as float64."""
    return counts.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float64)
