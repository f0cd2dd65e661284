"""Scan geometry as the benchmark reckons it: a frozen copy of the
reference's formulas (src/geometry.cpp:36-67, the detector-row band of
the repository's geometry module), so that the yardstick and the plain
reference need nothing of the program."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Scan:
    """A flat-panel detector on a circular orbit, the fields of a ``.geo``
    file: ``n_row`` pixels per row (frame width), ``n_col`` rows (frame
    height), pitches in mm, offsets in pixels, distances in mm,
    ``delta_phi`` degrees between projections."""
    n_row: int
    n_col: int
    l_px_row: float
    l_px_col: float
    delta_s: float
    delta_t: float
    d_so: float
    d_od: float
    delta_phi: float

    @property
    def d_sd(self) -> float:
        return abs(self.d_so) + abs(self.d_od)


@dataclasses.dataclass(frozen=True)
class Volume:
    """The derived volume: dims in voxels, cubic voxel pitch in mm."""
    dim_x: int
    dim_y: int
    dim_z: int
    l_vx: float


def scan_from(config: dict, **changes) -> Scan:
    """The ``Scan`` a configuration file's ``scan`` object states."""
    s = dict(config["scan"])
    fields = {f.name for f in dataclasses.fields(Scan)}
    kw = {k: s[k] for k in fields if k in s}
    if "delta_phi" not in kw:
        kw["delta_phi"] = float(s["orbit_deg"]) / int(s["n_proj"])
    kw.update(changes)
    return Scan(**kw)


def derive_volume(det: Scan) -> Volume:
    """The reconstructable volume of ``det`` (src/geometry.cpp:36-67)."""
    delta_s_mm = abs(det.delta_s * det.l_px_row)
    delta_t_mm = abs(det.delta_t * det.l_px_col)
    d_so = abs(det.d_so)
    d_sd = abs(det.d_od) + d_so
    half_width = (float(det.n_row) * det.l_px_row) / 2.0 + delta_s_mm
    alpha = math.atan(half_width / d_sd)
    r = d_so * math.sin(alpha)
    l_vx = r / (half_width / det.l_px_row)
    dim_x = int((2.0 * r) / l_vx)
    dim_z = int(((float(det.n_col) * det.l_px_col / 2.0) + delta_t_mm)
                * (d_so / d_sd) * (2.0 / l_vx))
    return Volume(dim_x, dim_x, dim_z, l_vx)


def row_band(det: Scan, vol: Volume, z0: int, dim_z: int,
             margin_px: int = 2) -> Tuple[int, int]:
    """Detector rows [lo, hi) that slices z0 .. z0 + dim_z - 1 can sample:
    the corner radius's largest magnification over the block's z range."""
    d_so = abs(det.d_so)
    r = min((vol.dim_x / 2.0) * vol.l_vx * math.sqrt(2.0), d_so * 0.95)
    max_factor = det.d_sd / max(d_so - r, 1e-6)
    half_z = vol.dim_z * vol.l_vx / 2.0
    z_lo = -half_z + vol.l_vx / 2.0 + z0 * vol.l_vx
    z_hi = z_lo + (dim_z - 1) * vol.l_vx
    t_lo = min(z_lo * max_factor, z_lo * det.d_sd / (d_so + r))
    t_hi = max(z_hi * max_factor, z_hi * det.d_sd / (d_so + r))
    v_min = -det.delta_t * det.l_px_col - det.n_col * det.l_px_col / 2.0
    lo = int(math.floor((t_lo - v_min) / det.l_px_col - 0.5)) - margin_px
    hi = int(math.ceil((t_hi - v_min) / det.l_px_col + 0.5)) + 1 + margin_px
    return max(0, lo), min(det.n_col, max(0, hi))


def filter_size(n_row: int) -> int:
    """Ramp-filter FFT length: 2 * next_pow2(n_row)
    (src/filtering.cpp:37)."""
    return int(2 * 2 ** math.ceil(math.log2(max(2, n_row))))
