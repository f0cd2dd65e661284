"""The work count of the backprojection kernel (K1) and the card's
published peaks: a frozen copy of ``k1_compare.k1_bound_ms``'s counts,
taken per block pass rather than per launch, so that a change of chunk
size does not move the yardstick."""

from __future__ import annotations

from typing import Tuple

# NVIDIA's data sheet, H100 SXM at its 700 W limit: float32 outside the
# tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# float32 operations of one voxel update (an FMA counts 2): the v
# coordinate (2), two row lerps (6), the column lerp (4), weight and add
# (2), 1 - fv (1); and of one (x, y) column per angle: s, t, the source
# clamp's sum, the reciprocal, f, u, the weight, h, its fraction and the
# row scale (19)
FLOP_PER_UPDATE = 15
FLOP_PER_COLUMN_ANGLE = 19


def k1_pass_least_s(dz: int, ny: int, nx: int, n_proj: int, band_rows: int,
                    n_row: int, elem_bytes: int) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one block pass of K1: ``dz``
    slices of ny x nx updated from ``n_proj`` projections, each read once
    as ``band_rows`` rows of ``n_row`` pixels of ``elem_bytes``; the
    accumulator read and written once, each angle's sine and cosine read
    once.  The larger of operations over the float32 peak and bytes over
    the HBM peak."""
    flops = (dz * ny * nx * n_proj * FLOP_PER_UPDATE
             + ny * nx * n_proj * FLOP_PER_COLUMN_ANGLE)
    nbytes = (2 * 4 * dz * ny * nx + n_proj * band_rows * n_row * elem_bytes
              + 2 * 4 * n_proj)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
