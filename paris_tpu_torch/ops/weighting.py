"""FDK cosine weighting (port of ``paris_tpu/ops/weighting.py``).

    h_s = l_px_row/2 + s*l_px_row + h_min
    v_t = l_px_col/2 + t*l_px_col + v_min
    w   = d_sd / sqrt(d_sd^2 + h_s^2 + v_t^2)

The map depends only on the geometry, so it is built once per run as an
(n_col, n_row) tensor on the target device and applied as a broadcast
multiply over a whole projection chunk.
"""

from __future__ import annotations

import torch

from ..geometry import DetectorGeometry, weighting_constants

__all__ = ["weight_map", "apply_weights"]


def weight_map(det: DetectorGeometry, device, dtype=torch.float32
               ) -> torch.Tensor:
    """(n_col, n_row) FDK cosine-weight image for this detector."""
    h_min, v_min, d_sd = weighting_constants(det)
    s = torch.arange(det.n_row, dtype=torch.float32, device=device)
    t = torch.arange(det.n_col, dtype=torch.float32, device=device)
    h_s = det.l_px_row / 2.0 + s * det.l_px_row + h_min       # (n_row,)
    v_t = det.l_px_col / 2.0 + t * det.l_px_col + v_min       # (n_col,)
    w = d_sd / torch.sqrt(d_sd * d_sd + h_s[None, :] ** 2 + v_t[:, None] ** 2)
    return w.to(dtype)


def apply_weights(projections: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """Multiply a (..., n_col, n_row) projection chunk by the weight map."""
    return projections * weights
