"""Ramp (Ram-Lak) filtering along detector rows (port of
``paris_tpu/ops/filtering.py``).

Rows are zero-padded to ``filter_size_for(n_row)``, transformed with a
batched real FFT (cuFFT on the card), multiplied by the real spectrum
K = tau*|rfft(r)|, transformed back and cropped to ``n_row``.
``irfft``'s default "backward" norm is the same 1/n as the reference's
explicit division by the filter size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import filter_size_for

__all__ = ["ramp_kernel_real", "ramp_filter_spectrum", "filter_projections"]


def ramp_kernel_real(filter_size: int, tau: float) -> np.ndarray:
    """Spatial-domain ramp kernel r(j) (host-side, float32).

    Copied from ``paris_tpu/ops/filtering.py:ramp_kernel_real``, whose
    module imports JAX.
    """
    j = np.arange(filter_size, dtype=np.int64) - (filter_size - 2) // 2
    r = np.zeros(filter_size, dtype=np.float64)
    r[j == 0] = 1.0 / (8.0 * tau * tau)
    odd = (j % 2) != 0
    r[odd] = -1.0 / (2.0 * j[odd].astype(np.float64) ** 2 * np.pi**2 * tau * tau)
    return r.astype(np.float32)


def ramp_filter_spectrum(n_row: int, tau: float, device) -> torch.Tensor:
    """K = tau * |rfft(r)|, shape (filter_size//2 + 1,) float32.

    Built in float64 NumPy and cast to float32, as the JAX package does.
    """
    size = filter_size_for(n_row)
    r = ramp_kernel_real(size, tau)
    spectrum = np.abs(np.fft.rfft(r.astype(np.float64))) * tau
    return torch.from_numpy(spectrum.astype(np.float32)).to(device)


def filter_projections(projections: torch.Tensor, spectrum: torch.Tensor,
                       n_row: int) -> torch.Tensor:
    """Ramp-filter a (..., n_col, n_row) float32 block along rows."""
    size = filter_size_for(n_row)
    spec = torch.fft.rfft(projections, n=size, dim=-1)
    filtered = torch.fft.irfft(spec * spectrum, n=size, dim=-1)
    return filtered[..., :n_row]
