"""Weighting, filtering and backprojection ops of the PyTorch port."""

from .weighting import weight_map, apply_weights
from .filtering import (ramp_kernel_real, ramp_filter_spectrum,
                        filter_projections)
from .backprojection_torch import (BpGrid, make_bp_grid,
                                   backproject_chunk_torch)
from .backprojection_cuda import backproject_chunk_cuda, backproject_chunk
