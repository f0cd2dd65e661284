"""paris_tpu_torch — the FDK reconstruction path of ``paris_tpu`` in
PyTorch, with its backprojection kernel, and the kernels of its gather
micro-benchmarks, written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).

The JAX package stays the reference.  This package imports ``torch`` and
never ``jax``, and nothing of ``paris_tpu``: it keeps its own copies of
the JAX package's JAX-free modules (geometry, exceptions, the golden
oracle, the NumPy phantom projector, the I/O modules with their native
library, logging), under the same names.
"""

from .exceptions import (
    ParisError,
    StageConstructionError,
    StageRuntimeError,
)
from .geometry import (
    DetectorGeometry,
    VolumeGeometry,
    RegionOfInterest,
    SubvolumeInfo,
    ZBlock,
    derive_volume_geometry,
    apply_roi,
    plan_z_blocks,
    detector_row_band,
    filter_size_for,
)

__version__ = "0.1.0"
