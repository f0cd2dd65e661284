"""paris_tpu_torch — the FDK reconstruction path of ``paris_tpu`` in
PyTorch, with its backprojection kernel, and the kernels of its gather
micro-benchmarks, written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).

The JAX package stays the reference.  This package imports ``torch`` and
never ``jax``: the geometry, golden oracle, phantom projector and I/O
modules of ``paris_tpu`` are JAX-free and are used as they are.
"""

from paris_tpu.exceptions import (
    ParisError,
    StageConstructionError,
    StageRuntimeError,
)
from paris_tpu.geometry import (
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
