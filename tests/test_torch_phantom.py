"""paris_tpu_torch.phantom.cone_beam_project_torch, the counterpart of the
JAX package's accelerator projector (``paris_tpu/phantom.py:133-210``),
against it on CPU JAX and against the float64 NumPy projector, on the
CPU (no card)."""

import numpy as np
import pytest
import torch

from paris_tpu.geometry import DetectorGeometry as JaxDetector
from paris_tpu.phantom import cone_beam_project as jax_numpy_project
from paris_tpu.phantom import cone_beam_project_jax
from paris_tpu_torch import phantom
from paris_tpu_torch.geometry import DetectorGeometry, derive_volume_geometry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (n_row, n_col, l_px_row, l_px_col, delta_s, delta_t, d_so, d_od,
#  delta_phi), angles
GEOMETRIES = {
    # tests/test_golden_fdk_e2e.py:18-27, its first 8 angles
    "scan64": ((64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0),
               np.arange(8, dtype=np.float32) * 2.0),
    # BASELINE config 4's offset detector (benchmarks/run_configs.py:201)
    "config4_offset": ((96, 80, 2.0, 2.0, 4.6, -1.5, 500.0, 500.0, 3.0),
                       np.asarray([0.0, 3.0, 47.5, 90.0, 133.0, 181.5,
                                   270.0, 333.0], np.float32)),
}
# gates of tests/test_golden_fdk_e2e.py:91-103: relative RMSE, and the
# largest error against the largest value (tangent-ray rims)
GATE_RMSE, GATE_MAX = 1e-3, 0.05


def _scan(name):
    args, angles = GEOMETRIES[name]
    det = DetectorGeometry(*args)
    vol = derive_volume_geometry(det)
    return det, JaxDetector(*args), angles, vol.dim_x * vol.l_vx_x / 2 * 0.9


@pytest.mark.parametrize("reference", ["jax", "numpy"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_projector_matches_reference(name, reference):
    det, jdet, angles, scale = _scan(name)
    got = phantom.cone_beam_project_torch(det, angles, scale, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == (len(angles), det.n_col, det.n_row)
    if reference == "jax":
        ref = np.asarray(cone_beam_project_jax(jdet, angles, scale))
    else:
        ref = jax_numpy_project(jdet, angles, scale)
    got = got.numpy()
    s = float(np.abs(ref).max())
    rmse = float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)))
    assert rmse / s < GATE_RMSE, f"relative RMSE {rmse / s:.2e}"
    assert np.abs(got - ref).max() / s < GATE_MAX


def test_projector_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    det, _, angles, scale = _scan("scan64")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        phantom.cone_beam_project_torch(det, angles, scale)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        phantom.projector_device()
    assert phantom.projector_device("cpu") == torch.device("cpu")


def test_projector_constants_are_built_once_per_geometry():
    """The per-geometry constants are cached, as the JAX package caches
    its jitted projector per geometry; a batch is the frames one at a
    time, bit for bit."""
    det, _, angles, scale = _scan("config4_offset")
    phantom._projector_constants.cache_clear()
    batch = phantom.cone_beam_project_torch(det, angles, scale, device="cpu")
    ones = [phantom.cone_beam_project_torch(det, angles[i:i + 1], scale,
                                            device="cpu")
            for i in range(len(angles))]
    info = phantom._projector_constants.cache_info()
    assert (info.misses, info.hits) == (1, len(angles))
    assert torch.equal(batch, torch.cat(ones))
