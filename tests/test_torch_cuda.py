"""The CUDA backprojection kernel against its plain PyTorch version, on
the card.  Every test here is marked ``cuda`` and skips without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

It also holds the backprojection cases of tests/test_pallas_kernel.py
(:40-97 and :254) as plain NumPy inputs, which
tests/test_torch_backprojection.py holds against the JAX package.
"""

import numpy as np
import pytest
import torch

from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu_torch.ops.backprojection_cuda import (backproject_chunk,
                                                     backproject_chunk_cuda)
from paris_tpu_torch.ops.backprojection_torch import (backproject_chunk_torch,
                                                      make_bp_grid)

BASE = DetectorGeometry(96, 80, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
OFFSET = DetectorGeometry(96, 80, 2.0, 2.0, 4.6, -2.0, 500.0, 500.0, 2.0)
TALL = DetectorGeometry(96, 640, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)

CASES = ["zero", "accumulate", "z_offset_roi", "offset_detector",
         "top_edge", "tall_center"]


def bp_case(name):
    """(det, vol, projections, angles_deg, initial volume, z_offset, roi,
    atol against the JAX ops) for one case of tests/test_pallas_kernel.py."""
    if name in ("zero", "accumulate", "z_offset_roi"):
        det, seed, ang = BASE, 7, [0.0, 33.0, 261.5]
    elif name == "offset_detector":
        det, seed, ang = OFFSET, 9, [10.0, 190.0]
    else:
        det, seed, ang = TALL, 23, [15.0, 200.0]
    vol = derive_volume_geometry(det)
    rng = np.random.default_rng(seed)
    projs = rng.standard_normal((len(ang), det.n_col, det.n_row)).astype(
        np.float32)
    shape, z_off, roi, atol = vol.shape_zyx, 0, (0, 0, 0), 1e-4
    if name == "z_offset_roi":
        shape, z_off, roi = (16, vol.dim_y, vol.dim_x), 24, (5, 3, 2)
    elif name in ("top_edge", "tall_center"):
        # n_col=640, z0=536 (:254) and the centre; atol 5e-4 as in
        # test_pallas_kernel.py:156-159: v reaches ~600 px there, where
        # one float32 ulp of v moves a sample by ~1e-4
        z_off = 536 if name == "top_edge" else vol.dim_z // 2 - 8
        shape, atol = (16, vol.dim_y, vol.dim_x), 5e-4
    vol0 = np.zeros(shape, np.float32)
    if name == "accumulate":
        vol0 = np.random.default_rng(8).standard_normal(shape).astype(
            np.float32)
    return det, vol, projs, np.asarray(ang, np.float32), vol0, z_off, roi, atol


def sincos(ang_deg):
    phi = np.deg2rad(ang_deg).astype(np.float32)
    return np.sin(phi), np.cos(phi)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _on_card(dev, name, dtype):
    det, vol, projs, ang, vol0, z_off, roi, _ = bp_case(name)
    sin, cos = sincos(ang)
    args = (torch.from_numpy(projs).to(dev, dtype),
            torch.from_numpy(sin).to(dev), torch.from_numpy(cos).to(dev),
            make_bp_grid(det, vol), z_off, roi)
    return torch.from_numpy(vol0).to(dev), args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(cuda_device, name, dtype):
    """Gate: max|kernel - plain| <= 1e-4 max|plain|.  Both read the same
    (bf16-rounded in fast mode) projections and pick the same taps; they
    differ only in the rounding of the bilinear lerp."""
    vol0, args = _on_card(cuda_device, name, dtype)
    plain = backproject_chunk_torch(vol0.clone(), *args)
    before = backproject_chunk_cuda.launches
    kern = backproject_chunk_cuda(vol0.clone(), *args)
    torch.cuda.synchronize(cuda_device)
    assert backproject_chunk_cuda.launches == before + 1
    scale = float(plain.abs().max())
    assert float((kern - plain).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_dispatch_sends_card_tensors_to_kernel(cuda_device):
    vol0, args = _on_card(cuda_device, "zero", torch.float32)
    before = backproject_chunk_cuda.launches
    backproject_chunk(vol0, *args)
    assert backproject_chunk_cuda.launches == before + 1


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs(cuda_device):
    vol0, (p, s, c, grid, z_off, roi) = _on_card(cuda_device, "zero",
                                                 torch.float32)
    before = backproject_chunk_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        backproject_chunk_cuda(vol0.transpose(1, 2), p, s, c, grid)
    with pytest.raises(ValueError, match="float32"):
        backproject_chunk_cuda(vol0, p.half(), s, c, grid)
    with pytest.raises(ValueError, match="cpu"):
        backproject_chunk_cuda(vol0, p, s.cpu(), c, grid)
    assert backproject_chunk_cuda.launches == before
