"""The CUDA kernels (backprojection: unbanded, banded, its other
staging paths and block shapes, and its taps from global memory where no
tile ring fits; gather micro-benchmarks K3a and K3b) against their plain PyTorch versions, and
the world-1 NCCL distributed path against the single-device one, on the
card.  Every test here is marked ``cuda`` and skips without a card.

This file imports no JAX and nothing of the JAX package, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

It also holds the backprojection cases of tests/test_pallas_kernel.py
(:40-97 and :254) as plain NumPy inputs, which
tests/test_torch_backprojection.py holds against the JAX package.
"""

import numpy as np
import pytest
import torch

from paris_tpu_torch.geometry import (DetectorGeometry, VolumeGeometry,
                                      derive_volume_geometry,
                                      detector_row_band)
from paris_tpu_torch.benchmarks import gather_micro as gm
from paris_tpu_torch.benchmarks import gather_micro2 as gm2
from paris_tpu_torch.ops.backprojection_cuda import (
    COPY_ELEMENT, COPY_GLOBAL, RING, SHAPES, TilePlan, backproject_chunk,
    backproject_chunk_cuda, blocks_per_sm, compiled_shapes, launch_plan)
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


# (det, vol) whose launches take the other paths of the kernel: rows whose
# bytes are not 16-B aligned (element-wise staging, no cp.async), and
# voxels 6 pixels wide (the smaller block shape in float32)
PATHS = {
    "unaligned_rows": (DetectorGeometry(70, 48, 2.0, 2.0, 1.5, 0.5, 500.0,
                                        500.0, 2.0), None),
    "coarse_voxels": (DetectorGeometry(1024, 1024, 1.0, 1.0, 0.0, 0.0,
                                       2000.0, 2000.0, 1.0),
                      VolumeGeometry(dim_x=48, dim_y=48, dim_z=48,
                                     l_vx_x=3.0, l_vx_y=3.0, l_vx_z=3.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_kernel_paths_match_plain_on_card(cuda_device, path, dtype):
    det, vol = PATHS[path]
    vol = vol or derive_volume_geometry(det)
    rng = np.random.default_rng(17)
    projs = torch.from_numpy(rng.standard_normal(
        (5, det.n_col, det.n_row)).astype(np.float32)).to(cuda_device, dtype)
    sin, cos = (torch.from_numpy(a).to(cuda_device)
                for a in sincos(np.asarray([3.0, 81.0, 150.5, 222.0, 300.0],
                                           np.float32)))
    grid = make_bp_grid(det, vol)
    shape = (vol.dim_z - 3, vol.dim_y, vol.dim_x)     # a ragged last z group
    plan = launch_plan(grid, shape, projs, 2)
    if path == "unaligned_rows":
        assert plan.copy == COPY_ELEMENT
    else:
        assert plan.shape == (1 if dtype == torch.float32 else 0)
    assert blocks_per_sm(plan, dtype == torch.bfloat16, cuda_device) >= 1
    zero = torch.zeros(shape, device=cuda_device)
    plain = backproject_chunk_torch(zero.clone(), projs, sin, cos, grid, 2)
    kern = backproject_chunk_cuda(zero.clone(), projs, sin, cos, grid, 2)
    torch.cuda.synchronize(cuda_device)
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((kern - plain).abs().max()) <= 1e-4 * scale


# (det, vol) whose tiles no block shape's ring fits (as in
# tests/test_torch_tile_plan.py): a volume reaching the source of a large
# detector, and voxels 12 detector pixels wide
NO_RING = {
    "near_source": (DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 60.0,
                                     60.0, 2.0),
                    VolumeGeometry(dim_x=40, dim_y=40, dim_z=8,
                                   l_vx_x=4.0, l_vx_y=4.0, l_vx_z=4.0)),
    "coarse_preview": (DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0,
                                        2048.0, 1024.0, 1.0),
                       VolumeGeometry(dim_x=96, dim_y=96, dim_z=48,
                                      l_vx_x=2.0, l_vx_y=2.0, l_vx_z=2.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(NO_RING))
def test_no_ring_fits_takes_global_taps_on_card(cuda_device, case, dtype):
    """No block shape's ring fits: the wrapper launches the kernel's
    global-memory taps (not the plain version), within 1e-4 max|plain| of
    the plain version."""
    det, vol = NO_RING[case]
    rng = np.random.default_rng(31)
    projs = torch.from_numpy(rng.standard_normal(
        (4, det.n_col, det.n_row)).astype(np.float32)).to(cuda_device, dtype)
    sin, cos = (torch.from_numpy(a).to(cuda_device)
                for a in sincos(np.asarray([0.0, 47.0, 133.5, 290.0],
                                           np.float32)))
    grid = make_bp_grid(det, vol)
    plan = launch_plan(grid, vol.shape_zyx, projs, 0)
    assert plan.copy == COPY_GLOBAL and plan.smem == 0
    assert blocks_per_sm(plan, dtype == torch.bfloat16, cuda_device) >= 1
    zero = torch.zeros(vol.shape_zyx, device=cuda_device)
    plain = backproject_chunk_torch(zero.clone(), projs, sin, cos, grid)
    before = backproject_chunk_cuda.launches
    kern = backproject_chunk(zero.clone(), projs, sin, cos, grid)
    torch.cuda.synchronize(cuda_device)
    assert backproject_chunk_cuda.launches == before + 1
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((kern - plain).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_global_taps_equal_staged_taps_on_card(cuda_device, name, dtype):
    """The global-memory instantiation, forced where a ring fits, equals
    the staged kernel bit for bit: the same taps, the same arithmetic."""
    vol0, args = _on_card(cuda_device, name, dtype)
    p, grid = args[0], args[3]
    staged = backproject_chunk_cuda(vol0.clone(), *args)
    plan = TilePlan(0, COPY_GLOBAL, grid.det.n_row, p.shape[1], 0)
    direct = backproject_chunk_cuda(vol0.clone(), *args, plan=plan)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(direct, staged)


@pytest.mark.cuda
def test_library_shapes_match_the_planner(cuda_device):
    assert compiled_shapes() == (SHAPES, RING)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["top_edge", "tall_center"])
def test_banded_kernel_on_card(cuda_device, name, dtype):
    """K1c: the kernel on the block's detector-row band equals the kernel
    on the whole detector bit for bit, and is within 1e-4 max|plain| of
    the plain version on the same band."""
    vol0, (p, s, c, grid, z_off, roi) = _on_card(cuda_device, name, dtype)
    det, vol = grid.det, grid.vol
    lo, hi = detector_row_band(det, vol, z_off, vol0.shape[0])
    assert hi - lo < det.n_col
    band = p[:, lo:hi].contiguous()
    whole = backproject_chunk_cuda(vol0.clone(), p, s, c, grid, z_off, roi)
    banded = backproject_chunk_cuda(vol0.clone(), band, s, c, grid, z_off,
                                    roi, v_lo=lo)
    plain = backproject_chunk_torch(vol0.clone(), band, s, c, grid, z_off,
                                    roi, v_lo=lo)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(banded, whole)
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((banded - plain).abs().max()) <= 1e-4 * scale
    with pytest.raises(ValueError, match="does not lie"):
        backproject_chunk_cuda(vol0, band, s, c, grid, z_off, roi,
                               v_lo=det.n_col - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("accuracy", ["exact", "fast"])
def test_world1_nccl_distributed_equals_reconstructor(cuda_device, tmp_path,
                                                      accuracy):
    """A world-1 NCCL group: DistributedReconstructor (real all-gathers)
    equals Reconstructor bit for bit, both through the kernel."""
    import torch.distributed as dist
    from paris_tpu_torch.parallel.dist import DistributedReconstructor
    from paris_tpu_torch.pipeline import Reconstructor
    det = DetectorGeometry(64, 160, 2.0, 2.0, 0.0, 0.0, 400.0, 400.0, 9.0)
    vol = derive_volume_geometry(det)
    rng = np.random.default_rng(4)
    projs = rng.standard_normal((24, det.n_col, det.n_row)).astype(
        np.float32)
    angles = np.arange(24, dtype=np.float32) * 9.0
    shape = (40, vol.dim_y, vol.dim_x)
    kw = dict(chunk_size=8, block_shape=shape, backend="cuda",
              accuracy=accuracy, device=cuda_device, v_band_width=64)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1, device_id=cuda_device)
    try:
        before = backproject_chunk_cuda.launches
        rec = DistributedReconstructor(det, vol, **kw)
        got = rec.finalize(rec.accumulate(rec.init_block(), projs, angles,
                                          z_offset=80))
        assert backproject_chunk_cuda.launches == before + 3
    finally:
        dist.destroy_process_group()
    ref = Reconstructor(det, vol, **kw).run(projs, angles, z_offset=80)
    assert np.abs(ref).max() > 0
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------- gather micro-benchmarks K3a/K3b

@pytest.mark.cuda
@pytest.mark.parametrize("mode,S", [("empty", 32)] + list(gm.CASES))
def test_gather_micro_kernel_matches_plain_on_card(cuda_device, mode, S):
    """Every block slice of the kernel's output equals the plain tile, as
    int32."""
    tab, idx = gm.inputs(cuda_device)
    plain = gm.gather_micro_torch(mode, S, tab, idx)
    before = gm.gather_micro_cuda.launches
    out = gm.gather_micro_cuda(mode, S, tab, idx)
    torch.cuda.synchronize(cuda_device)
    assert gm.gather_micro_cuda.launches == before + 1
    assert out.shape == (gm.BLOCKS, 64, 128)
    assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", gm2.MODES)
def test_gather_micro2_kernel_matches_plain_on_card(cuda_device, mode):
    k0, tab, idx = gm2.inputs(cuda_device)
    plain = gm2.gather_micro2_torch(mode, k0, tab, idx)
    before = gm2.gather_micro2_cuda.launches
    out = gm2.gather_micro2_cuda(mode, k0, tab, idx)
    torch.cuda.synchronize(cuda_device)
    assert gm2.gather_micro2_cuda.launches == before + 1
    assert out.shape == (gm2.BLOCKS, 64, 128)
    assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
def test_gather_micro2_kernel_clamps_windows(cuda_device):
    k0, tab, idx = gm2.inputs(cuda_device)
    far = k0 + 40
    for mode in ("dyn_read", "dyn_take2"):
        out = gm2.gather_micro2_cuda(mode, far, tab, idx, blocks=2)
        plain = gm2.gather_micro2_torch(mode, far, tab, idx)
        torch.cuda.synchronize(cuda_device)
        assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
def test_gather_wrappers_refuse_bad_inputs(cuda_device):
    tab, idx = gm.inputs(cuda_device)
    k0, tab2, _ = gm2.inputs(cuda_device)
    before = (gm.gather_micro_cuda.launches, gm2.gather_micro2_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gm.gather_micro_cuda("lane", 128, tab.cpu(), idx)
    with pytest.raises(ValueError, match="cpu"):
        gm.gather_micro_cuda("lane", 128, tab, idx.cpu())
    with pytest.raises(ValueError, match="int32"):
        gm.gather_micro_cuda("lane", 128, tab.float(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gm.gather_micro_cuda("lane", 128, tab.transpose(1, 2), idx)
    with pytest.raises(ValueError, match="blocks"):
        gm.gather_micro_cuda("lane", 128, tab, idx, blocks=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gm2.gather_micro2_cuda("dyn_take", k0, tab2.cpu(), idx)
    with pytest.raises(ValueError, match="int32"):
        gm2.gather_micro2_cuda("dyn_take", k0.long(), tab2, idx)
    assert (gm.gather_micro_cuda.launches,
            gm2.gather_micro2_cuda.launches) == before
