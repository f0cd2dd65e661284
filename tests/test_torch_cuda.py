"""The CUDA kernels (backprojection: unbanded, banded, its other
staging paths and block shapes, and its taps from global memory where no
tile ring fits; gather micro-benchmarks K3a and K3b) against their plain PyTorch versions,
the world-1 NCCL distributed path against the single-device one, the
ingest's pinned ring and the output drain's (bytes, the accumulator's
lifetime, slot reuse, pinned bytes), on the card.  Every test here is
marked ``cuda`` and skips without a card.

This file imports no JAX and nothing of the JAX package, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

It also holds the backprojection cases of tests/test_pallas_kernel.py
(:40-97 and :254) as plain NumPy inputs, which
tests/test_torch_backprojection.py holds against the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from paris_tpu_torch.geometry import (DetectorGeometry, VolumeGeometry,
                                      derive_volume_geometry,
                                      detector_row_band)
from paris_tpu_torch.benchmarks import gather_micro as gm
from paris_tpu_torch.benchmarks import gather_micro2 as gm2
from paris_tpu_torch.ops.backprojection_cuda import (
    COPY_ELEMENT, COPY_GLOBAL, COPY_NAMES, RING, SHAPES, TilePlan,
    backproject_chunk, backproject_chunk_cuda, blocks_per_sm,
    compiled_shapes, launch_plan)
from paris_tpu_torch.ops.backprojection_torch import (backproject_chunk_torch,
                                                      make_bp_grid)

BASE = DetectorGeometry(96, 80, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
OFFSET = DetectorGeometry(96, 80, 2.0, 2.0, 4.6, -2.0, 500.0, 500.0, 2.0)
TALL = DetectorGeometry(96, 640, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)

CASES = ["zero", "accumulate", "z_offset_roi", "offset_detector",
         "top_edge", "tall_center"]

# Cases at the edges of the kernel's floor of v: at angle 0 the voxel
# centres of the middle x column project exactly onto detector rows (the
# detector is offset by half a pixel, the magnification 2 of 2-mm pixels
# maps 1-mm voxels to one row each, and f = 2, 1/l_px_col = 1/2 are exact),
# so v = z - 8 is integral: in the interior z step (a block of rows
# 8..55), and through v = 0 and v = n_col - 2 = 78 in the border step (the
# whole volume, v from -8 to 88).
EDGE = DetectorGeometry(96, 80, 2.0, 2.0, 0.0, 0.5, 256.0, 256.0, 2.0)
EDGE_VOLUME = VolumeGeometry(dim_x=49, dim_y=40, dim_z=97, l_vx_x=1.0,
                             l_vx_y=1.0, l_vx_z=1.0)
EDGE_CASES = ["row_boundaries", "border_limits"]


def bp_case(name):
    """(det, vol, projections, angles_deg, initial volume, z_offset, roi,
    atol against the JAX ops) for one case of tests/test_pallas_kernel.py."""
    if name in EDGE_CASES:
        det, seed, ang = EDGE, 41, [0.0, 33.0, 180.0, 261.5]
    elif name in ("zero", "accumulate", "z_offset_roi"):
        det, seed, ang = BASE, 7, [0.0, 33.0, 261.5]
    elif name in ("offset_detector", "offset_block"):
        det, seed, ang = OFFSET, 9, [10.0, 190.0]
    else:
        det, seed, ang = TALL, 23, [15.0, 200.0]
    vol = EDGE_VOLUME if det is EDGE else derive_volume_geometry(det)
    rng = np.random.default_rng(seed)
    projs = rng.standard_normal((len(ang), det.n_col, det.n_row)).astype(
        np.float32)
    shape, z_off, roi, atol = vol.shape_zyx, 0, (0, 0, 0), 1e-4
    if name == "z_offset_roi":
        shape, z_off, roi = (16, vol.dim_y, vol.dim_x), 24, (5, 3, 2)
    elif name == "row_boundaries":
        shape, z_off = (48, vol.dim_y, vol.dim_x), 16
    elif name == "offset_block":
        # a block inside the detector at delta_t = -2: band rows 26..50
        shape, z_off = (16, vol.dim_y, vol.dim_x), 34
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
@pytest.mark.parametrize("name", CASES + EDGE_CASES)
def test_kernel_matches_plain_on_card(cuda_device, name, dtype):
    """Gate: max|kernel - plain| <= 1e-4 max|plain|.  Both read the same
    (bf16-rounded in fast mode) projections and pick the same taps; they
    differ only in the rounding of the bilinear lerp."""
    vol0, args = _on_card(cuda_device, name, dtype)
    plain = backproject_chunk_torch(vol0.clone(), *args)
    before = backproject_chunk_cuda.launches
    by_copy = dict(backproject_chunk_cuda.launches_by_copy)
    kern = backproject_chunk_cuda(vol0.clone(), *args)
    torch.cuda.synchronize(cuda_device)
    assert backproject_chunk_cuda.launches == before + 1
    by_copy["async"] += 1
    assert backproject_chunk_cuda.launches_by_copy == by_copy
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
    mode = COPY_NAMES[plan.copy]
    before = backproject_chunk_cuda.launches_by_copy[mode]
    kern = backproject_chunk_cuda(zero.clone(), projs, sin, cos, grid, 2)
    torch.cuda.synchronize(cuda_device)
    assert backproject_chunk_cuda.launches_by_copy[mode] == before + 1
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
    direct = backproject_chunk_cuda.launches_by_copy["global"]
    kern = backproject_chunk(zero.clone(), projs, sin, cos, grid)
    torch.cuda.synchronize(cuda_device)
    assert backproject_chunk_cuda.launches == before + 1
    assert backproject_chunk_cuda.launches_by_copy["global"] == direct + 1
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((kern - plain).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES + EDGE_CASES)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES + EDGE_CASES)
def test_fast_pitch_equals_launch_pitch_on_card(cuda_device, name, dtype):
    """The kernel compiled for tiles of 64 elements, which these cases'
    plans take, equals the one at the launch's pitch, forced by a plan of
    128, bit for bit."""
    vol0, args = _on_card(cuda_device, name, dtype)
    p, z_off, roi = args[0], args[4], args[5]
    plan = launch_plan(args[3], vol0.shape, p, roi[2] + z_off, roi[:2])
    assert (plan.shape, plan.pitch) == (0, 64)
    wide = dataclasses.replace(
        plan, pitch=128,
        smem=plan.smem + RING * plan.tile_h * 64 * p.element_size())
    fast = backproject_chunk_cuda(vol0.clone(), *args)
    other = backproject_chunk_cuda(vol0.clone(), *args, plan=wide)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(other, fast)


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
    # a detector row past 2^22 pixels, beyond the kernel's floor of h
    wide = DetectorGeometry((1 << 22) + 8, 4, 1.0, 1.0, 0.0, 0.0, 100.0,
                            100.0, 1.0)
    tiny = VolumeGeometry(dim_x=8, dim_y=8, dim_z=2, l_vx_x=1.0, l_vx_y=1.0,
                          l_vx_z=1.0)
    one = torch.zeros(1, device=cuda_device)
    with pytest.raises(ValueError, match="pixels a side"):
        backproject_chunk_cuda(
            torch.zeros((2, 8, 8), device=cuda_device),
            torch.zeros((1, 4, wide.n_row), device=cuda_device), one, one,
            make_bp_grid(wide, tiny))
    assert backproject_chunk_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["top_edge", "tall_center", "offset_block"])
def test_banded_kernel_on_card(cuda_device, name, dtype):
    """K1c: the kernel on the block's detector-row band equals the kernel
    on the whole detector bit for bit, and is within 1e-4 max|plain| of
    the plain version on the same band (at a vertically offset detector
    too, where the band follows the backprojection's -delta_t)."""
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

def k3a_inputs(which, dev):
    """0: the benchmark's inputs; else the seeded ones (negative and
    large idx, random tables)."""
    return gm.inputs(dev) if which == 0 else gm.seeded_inputs(which, dev)


def k3b_inputs(which, dev):
    """As k3a_inputs; the seeded k0 also lies outside [0, K)."""
    return gm2.inputs(dev) if which == 0 else gm2.seeded_inputs(which, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode,S", [("empty", 32)] + list(gm.CASES))
def test_gather_micro_kernel_matches_plain_on_card(cuda_device, mode, S,
                                                   which):
    """Every tile of the kernel's output equals the plain tile, as int32,
    for 1, 3 and 256 tiles a launch."""
    tab, idx = k3a_inputs(which, cuda_device)
    plain = gm.gather_micro_torch(mode, S, tab, idx)
    for blocks in (1, 3, gm.BLOCKS):
        before = gm.gather_micro_cuda.launches
        out = gm.gather_micro_cuda(mode, S, tab, idx, blocks=blocks)
        torch.cuda.synchronize(cuda_device)
        assert gm.gather_micro_cuda.launches == before + 1
        assert out.shape == (blocks, 64, 128)
        assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode", gm2.MODES)
def test_gather_micro2_kernel_matches_plain_on_card(cuda_device, mode, which):
    k0, tab, idx = k3b_inputs(which, cuda_device)
    plain = gm2.gather_micro2_torch(mode, k0, tab, idx)
    for blocks in (1, 3, gm2.BLOCKS):
        before = gm2.gather_micro2_cuda.launches
        out = gm2.gather_micro2_cuda(mode, k0, tab, idx, blocks=blocks)
        torch.cuda.synchronize(cuda_device)
        assert gm2.gather_micro2_cuda.launches == before + 1
        assert out.shape == (blocks, 64, 128)
        assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,S,rows", [
    ("lane", 128, 4), ("lane", 128, 16), ("lane2", 128, 8),
    ("sublane", 8, 32), ("sublane", 32, 16), ("select", 16, 8),
    ("select", 24, 16)])
def test_gather_micro_kernel_at_other_bands_on_card(cuda_device, mode, S,
                                                    rows):
    """The band is the planner's choice, not the kernel's: any band a
    kernel can run gives the same tiles."""
    tab, idx = gm.seeded_inputs(3, cuda_device)
    out = gm.gather_micro_cuda(mode, S, tab, idx, blocks=5,
                               plan=gm.plan_band(mode, S, rows=rows))
    plain = gm.gather_micro_torch(mode, S, tab, idx)
    assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rows", [("dyn_take2", 4), ("chain_take2", 16),
                                       ("dyn_read", 32), ("static_take", 16)])
def test_gather_micro2_kernel_at_other_bands_on_card(cuda_device, mode, rows):
    k0, tab, idx = gm2.seeded_inputs(3, cuda_device)
    out = gm2.gather_micro2_cuda(mode, k0, tab, idx, blocks=5,
                                 plan=gm2.plan_ring(mode, rows=rows))
    plain = gm2.gather_micro2_torch(mode, k0, tab, idx)
    assert torch.equal(out, plain.expand_as(out))


@pytest.mark.cuda
def test_gather_library_limits_match_the_planners(cuda_device):
    """The planners' elements per thread, ring stages and shared-memory
    bytes are what the library was compiled with, and every planned
    kernel is resident at least once on an SM."""
    lim = gm.compiled_limits()
    assert lim["per"] == gm.PER
    assert lim["max_threads"] == {m: gm.MODE_MAX_THREADS.get(
        m, gm.MAX_THREADS) for m in gm.MODES}
    for (mode, S), smem in lim["smem"].items():
        plan = gm.plan_band(mode, S)
        assert smem == plan.smem
        assert gm.blocks_per_sm(mode, S, plan, cuda_device) >= 1
    lim2 = gm2.compiled_limits()
    assert (lim2["ring"], lim2["per"]) == (gm2.RING, gm2.PER)
    for mode, smem in lim2["smem"].items():
        plan = gm2.plan_ring(mode)
        assert smem == plan.smem
        assert gm2.blocks_per_sm(mode, plan, cuda_device) >= 1


@pytest.mark.cuda
def test_gather_launch_the_card_refuses_raises(cuda_device):
    """A plan the kernel does not need, and one whose shared memory the
    card does not have, raise; no other kernel runs in their place."""
    tab, idx = gm.inputs(cuda_device)
    k0, tab2, _ = gm2.inputs(cuda_device)
    before = (gm.gather_micro_cuda.launches, gm2.gather_micro2_cuda.launches)
    for plan in (gm.BandPlan(8, 256, 16), gm.BandPlan(32, 1024, 262144)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            gm.gather_micro_cuda("lane2", 128, tab, idx, plan=plan)
    for plan in (gm.BandPlan(8, 256, 0), gm.BandPlan(64, 2048, 1 << 20)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            gm2.gather_micro2_cuda("dyn_take2", k0, tab2, idx, plan=plan)
    assert (gm.gather_micro_cuda.launches,
            gm2.gather_micro2_cuda.launches) == before


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


@pytest.mark.cuda
def test_projector_on_card_matches_cpu(cuda_device):
    """The torch projector on the card (its default device) against the
    same function on the CPU, within the gates the projector is held to
    against the JAX one (relative RMSE 1e-3, max 0.05 of max): sin, cos
    and sqrt round differently on the two, which moves tangent-ray rims."""
    from paris_tpu_torch.phantom import cone_beam_project_torch
    det = OFFSET
    vol = derive_volume_geometry(det)
    scale = vol.dim_x * vol.l_vx_x / 2 * 0.9
    ang = np.arange(8, dtype=np.float64) * 47.5
    got = cone_beam_project_torch(det, ang, scale)
    assert got.device == cuda_device and got.dtype == torch.float32
    ref = cone_beam_project_torch(det, ang, scale, device="cpu").numpy()
    got = got.cpu().numpy()
    peak = np.abs(ref).max()
    assert np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)) < 1e-3 * peak
    assert np.abs(got - ref).max() < 0.05 * peak


@pytest.mark.cuda
def test_synthesizer_on_card_writes_the_projectors_frames(cuda_device,
                                                          tmp_path):
    """The synthesizer's card path (batch i+1 computed while batch i is
    copied on a copy stream into pinned memory and written): every file
    holds the projector's frames on the card, byte for byte."""
    from paris_tpu_torch.benchmarks import synth_c5_3600 as synth
    from paris_tpu_torch.io.his import read_his
    from paris_tpu_torch.phantom import cone_beam_project_torch
    det, n_proj = BASE, 36
    out = synth.synthesize(str(tmp_path), det, n_proj)
    assert out["frames_written"] == n_proj and out["card_ms_per_batch"] > 0
    angles = np.arange(n_proj, dtype=np.float64) * det.delta_phi
    scale = synth.phantom_scale(derive_volume_geometry(det))
    pdir = tmp_path / synth.PROJ_SUBDIR
    for i in range(0, n_proj, synth.BATCH):
        want = cone_beam_project_torch(det, angles[i:i + synth.BATCH],
                                       scale).cpu().numpy()
        got = read_his(synth.his_path(str(pdir), i))
        assert got.tobytes() == want.tobytes()
    assert (pdir / synth.DONE_MARKER).read_text() == str(n_proj)


@pytest.mark.cuda
def test_u16_synthesizer_on_card_rounds_the_projectors_frames(cuda_device,
                                                              tmp_path):
    """The uint16 synthesis rounds on the card: every file is HIS number
    type 4 and holds rint(frame / scale) of the projector's frames on the
    card, and the map file records that scale."""
    from paris_tpu_torch.benchmarks import synth_c5_3600 as synth
    from paris_tpu_torch.io.his import read_his, read_his_header
    from paris_tpu_torch.phantom import cone_beam_project_torch
    det, n_proj = BASE, 20
    out = synth.synthesize(str(tmp_path), det, n_proj, number_type="uint16")
    pdir = str(tmp_path / synth.PROJ_SUBDIR)
    q = synth.read_scan_map(pdir)["scale"]
    assert out["map"]["clipped"] == 0 and out["card_ms_per_batch"] > 0
    scale = synth.phantom_scale(derive_volume_geometry(det))
    assert q == synth.count_scale(scale)
    angles = np.arange(n_proj, dtype=np.float64) * det.delta_phi
    for i in range(0, n_proj, synth.BATCH):
        path = synth.his_path(pdir, i)
        assert read_his_header(path).number_type == 4
        frames = cone_beam_project_torch(det, angles[i:i + synth.BATCH],
                                         scale)
        want = torch.round(frames / q).cpu().numpy()
        np.testing.assert_array_equal(read_his(path), want)


@pytest.mark.cuda
@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_bench_on_card(cuda_device, tmp_path, capsys, accuracy):
    """The port's bench at a 256³ block on the card: the JAX bench's schema
    last, and K1 alone within its bound."""
    import json
    from paris_tpu_torch.benchmarks import bench
    res = bench.main(["--size", "256", "--accuracy", accuracy,
                      "--out", str(tmp_path / "b.json")])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == ("backprojection_gvoxel_updates_per_s_256cube_"
                              f"cuda_{accuracy}")
    assert last["value"] > 0 and last["vs_baseline"] > 0
    assert 0 < res["k1_bound_share"] <= 1
    assert res["k1_registers"] and res["k1_blocks_per_sm"] >= 1
    assert res["nvidia_smi"] and res["device"] == torch.cuda.get_device_name(
        cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [1, 4])
def test_run_configs_on_card(cuda_device, config):
    """BASELINE configs 1 and 4 through the kernel (the default backend),
    at the golden oracle's gate."""
    from paris_tpu_torch.benchmarks import run_configs as rc
    res = rc.CONFIGS[config]()
    assert res["pass"] and 0 < res["rel_rmse_vs_golden"] <= 1e-3
    assert res["device"] == torch.cuda.get_device_name(cuda_device)


# ------------------------------------------------------------- ingest

@pytest.mark.cuda
def test_ring_reuses_a_slot_only_after_its_copy(cuda_device):
    """Eight times the staging depth of distinct chunks, staged by
    stage_stream's two workers through a ring of four pinned slots per
    shape: every staged chunk on the card holds its own frames (a slot
    refilled before its copy finished would show another chunk's), read
    on the default stream after waiting on that chunk's event alone; the
    ring never holds more than its slots."""
    from paris_tpu_torch import pipeline
    det = DetectorGeometry(512, 512, 1.0, 1.0, 0.0, 0.0, 4096.0, 2048.0,
                           1.0)
    rec = pipeline.Reconstructor(det, derive_volume_geometry(det),
                                 chunk_size=8, backend="cuda")
    depth = 4
    n = 8 * depth
    pairs = ((np.full((8, 512, 512), k, np.uint16),
              np.full(8, k, np.float32)) for k in range(n))
    sums = []
    for k, (staged, _) in enumerate(pipeline.stage_stream(
            rec.stage_chunk, pairs, depth=depth, workers=2)):
        rec._ready(staged)
        frames = pipeline._as_float32(staged.chunk)
        sums.append((frames.min(), frames.max(),
                     staged.sin[0] == np.sin(np.deg2rad(np.float32(k)))))
    for k, (lo, hi, sin_ok) in enumerate(sums):
        assert lo.item() == hi.item() == k and bool(sin_ok), k
    rings = rec._ring._rings
    assert len(rings) == 1
    assert all(len(ring) == pipeline._RING_SLOTS for ring, _ in
               rings.values())


def _ties(n, h, w):
    f = np.zeros((n, h, w), np.float32)
    f[0] = 65535.0
    f[0, 0, :7] = [0.0, 0.5, 1.5, 2.5, 65533.5, 65534.5, 65535.0]
    for i, width in ((1, 1.9341504e-34), (2, 1e-38)):
        f[i] = np.linspace(0, np.float32(width), h * w,
                           dtype=np.float32).reshape(h, w)
        f[i].flat[-1] = np.float32(width)
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 4], ids=["full", "padded_tail"])
@pytest.mark.parametrize("case", ["u16", "f32", "constant_and_zero",
                                  "ties_and_top"])
def test_card_quantization_equals_the_native_quantizer(cuda_device, case, n):
    """The fast mode's u16 quantization on the card equals the native
    quantizer bit for bit, codes and qparams, and the round trip equals
    dequantize_chunk of its codes."""
    from paris_tpu_torch.io import native
    from paris_tpu_torch.pipeline import (dequantize_chunk,
                                          quantize_u16_torch, u16_round_trip)
    rng = np.random.default_rng(31)
    shape = (6, 256, 256)
    if case == "u16":
        f = rng.integers(0, 65536, shape).astype(np.float32)
    elif case == "f32":
        f = rng.uniform(-300, 9000, shape).astype(np.float32)
    elif case == "constant_and_zero":
        f = rng.uniform(0, 1, shape).astype(np.float32)
        f[1], f[2], f[4] = 7.25, 0.0, -3.5
    else:
        f = _ties(*shape)
    f[n:] = 0
    q = np.zeros(shape, np.uint16)
    qp = np.zeros((6, 2), np.float32)
    native.quantize_u16(np.ascontiguousarray(f[:n]), q, qp, n_threads=1)
    x = torch.from_numpy(f).to(cuda_device)
    tq, tqp = quantize_u16_torch(x, n)
    np.testing.assert_array_equal(tq.cpu().numpy().astype(np.uint16), q)
    np.testing.assert_array_equal(tqp.cpu().numpy().view(np.uint32),
                                  qp.view(np.uint32))
    before = u16_round_trip.launches
    got = u16_round_trip(x, tqp)
    assert u16_round_trip.launches == before + 1
    want = dequantize_chunk(torch.from_numpy(q.astype(np.float32)),
                            torch.from_numpy(qp))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_card_cache_job_equals_the_uncached_job(cuda_device, tmp_path,
                                                monkeypatch, accuracy):
    """A three-block job on the card from u16 HIS files with its cache on
    the card (later blocks from the staged chunks, no reads), and with it
    on the host (a margin no card has: later blocks staged again through
    the ring), writes the bytes the job without a cache writes."""
    import logging
    from paris_tpu_torch import app
    from paris_tpu_torch.app import ReconstructionJob, run_job
    from paris_tpu_torch.io import his
    from paris_tpu_torch.io.his import write_his
    det = BASE
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 60000, (40, det.n_col, det.n_row)).astype(
        np.uint16)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, 40, 8):
        write_his(str(pdir / f"b{i:03d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)
    outs, decoded, logs = {}, {}, {}
    for label, cache in (("card", None), ("host", True), ("off", False)):
        monkeypatch.setattr(app, "CARD_CACHE_MARGIN",
                            1 << 50 if label == "host" else 2 << 30)
        messages = []

        class Tap(logging.Handler):
            def emit(self, record):
                messages.append(record.getMessage())
        tap = Tap(logging.INFO)
        log = logging.getLogger("paris_tpu_torch.app")
        level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(tap)
        try:
            before = his.DECODE_STATS["frames"]
            path = run_job(ReconstructionJob(
                det=det, input_path=str(pdir), output_path=str(tmp_path),
                prefix=label, chunk_size=16, backend="cuda",
                accuracy=accuracy, block_dz=24, cache_projections=cache))
            decoded[label] = his.DECODE_STATS["frames"] - before
        finally:
            log.removeHandler(tap)
            log.setLevel(level)
        logs[label] = "\n".join(messages)
        with open(path, "rb") as f:
            outs[label] = f.read()
    assert outs["card"] == outs["host"] == outs["off"]
    assert "projection cache: on the card" in logs["card"]
    assert "ingest from the card cache" in logs["card"]
    assert "projection cache: on the host" in logs["host"]
    assert "ingest from the host cache" in logs["host"]
    n_blocks = logs["off"].count("ingest from the HIS files")
    assert n_blocks >= 2 and decoded == {"card": 40, "host": 40,
                                         "off": n_blocks * 40}


# -------------------------------------------------------------- drain

def _drain_block(device, shape, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _drained(tmp_path, name, drain, volume, dim_z, z0=0, file_z=None):
    """``volume``'s first ``dim_z`` slices drained into a new ddbvf at
    ``z0`` after an event on the compute stream, as the job drains."""
    from paris_tpu_torch.io import ddbvf
    _, ny, nx = volume.shape
    path = ddbvf.create(str(tmp_path / f"{name}.ddbvf"), nx, ny,
                        file_z or z0 + dim_z)
    ready = torch.cuda.Event()
    ready.record()
    assert drain.drain(volume, path, z0, dim_z, ready=ready) == dim_z
    return path


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.cuda
@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_drain_from_the_card_equals_the_cpu_composition(cuda_device, tmp_path,
                                                        monkeypatch, accuracy):
    """An accumulator reconstructed on the card in each mode, drained in
    slabs of 6 slices (37 valid of 40: neither divides by 6) through the
    pinned ring: byte for byte ``volume.cpu()`` + ``write_slices``."""
    from paris_tpu_torch import pipeline
    from paris_tpu_torch.io import ddbvf, drain as drain_mod
    det = BASE
    vol = derive_volume_geometry(det)
    rec = pipeline.Reconstructor(det, vol, chunk_size=8, backend="cuda",
                                 accuracy=accuracy,
                                 block_shape=(40, vol.dim_y, vol.dim_x))
    rng = np.random.default_rng(11)
    projs = rng.standard_normal((16, det.n_col, det.n_row)).astype(np.float32)
    angles = np.arange(16, dtype=np.float32) * 22.5
    volume = rec.accumulate(rec.init_block(), projs, angles, z_offset=8)
    slice_bytes = 4 * vol.dim_y * vol.dim_x
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", 6 * slice_bytes)
    drain = drain_mod.BlockDrain(cuda_device, (vol.dim_y, vol.dim_x), 40)
    assert drain.slices == 6
    got = _drained(tmp_path, "slabs", drain, volume, 37, z0=8,
                   file_z=vol.dim_z)
    ref = ddbvf.create(str(tmp_path / "ref.ddbvf"), vol.dim_x, vol.dim_y,
                       vol.dim_z)
    ddbvf.write_slices(ref, volume.cpu().numpy()[:37], 8)
    assert _bytes(got) == _bytes(ref)
    assert drain.pinned_bytes >= 3 * 6 * slice_bytes


@pytest.mark.cuda
def test_drain_keeps_the_accumulator_until_its_copies(cuda_device, tmp_path,
                                                      monkeypatch):
    """A 256 MiB block drained on a writer thread in 8 MiB slabs while the
    main thread drops its reference and at once allocates and fills the
    next blocks' accumulators on the compute stream: the file holds the
    first block's bytes, none of the next blocks' values."""
    import concurrent.futures
    from paris_tpu_torch.io import ddbvf, drain as drain_mod
    shape = (256, 512, 512)
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", 8 * 4 * 512 * 512)
    drain = drain_mod.BlockDrain(cuda_device, shape[1:], shape[0])
    volume = _drain_block(cuda_device, shape, 3)
    want = volume.cpu().numpy().tobytes()
    path = ddbvf.create(str(tmp_path / "v.ddbvf"), 512, 512, 256)
    ready = torch.cuda.Event()
    ready.record()
    with concurrent.futures.ThreadPoolExecutor(1) as writer:
        fut = writer.submit(drain.drain, volume, path, 0, 256, ready)
        volume = None
        nxt = [torch.full(shape, -7.0, device=cuda_device) for _ in range(3)]
        assert fut.result(timeout=300) == 256
    torch.cuda.synchronize()
    data = _bytes(path)[ddbvf.DATA_START:]
    assert data == want
    assert all(float(t[0, 0, 0]) == -7.0 for t in nxt)


@pytest.mark.cuda
def test_drain_hands_a_slot_out_only_after_its_pwrite(cuda_device, tmp_path,
                                                      monkeypatch):
    """Every slot the drain's ring hands out is poisoned on hand-out: the
    file never holds the poison (a pwrite that ran before its slab's copy
    finished, or a slot reused before its pwrite returned, would write
    it), over several blocks of one drain."""
    from paris_tpu_torch.io import ddbvf, drain as drain_mod
    shape = (96, 512, 512)
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", 5 * 4 * 512 * 512)
    drain = drain_mod.BlockDrain(cuda_device, shape[1:], shape[0])
    acquire = drain._ring.acquire
    handed = []

    def poisoned(*args):
        slot = acquire(*args)
        slot.frames.view(np.uint32)[:] = 0x7FC0DEAD
        handed.append(slot)
        return slot
    monkeypatch.setattr(drain._ring, "acquire", poisoned)
    poison = np.uint32(0x7FC0DEAD)
    for k, dim_z in enumerate((96, 91, 7)):
        volume = _drain_block(cuda_device, shape, 10 + k)
        path = _drained(tmp_path, f"b{k}", drain, volume, dim_z)
        data = np.frombuffer(_bytes(path)[ddbvf.DATA_START:], np.uint32)
        assert not (data == poison).any()
        assert data.tobytes() == volume[:dim_z].cpu().numpy().tobytes()
    assert len(handed) == sum(-(-n // 5) for n in (96, 91, 7))
    assert len({id(s) for s in handed}) == drain_mod.DRAIN_SLOTS


@pytest.mark.cuda
def test_drain_without_ready_waits_for_the_current_stream(cuda_device,
                                                           tmp_path):
    """A drain given no ``ready`` event, submitted right after the compute
    stream queues a long spin and then the kernel that writes the
    accumulator: the file holds the written values, not the ones before
    (the drain's copy stream waits for the caller's current stream)."""
    from paris_tpu_torch.io import ddbvf
    from paris_tpu_torch.io.drain import BlockDrain
    shape = (64, 512, 512)
    drain = BlockDrain(cuda_device, shape[1:], shape[0])
    volume = _drain_block(cuda_device, shape, 21)
    torch.cuda.synchronize()
    path = ddbvf.create(str(tmp_path / "v.ddbvf"), 512, 512, 64)
    torch.cuda._sleep(1 << 28)          # ~0.1 s of spin ahead of the write
    volume.mul_(-3.0).add_(1.0)
    assert drain.drain(volume, path, 0, 64) == 64
    want = volume.cpu().numpy().tobytes()
    assert _bytes(path)[ddbvf.DATA_START:] == want


@pytest.mark.cuda
def test_drain_pinned_bytes_stay_bounded_by_the_ring(cuda_device, tmp_path,
                                                     monkeypatch):
    """One drain over blocks of 24 MiB, 1 GiB and 24 MiB again (slabs of
    16 MiB): its pinned bytes never pass its slots', and the 1 GiB block
    leaves them at the ring's size, which the next block keeps."""
    from paris_tpu_torch.io import drain as drain_mod
    from paris_tpu_torch.io.drain import DRAIN_SLOTS, BlockDrain
    slab = 16 << 20
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", slab)
    drain = BlockDrain(cuda_device, (512, 512), 1024)
    assert drain.pinned_bytes == 0
    sizes = []
    for dz in (24, 1024, 24):
        volume = _drain_block(cuda_device, (dz, 512, 512), dz)
        _drained(tmp_path, f"z{dz}_{len(sizes)}", drain, volume, dz)
        sizes.append(drain.pinned_bytes)
        del volume
    ring = DRAIN_SLOTS * slab
    assert 0 < sizes[0] <= sizes[1] == sizes[2]
    assert ring <= sizes[1] <= ring + DRAIN_SLOTS * 4096


# ------------------------------------------------------------ the plan

@pytest.mark.cuda
def test_config5_auto_plan_splits_on_this_card(cuda_device):
    """Config 5 from 3600 uint16 frames (chunk 8), planned with this card's
    free memory: where the card holds two accumulators beside the 30.2 GB
    stream, the rule splits the volume, with the write overlap and the
    stream kept on the card."""
    import types
    from paris_tpu_torch.app import (CARD_CACHE_MARGIN, ReconstructionJob,
                                     _free_hbm_bytes, plan_job)
    from paris_tpu_torch.benchmarks.synth_c5_3600 import config5
    from paris_tpu_torch.geometry import derive_volume_geometry
    det = config5(3600)
    stream = 3600 * 2 * det.n_row * det.n_col
    if _free_hbm_bytes(cuda_device) * 0.95 < (stream + CARD_CACHE_MARGIN
                                              + 2 * 128 * 4 * 2048 ** 2):
        pytest.skip("the card holds no split beside the stream")
    table = types.SimpleNamespace(chunk_reads=lambda chunk, n=None: [
        types.SimpleNamespace(dtype=np.dtype(np.uint16), rows=chunk)
        for _ in range(3600 // chunk)])
    job = ReconstructionJob(det=det, input_path="-", output_path="-",
                            chunk_size=8, backend="cuda")
    plan = plan_job(job, derive_volume_geometry(det), cuda_device, table)
    assert plan.info.num > 1 and plan.overlap and plan.cache == "card"
    assert plan.cache_bytes == stream


# ------------------------------------------------------------ the tracer

@pytest.mark.cuda
@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_device_timed_spans_hold_to_the_kernels_of_the_trace(
        cuda_device, tmp_path, accuracy):
    """Steps at config 3's 64-slice slab, from a u16 chunk, profiled by
    ``trace()`` with the card held busy first (so the host runs ahead
    and no step waits on it): every device-timed span reads above zero,
    and "step.k1"'s device seconds fall within 2 % of the summed time of
    the kernels named ``bp_kernel`` in the same Chrome trace."""
    import json
    import os
    from paris_tpu_torch.benchmarks.k1_compare import config3
    from paris_tpu_torch.pipeline import Reconstructor
    from paris_tpu_torch.utils import profiling
    det, vol = config3()
    steps, C = 12, 16
    rec = Reconstructor(det, vol, chunk_size=C, backend="cuda",
                        accuracy=accuracy, device=cuda_device,
                        block_shape=(64, vol.dim_y, vol.dim_x))
    frames = np.random.default_rng(5).integers(
        0, 60000, size=(C, det.n_col, det.n_row), dtype=np.uint16)
    ang = np.arange(C, dtype=np.float32) * det.delta_phi
    volume = rec.init_block()
    rec.step_staged(volume, rec.stage_chunk(frames, ang), z_offset=480)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path), cuda_device):
        staged = rec.stage_chunk(frames, ang)
        torch.cuda._sleep(50_000_000)
        for _ in range(steps):
            rec.step_staged(volume, staged, z_offset=480)
        torch.cuda.synchronize()
    spans = profiling.collected()["spans"]
    for name in ("h2d", "step.prep", "step.filter", "step.k1"):
        assert spans[name]["device_s"] > 0, name
    assert spans["step"]["device_s"] is None
    assert spans["step.k1"]["count"] == steps
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    k1_s = sum(e["dur"] for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"
               and "bp_kernel" in e.get("name", "")) / 1e6
    assert spans["step.k1"]["device_s"] == pytest.approx(k1_s, rel=0.02)
