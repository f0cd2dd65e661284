"""The host tile planner of the K1 kernel (``plan_tile`` in
paris_tpu_torch/ops/backprojection_cuda.py), on the CPU.

The kernel copies, per thread block and angle, the detector rectangle its
voxels read into a shared-memory tile of the planned size, and clamps
every copy and tap into it: a tile that is too small would corrupt the
volume silently.  So for every kernel case of tests/test_pallas_kernel.py,
both config-3 blocks (banded, as the job feeds them) and a 2048-class
config-5 block, the taps that the plain version reads (its own h and v
arithmetic) for every voxel of sampled blocks and angles must lie in the
footprint the kernel computes from the block's corners, that footprint
must fit the planned tile, and the ring must fit a block's shared
memory.  Where no ring fits, the plan reads the taps from global memory."""

import numpy as np
import pytest
import torch

from paris_tpu_torch.geometry import (DetectorGeometry, VolumeGeometry,
                                      derive_volume_geometry,
                                      detector_row_band)
from paris_tpu_torch.ops import backprojection_cuda as bc
from paris_tpu_torch.ops.backprojection_torch import (kernel_constants,
                                                      make_bp_grid)

import test_torch_cuda as cuda_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h_v(k, xi, yi, z_idx, sin, cos):
    """float32 h (A, y, x), v (A, z, y, x), the in-front mask (A, y, x) and
    the per-angle voxel index grids, with the operations of
    backproject_chunk_torch (and of the kernel's rounded intrinsics)."""
    xs = (xi.to(torch.float32) * k["l_vx_x"] + k["off_x"])[None, None, :]
    ys = (yi.to(torch.float32) * k["l_vx_y"] + k["off_y"])[None, :, None]
    zs = (z_idx.to(torch.float32) * k["l_vx_z"]
          + k["off_z"])[None, :, None, None]
    sn, cs = sin[:, None, None], cos[:, None, None]
    s = xs * cs + ys * sn
    t = -xs * sn + ys * cs
    denom = s + k["d_so"]
    factor = torch.reciprocal(denom) * k["d_sd"]
    h = (t * factor - k["h_min"]) * k["inv_lpr"] - 0.5
    v = zs * (factor * k["inv_lpc"])[:, None] + k["vb"]
    return h, v, denom > k["safe_min"]


def footprints(grid, z_first, roi_xy, dz, ny, nx, v_lo, vp, shape, blocks,
               angles_deg, align):
    """Per sampled (block, angle): the taps the plain version reads, as
    (first column, last column, first band row, last band row), or None
    where no voxel reads the angle; and the kernel's corner footprint
    (corner_footprint in csrc/backproject.cu: first column, first band
    row, width and height before the clamp into the tile).

    As in the kernel, a voxel on the detector in h reads its two rows at
    every slice of the block (rows clamped into the band), whatever its
    v."""
    k = kernel_constants(grid)
    n_row, n_col = grid.det.n_row, grid.det.n_col
    bx, by, zr = shape
    out = []
    phi = np.deg2rad(np.asarray(angles_deg, np.float32)).astype(np.float32)
    sin, cos = torch.from_numpy(np.sin(phi)), torch.from_numpy(np.cos(phi))
    for ix, iy, iz in blocks:
        xi = torch.arange(ix * bx, min((ix + 1) * bx, nx)) + roi_xy[0]
        yi = torch.arange(iy * by, min((iy + 1) * by, ny)) + roi_xy[1]
        zi = torch.arange(iz * zr, min((iz + 1) * zr, dz)) + z_first
        h, v, front = _h_v(k, xi, yi, zi, sin, cos)
        h0 = torch.floor(h)
        ok = front & (h0 >= 0) & (h0 <= n_row - 2)
        row = (torch.floor(v) - v_lo).clamp(0, vp - 2)
        corner = (xi[[0, -1]], yi[[0, -1]], zi[[0, -1]])
        ch, cv, cfront = _h_v(k, *corner, sin, cos)
        for a in range(len(phi)):
            taps = None
            if bool(ok[a].any()):
                cols, rows = h0[a][ok[a]], row[a][:, ok[a]]
                taps = (int(cols.min()), int(cols.max()) + 1,
                        int(rows.min()), int(rows.max()) + 1)
            c_lo, c_hi, r_lo, r_hi = 0, n_row - 2, 0, vp - 2
            if bool(cfront[a].all()):
                hl = float(torch.floor(ch[a].min())) - 1
                hh = float(torch.floor(ch[a].max())) + 1
                if hh < 0 or hl > n_row - 2:
                    out.append((taps, None))
                    continue
                c_lo, c_hi = max(int(hl), 0), min(int(hh), n_row - 2)
                vl = max(float(torch.floor(cv[a].min())) - 1, -1)
                vh = min(float(torch.floor(cv[a].max())) + 1, n_col)
                r_lo = min(max(int(vl) - v_lo, 0), vp - 2)
                r_hi = min(max(int(vh) - v_lo, 0), vp - 2)
            col0 = c_lo - c_lo % align
            width = -(-(c_hi + 2 - col0) // align) * align
            out.append((taps, (col0, r_lo, width, r_hi + 2 - r_lo)))
    return out


def _blocks(dz, ny, nx, shape, rng, n_random=6):
    """The corner, edge and centre blocks of the launch, and a few drawn
    at random."""
    bx, by, zr = shape
    gx, gy, gz = -(-nx // bx), -(-ny // by), -(-dz // zr)
    picks = {(x, y, z) for x in (0, gx // 2, gx - 1)
             for y in (0, gy // 2, gy - 1) for z in (0, gz - 1)}
    for _ in range(n_random):
        picks.add((int(rng.integers(gx)), int(rng.integers(gy)),
                   int(rng.integers(gz))))
    return sorted(picks)


def check_plan(det, vol, dz, z_first, roi_xy, v_lo, vp, C, angles_deg,
               seed=0):
    grid = make_bp_grid(det, vol)
    ny, nx = vol.dim_y, vol.dim_x
    rng = np.random.default_rng(seed)
    plans = {}
    for elem_bytes, async_copy in ((4, True), (2, True), (4, False)):
        plan = bc.plan_tile(grid, dz, ny, nx, z_first, roi_xy, vp, C,
                            elem_bytes, async_copy)
        assert plan.copy == (bc.COPY_ASYNC if async_copy
                             else bc.COPY_ELEMENT)
        assert plan.smem <= bc.SMEM_LIMIT == 232448
        assert plan.smem >= bc.RING * plan.tile_h * plan.pitch * elem_bytes
        align = 16 // elem_bytes if async_copy else 1
        assert plan.pitch % align == 0
        shape = bc.SHAPES[plan.shape]
        fps = footprints(grid, z_first, roi_xy, dz, ny, nx, v_lo, vp, shape,
                         _blocks(dz, ny, nx, shape, rng), angles_deg, align)
        assert any(taps for taps, _ in fps), "no sampled block reads"
        for taps, fp in fps:
            if taps is None:
                continue
            c_lo, c_hi, r_lo, r_hi = taps
            col0, row0, width, height = fp
            # the footprint holds every tap, and the tile the footprint
            assert col0 <= c_lo and c_hi < col0 + width
            assert row0 <= r_lo and r_hi < row0 + height
            assert width <= plan.pitch and height <= plan.tile_h
            assert col0 + width <= -(-det.n_row // align) * align
            assert row0 + height <= vp
        plans[elem_bytes, async_copy] = plan
    return plans


ANGLES = np.arange(0.0, 360.0, 7.5)


@pytest.mark.parametrize("name", cuda_cases.CASES)
def test_kernel_cases_tile_holds_every_tap(name):
    det, vol, projs, ang, vol0, z_off, roi, _ = cuda_cases.bp_case(name)
    dz = vol0.shape[0]
    z_first = roi[2] + z_off
    angles = np.concatenate([ang, ANGLES])
    check_plan(det, vol, dz, z_first, roi[:2], 0, det.n_col, len(ang),
               angles)
    # banded, as the job feeds the kernel
    lo, hi = detector_row_band(det, vol, z_first, dz)
    check_plan(det, vol, dz, z_first, roi[:2], lo, hi - lo, len(ang), angles)


CONFIG3 = DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                           360.0 / 64)
CONFIG5 = DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                           0.1)


@pytest.mark.parametrize("z0", [0, 512])
def test_config3_blocks_tile_holds_every_tap(z0):
    vol = derive_volume_geometry(CONFIG3)
    lo, hi = detector_row_band(CONFIG3, vol, z0, 512)
    plans = check_plan(CONFIG3, vol, 512, z0, (0, 0), lo, hi - lo, 16,
                       ANGLES + 1.3, seed=z0)
    for plan in plans.values():       # the largest block shape fits
        assert plan.shape == 0
        assert plan.tile_h <= 23 and plan.pitch <= 48


@pytest.mark.parametrize("z0", [0, 1024 - 172])
def test_config5_block_tile_holds_every_tap(z0):
    """A 344-slice block of the 2048-class config-5 volume (BASELINE.md:
    292), at the top and at the centre."""
    vol = derive_volume_geometry(CONFIG5)
    lo, hi = detector_row_band(CONFIG5, vol, z0, 344)
    plans = check_plan(CONFIG5, vol, 344, z0, (0, 0), lo, hi - lo, 16,
                       ANGLES + 0.05, seed=z0)
    assert {plan.shape for plan in plans.values()} == {0}


def test_coarse_voxels_take_the_smaller_block_shape():
    """Voxels 6 pixels wide: in float32 the 32 x 8 x 16 block's tiles
    overflow shared memory and the 32 x 4 x 8 block's fit; in bf16 the
    larger block fits.  Either tile holds every tap."""
    det, vol = cuda_cases.PATHS["coarse_voxels"]
    plans = check_plan(det, vol, 48, 0, (0, 0), 0, det.n_col, 16, ANGLES)
    assert plans[4, True].shape == 1 and plans[2, True].shape == 0


NEAR_SOURCE = VolumeGeometry(dim_x=40, dim_y=40, dim_z=8,
                             l_vx_x=4.0, l_vx_y=4.0, l_vx_z=4.0)


def test_source_inside_the_volume_takes_the_whole_band():
    """A volume reaching the source: the tile is the whole band, which
    fits for a small detector; for a large one no ring fits and the plan
    reads the taps from global memory."""
    det = DetectorGeometry(64, 48, 2.0, 2.0, 0.0, 0.0, 60.0, 60.0, 2.0)
    plans = check_plan(det, NEAR_SOURCE, 8, 0, (0, 0), 0, det.n_col, 4,
                       ANGLES)
    assert (plans[4, True].pitch, plans[4, True].tile_h) == (64, 48)
    big = DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 60.0, 60.0, 2.0)
    plan = bc.plan_tile(make_bp_grid(big, NEAR_SOURCE), 8, 40, 40, 0, (0, 0),
                        1024, 16, 4, True)
    assert plan == bc.TilePlan(0, bc.COPY_GLOBAL, 1024, 1024, 0)


# Geometries whose tiles no block shape's ring fits: a volume reaching the
# source of a large detector, and voxels 12 pixels wide (a binned preview
# of a fine detector)
NO_RING = {
    "near_source": (DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 60.0,
                                     60.0, 2.0), NEAR_SOURCE),
    "coarse_preview": (DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0,
                                        2048.0, 1024.0, 1.0),
                       VolumeGeometry(dim_x=96, dim_y=96, dim_z=48,
                                      l_vx_x=2.0, l_vx_y=2.0, l_vx_z=2.0)),
}


@pytest.mark.parametrize("async_copy", [True, False])
@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("case", sorted(NO_RING))
def test_no_ring_fits_plans_global_taps(case, elem_bytes, async_copy):
    """No ring fits: the plan is the global-memory instantiation on the
    largest block shape, its "tile" the whole band, with no shared
    memory, whatever the projections' type and alignment."""
    det, vol = NO_RING[case]
    grid = make_bp_grid(det, vol)
    plan = bc.plan_tile(grid, vol.dim_z, vol.dim_y, vol.dim_x, 0, (0, 0),
                        det.n_col, 16, elem_bytes, async_copy)
    assert plan == bc.TilePlan(0, bc.COPY_GLOBAL, det.n_row, det.n_col, 0)
    # every ring was too large for the shared memory
    for _, by, zr in bc.SHAPES:
        width, height = bc._tile_bound(grid, vol.dim_z, vol.dim_y, vol.dim_x,
                                       0, (0, 0), det.n_col, by, zr)
        assert bc.RING * width * height * elem_bytes > bc.SMEM_LIMIT


def test_band_beyond_32_bit_offsets_raises():
    """No ring fits and the band is too large for the kernel's 32-bit
    tap offsets in global memory: the planner raises, naming the
    geometry."""
    det = DetectorGeometry(65536, 32768, 0.25, 0.25, 0.0, 0.0, 60.0, 60.0,
                           2.0)
    with pytest.raises(ValueError, match="DetectorGeometry.*32-bit"):
        bc.plan_tile(make_bp_grid(det, NEAR_SOURCE), 8, 40, 40, 0, (0, 0),
                     det.n_col, 16, 4, True)
