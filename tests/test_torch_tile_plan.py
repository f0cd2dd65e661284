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
        # tile rows a multiple of 128 B (32 banks) apart
        assert plan.pitch * elem_bytes % 128 == 0
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


@pytest.mark.parametrize("name", cuda_cases.CASES + cuda_cases.EDGE_CASES)
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
        assert plan.tile_h <= 23 and plan.pitch == 64
    # its footprints are at most 41 columns wide (44 and 48 aligned for
    # the float32 and bf16 copies), a pitch of 64 rounded up to 128 B
    width, _ = bc._tile_bound(make_bp_grid(CONFIG3, vol), 512, vol.dim_y,
                              vol.dim_x, z0, (0, 0), hi - lo, 8, 16)
    assert width <= 41


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


def interior_share(det, vol, dz, z_first, v_lo, vp, C, angles_deg, blocks,
                   elem_bytes=2):
    """The share of (thread, angle) pairs, over the threads of the sampled
    ``blocks`` (x, y, z block indices) whose column is on the detector in
    h at the angle, that take the kernel's interior z step: by the rule
    of ``z_steps`` in csrc/backproject.cu, the v of the thread's first and
    last slices (in a last z group of fewer than ZR slices, the block's
    last) lie in [v_in, v_out) of the block's corner footprint
    (``make_footprint``), whose rows are clamped into the planned tile.
    Returns (share, pairs on the detector)."""
    grid = make_bp_grid(det, vol)
    k = kernel_constants(grid)
    n_row, n_col = det.n_row, det.n_col
    plan = bc.plan_tile(grid, dz, vol.dim_y, vol.dim_x, z_first, (0, 0), vp,
                        C, elem_bytes, True)
    bx, by, zr = bc.SHAPES[plan.shape]
    b = torch.as_tensor(blocks)
    xs = b[:, 0, None] * bx + torch.arange(bx)            # (B, 32)
    ys = b[:, 1, None] * by + torch.arange(by)            # (B, by)
    zb = b[:, 2] * zr
    z_last = torch.minimum(zb + zr, torch.tensor(dz)) - 1
    nx, ny = vol.dim_x, vol.dim_y
    live = (xs < nx)[:, None, :] & (ys < ny)[:, :, None]  # (B, by, 32)

    def coord(i, step, off):
        return i.to(torch.float32) * k[step] + k[off]

    xm = coord(xs, "l_vx_x", "off_x")[:, None, :]
    ym = coord(ys, "l_vx_y", "off_y")[:, :, None]
    zm0 = coord(zb + z_first, "l_vx_z", "off_z")[:, None, None]
    zm1 = coord(z_last + z_first, "l_vx_z", "off_z")[:, None, None]
    cx = coord(torch.stack([xs[:, 0], torch.clamp(xs[:, -1], max=nx - 1)],
                           1), "l_vx_x", "off_x")[:, None, :]   # (B, 1, 2)
    cy = coord(torch.stack([ys[:, 0], torch.clamp(ys[:, -1], max=ny - 1)],
                           1), "l_vx_y", "off_y")[:, :, None]   # (B, 2, 1)
    cz = coord(torch.stack([zb, z_last], 1) + z_first, "l_vx_z",
               "off_z")[:, :, None, None]                       # (B, 2, 1, 1)
    on = inside = 0
    for deg in angles_deg:
        phi = np.float32(np.deg2rad(np.float32(deg)))
        sn, cs = np.float32(np.sin(phi)), np.float32(np.cos(phi))

        def project(x, y):
            s = x * cs + y * sn
            t = -x * sn + y * cs
            denom = s + k["d_so"]
            factor = torch.reciprocal(denom) * k["d_sd"]
            h = (t * factor - k["h_min"]) * k["inv_lpr"] - 0.5
            return denom > k["safe_min"], h, factor * k["inv_lpc"]

        front, h, fscale = project(xm, ym)
        ok = live & front & (h >= 0) & (h < n_row - 1)
        va, vz = zm0 * fscale + k["vb"], zm1 * fscale + k["vb"]
        cfront, ch, cfs = project(cx, cy)                   # (B, 2, 2)
        cv = cz * cfs[:, None] + k["vb"]                     # (B, 2, 2, 2)
        allf = cfront.flatten(1).all(1)
        hl = torch.floor(ch.flatten(1).min(1).values) - 1
        hh = torch.floor(ch.flatten(1).max(1).values) + 1
        vl = torch.clamp(torch.floor(cv.flatten(1).min(1).values) - 1, min=-1)
        vh = torch.clamp(torch.floor(cv.flatten(1).max(1).values) + 1,
                         max=n_col)
        r_lo = torch.clamp(vl.to(torch.int64) - v_lo, 0, vp - 2)
        r_hi = torch.clamp(vh.to(torch.int64) - v_lo, 0, vp - 2)
        r_lo = torch.where(allf, r_lo, 0)
        r_hi = torch.where(allf, r_hi, vp - 2)
        height = torch.clamp(r_hi + 2 - r_lo, max=plan.tile_h)
        miss = allf & ((hh < 0) | (hl > n_row - 2))
        r_lo, height = torch.where(miss, 0, r_lo), torch.where(miss, 0, height)
        base = v_lo + r_lo
        v_in = torch.clamp(base, min=0).to(torch.float32)[:, None, None]
        v_out = (torch.clamp(base + height - 2, max=n_col - 2) + 1).to(
            torch.float32)[:, None, None]
        hit = ok & (torch.minimum(va, vz) >= v_in) \
            & (torch.maximum(va, vz) < v_out)
        on += int(ok.sum())
        inside += int(hit.sum())
    return inside / on, on


@pytest.mark.parametrize("z0,least", [(0, 0.9), (888, 0.99)])
def test_config5_blocks_mostly_take_the_interior_z_step(z0, least):
    """Config 5's 296-slice blocks as the c5-block cells run them (on the
    band of the widest rows over the plan's blocks): over 1024 sampled
    thread blocks and 32 angles about the circle, nearly every (thread,
    angle) pair on the detector takes the interior z step, the one that
    the kernel's conversion-free floor serves: at block 0 all but the
    pairs whose slices leave the detector at the volume's top, in a block
    at the middle all (the last z group of 8 slices too)."""
    vol = derive_volume_geometry(CONFIG5)
    vp = max(hi - lo for lo, hi in (detector_row_band(CONFIG5, vol, z, 296)
                                    for z in range(0, vol.dim_z, 296)))
    v_lo = max(0, min(detector_row_band(CONFIG5, vol, z0, 296)[0],
                      CONFIG5.n_col - vp))
    rng = np.random.default_rng(5)
    bx, by, zr = bc.SHAPES[0]
    blocks = np.stack([rng.integers(0, -(-vol.dim_x // bx), 1024),
                       rng.integers(0, -(-vol.dim_y // by), 1024),
                       rng.integers(0, -(-296 // zr), 1024)], 1)
    share, on = interior_share(CONFIG5, vol, 296, z0, v_lo, vp, 16,
                               np.arange(32) * 11.25 + 0.05, blocks)
    print(f"block at z0 {z0}: interior z step {share:.4%} of {on} "
          "(thread, angle) pairs")
    assert on > 1_000_000
    assert least < share <= 1.0


def test_edge_cases_put_v_on_row_boundaries():
    """The edge cases of tests/test_torch_cuda.py: at angle 0 the middle
    x column's v is integral at every slice, inside the detector in the
    ``row_boundaries`` block, and through exactly 0 and n_col - 2 in the
    ``border_limits`` volume."""
    for name in cuda_cases.EDGE_CASES:
        det, vol, _, ang, vol0, z_off, roi, _ = cuda_cases.bp_case(name)
        assert ang[0] == 0.0
        k = kernel_constants(make_bp_grid(det, vol))
        dz, ny, nx = vol0.shape
        zi = torch.arange(dz) + z_off + roi[2]
        _, v, _ = _h_v(k, torch.tensor([nx // 2]), torch.arange(ny), zi,
                       torch.zeros(1), torch.ones(1))
        v = v[0, :, :, 0]                                 # (z, y)
        assert torch.equal(v, torch.floor(v))
        assert torch.equal(v[:, 0], (zi - 8).to(torch.float32))
        if name == "row_boundaries":
            assert 0 <= float(v.min()) and float(v.max()) <= det.n_col - 2
        else:
            assert {0.0, det.n_col - 2.0, -1.0, det.n_col - 1.0} <= set(
                v[:, 0].tolist())


def test_counters_carry_the_launches_per_copy_mode(monkeypatch):
    """``counters()`` reports K1's launches per copy mode (the
    instantiation a run took) beside their total, and they sum to it."""
    from paris_tpu_torch.utils import profiling
    fn = bc.backproject_chunk_cuda
    names = [f"backproject_chunk_cuda.launches.{m}" for m in bc.COPY_NAMES]
    assert names == ["backproject_chunk_cuda.launches.element",
                     "backproject_chunk_cuda.launches.async",
                     "backproject_chunk_cuda.launches.global"]
    out = profiling.counters()
    assert sum(out[n] for n in names) == out["backproject_chunk_cuda.launches"]
    monkeypatch.setattr(fn, "launches", fn.launches + 9)
    monkeypatch.setattr(fn, "launches_by_copy", {
        m: n + {"async": 6, "element": 2, "global": 1}[m]
        for m, n in fn.launches_by_copy.items()})
    after = profiling.counters()
    assert [after[n] - out[n] for n in names] == [2, 6, 1]
    assert sum(after[n] for n in names) == \
        after["backproject_chunk_cuda.launches"]


# k1_compare's cases beside config 5, and the plans their footprints take
K1_CASE_PLANS = {
    "rabbit-block": {4: (0, bc.COPY_ASYNC), 2: (0, bc.COPY_ASYNC)},
    "coarse-voxels": {4: (1, bc.COPY_ASYNC), 2: (0, bc.COPY_ASYNC)},
    "wide-footprint": {4: (0, bc.COPY_GLOBAL), 2: (1, bc.COPY_ASYNC)},
}


@pytest.mark.parametrize("name", sorted(K1_CASE_PLANS))
def test_k1_compare_cases_take_the_paths_they_name(name):
    """RabbitCT's whole volume takes the larger block shape; voxels 6
    pixels wide the smaller one in float32 and the larger in bf16 (its
    tiles are half the bytes); voxels 8.4 pixels wide global taps in
    float32 and, in bf16, the smaller shape with a footprint over 256
    columns."""
    from paris_tpu_torch.benchmarks.k1_compare import case
    det, vol, shape, z0, v_lo, vp, C = case(name)
    grid = make_bp_grid(det, vol)
    for elem_bytes, want in K1_CASE_PLANS[name].items():
        plan = bc.plan_tile(grid, *shape, z0, (0, 0), vp, C, elem_bytes,
                            True)
        assert (plan.shape, plan.copy) == want
        if name == "wide-footprint" and elem_bytes == 2:
            assert plan.pitch > 256


def test_pitch_rounding_never_costs_a_ring_that_fits():
    """A tile pitch is the footprint's aligned width rounded up to 128 B,
    except where that ring would overflow the shared memory and the
    unrounded one fits: then the block shape keeps its ring at the
    aligned width."""
    det = DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                           1.0)
    vol = VolumeGeometry(dim_x=256, dim_y=256, dim_z=64, l_vx_x=0.8,
                         l_vx_y=0.8, l_vx_z=0.8)
    grid = make_bp_grid(det, vol)
    width, tile_h = bc._tile_bound(grid, 64, 256, 256, 0, (0, 0), 2048, 8,
                                   16)
    aligned = -(-(width + 3) // 4) * 4
    assert aligned * 4 % 128 != 0
    rounded = -(-aligned * 4 // 128) * 32
    # so many angles that their footprints leave room for the aligned ring
    # alone
    crowded = (bc.SMEM_LIMIT - bc.RING * tile_h * aligned * 4) // 128 * 4
    assert 32 * crowded + bc.RING * tile_h * rounded * 4 > bc.SMEM_LIMIT
    for C, pitch in ((16, rounded), (crowded, aligned)):
        plan = bc.plan_tile(grid, 64, 256, 256, 0, (0, 0), 2048, C, 4, True)
        head = -(-32 * C // 128) * 128
        assert (plan.shape, plan.pitch) == (0, pitch)
        assert plan.smem == head + bc.RING * tile_h * pitch * 4


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_19bp_kernelIfLi8ELi16ELi1EEEvPfPKT_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD.RM R2, R3, 12582912 ;
        /*0020*/                   IMAD R4, R2, 0x100, R5 ;
        /*0030*/                   LDS R6, [R4+UR4] ;
        /*0040*/                   LDS R7, [R4+UR4+0x4] ;
        /*0050*/              @!P0 LDS R8, [R4+UR4+0x100] ;
        /*0060*/                   LDS R9, [R4+UR4+0x104] ;
        /*0070*/                   FFMA R10, R6, R7, R8 ;
        /*0080*/               @P1 BRA 0x00c0 ;
        /*0090*/                   FRND.FLOOR R2, R3 ;
        /*00a0*/                   F2I.TRUNC.NTZ R4, R2 ;
        /*00b0*/                   LDS R6, [R4+UR4] ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   NOP ;
\t\tFunction : _Z5otheri
        /*0000*/                   LDS R6, [R4] ;
"""


def test_sass_counts_finds_the_straight_runs_with_loads():
    from paris_tpu_torch.benchmarks.k1_compare import sass_counts
    out = sass_counts(SASS)
    (name, info), = out.items()
    assert "bp_kernel" in name
    assert info["instructions"] == 13              # the NOP not counted
    assert info["lds"] == 5 and info["conversions"] == 2
    assert info["opcodes"]["LDS"] == 5 and info["opcodes"]["FRND"] == 1
    # (instructions, loads, conversions, first address), most loads first
    assert info["runs"] == [(8, 4, 0, "0000"), (3, 1, 2, "0090")]


def test_ptxas_registers_reads_the_instantiation_the_plan_launches():
    from paris_tpu_torch.benchmarks.k1_compare import ptxas_registers

    def entry(name, regs, spill):
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\nptxas info    : Function properties\n    0 "
                f"bytes stack frame, {spill} bytes spill stores, {spill} "
                f"bytes spill loads\nptxas info    : Used {regs} registers\n")
    log = (entry("_Z9bp_kernelIfLi8ELi16ELi0ELi0EEv", 60, 0)
           + entry("_Z9bp_kernelIfLi8ELi16ELi0ELi1EEv", 63, 8)
           + entry("_Z9bp_kernelIfLi8ELi16ELi64ELi1EEv", 64, 4)
           + entry("_Z9bp_kernelI13__nv_bfloat16Li8ELi16ELi1EEv", 62, 0))
    assert ptxas_registers(log, False, bc.TilePlan(0, 1, 64, 20, 0)) == (64, 4)
    assert ptxas_registers(log, False, bc.TilePlan(0, 1, 96, 20, 0)) == (63, 8)
    assert ptxas_registers(log, False, bc.TilePlan(0, 0, 64, 20, 0)) == (60, 0)
    # a build from before PR 20, whose template has no tile pitch
    assert ptxas_registers(log, True, bc.TilePlan(0, 1, 64, 20, 0)) == (62, 0)
    assert ptxas_registers(log, True, bc.TilePlan(1, 1, 64, 20, 0)) \
        == (None, 0)
