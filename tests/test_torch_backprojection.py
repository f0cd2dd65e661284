"""paris_tpu_torch backprojection vs the JAX package: the plain PyTorch
version against the XLA op and the Pallas kernel (interpret mode) at the
cases of tests/test_pallas_kernel.py, the accumulator layout bridge, and
the CUDA wrapper's dispatch on the CPU.  The cases live in
tests/test_torch_cuda.py, which holds the kernel against the plain
version on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paris_tpu import geometry as jax_geometry
from paris_tpu.ops import backprojection_pallas as bpp
from paris_tpu.ops.backprojection_xla import backproject_chunk_xla
from paris_tpu.ops.backprojection_xla import make_bp_grid as jax_grid
from paris_tpu_torch.geometry import DetectorGeometry, VolumeGeometry
from paris_tpu_torch.ops.backprojection_cuda import (backproject_chunk,
                                                     backproject_chunk_cuda)
from paris_tpu_torch.ops.backprojection_torch import (backproject_chunk_torch,
                                                      make_bp_grid)
from paris_tpu_torch.pipeline import from_jax_state, to_jax_state

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


CASES = cuda_cases.CASES
_case = cuda_cases.bp_case
_sincos = cuda_cases.sincos


def _port(det, vol, projs, ang, vol0, z_off, roi):
    sin, cos = _sincos(ang)
    out = backproject_chunk_torch(
        torch.from_numpy(vol0.copy()), torch.from_numpy(projs),
        torch.from_numpy(sin), torch.from_numpy(cos),
        make_bp_grid(det, vol), z_offset=z_off, roi_offset=roi)
    return out.numpy()


def _jax_geometry(det, vol):
    """The port's geometry objects as the JAX package's classes."""
    return (jax_geometry.DetectorGeometry(**dataclasses.asdict(det)),
            jax_geometry.VolumeGeometry(**dataclasses.asdict(vol)))


def _jax(ref, det, vol, projs, ang, vol0, z_off, roi, **kw):
    sin, cos = _sincos(ang)
    args = (jnp.asarray(vol0), jnp.asarray(projs), jnp.asarray(sin),
            jnp.asarray(cos), jax_grid(*_jax_geometry(det, vol)))
    if ref == "xla":
        out = backproject_chunk_xla(*args, z_offset=z_off, roi_offset=roi)
    else:
        out = bpp.backproject_chunk_pallas(*args, z_offset=z_off,
                                           roi_offset=roi, interpret=True,
                                           **kw)
    return np.asarray(out)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name, ref):
    det, vol, projs, ang, vol0, z_off, roi, atol = _case(name)
    ours = _port(det, vol, projs, ang, vol0, z_off, roi)
    want = _jax(ref, det, vol, projs, ang, vol0, z_off, roi)
    assert ours.shape == vol0.shape
    np.testing.assert_allclose(ours, want, rtol=1e-4, atol=atol)


def test_fast_mode_matches_pallas_fast_path():
    """bf16 projections through the plain version against the Pallas
    fast path (bf16 tables), at the tolerances of
    test_pallas_kernel.py:288-290."""
    det, vol, projs, ang, vol0, z_off, roi, _ = _case("zero")
    sin, cos = _sincos(ang)
    ours = backproject_chunk_torch(
        torch.zeros(vol0.shape), torch.from_numpy(projs).to(torch.bfloat16),
        torch.from_numpy(sin), torch.from_numpy(cos),
        make_bp_grid(det, vol)).numpy()
    fast = _jax("pallas", det, vol, projs, ang, vol0, z_off, roi,
                precision=jax.lax.Precision.DEFAULT)
    ref = _jax("xla", det, vol, projs, ang, vol0, z_off, roi)
    scale = np.abs(ref).max()
    assert np.abs(ours - fast).max() / scale < 2e-2
    assert np.sqrt(np.mean((ours - fast) ** 2)) / scale < 2e-3
    assert np.abs(ours - ref).max() / scale < 2e-2
    assert np.sqrt(np.mean((ours - ref) ** 2)) / scale < 2e-3


def test_z_slab_bound_matches_unslabbed():
    det, vol, projs, ang, vol0, z_off, roi, _ = _case("offset_detector")
    sin, cos = _sincos(ang)
    grid = make_bp_grid(det, vol)
    args = (torch.from_numpy(projs), torch.from_numpy(sin),
            torch.from_numpy(cos), grid)
    whole = backproject_chunk_torch(torch.zeros(vol0.shape), *args)
    slabbed = backproject_chunk_torch(
        torch.zeros(vol0.shape), *args,
        max_temp_bytes=7 * 4 * vol.dim_y * vol.dim_x)   # 7-slice slabs
    np.testing.assert_array_equal(slabbed.numpy(), whole.numpy())


def test_update_is_in_place():
    det, vol, projs, ang, vol0, z_off, roi, _ = _case("z_offset_roi")
    sin, cos = _sincos(ang)
    acc = torch.from_numpy(vol0.copy())
    out = backproject_chunk_torch(acc, torch.from_numpy(projs),
                                  torch.from_numpy(sin), torch.from_numpy(cos),
                                  make_bp_grid(det, vol), z_off, roi)
    assert out is acc and float(acc.abs().max()) > 0


def test_safe_clamp_zeroes_voxels_at_the_source():
    """Voxels with s + d_so <= 1e-3*|d_so| add 0 (the Pallas kernel's
    clamp, backprojection_pallas.py:397-401); every other voxel matches
    the XLA op, which has no clamp."""
    det = DetectorGeometry(64, 48, 2.0, 2.0, 0.0, 0.0, 60.0, 60.0, 2.0)
    vol = VolumeGeometry(dim_x=40, dim_y=40, dim_z=8,
                         l_vx_x=4.0, l_vx_y=4.0, l_vx_z=4.0)
    projs = np.random.default_rng(3).standard_normal(
        (1, det.n_col, det.n_row)).astype(np.float32)
    ang = np.asarray([0.0], np.float32)
    vol0 = np.zeros(vol.shape_zyx, np.float32)
    ours = _port(det, vol, projs, ang, vol0, 0, (0, 0, 0))
    ref = _jax("xla", det, vol, projs, ang, vol0, 0, (0, 0, 0))
    xs = (np.arange(vol.dim_x) - vol.dim_x / 2 + 0.5) * vol.l_vx_x
    unsafe = xs + det.d_so <= 1e-3 * det.d_so     # phi = 0: s = x
    assert unsafe.any() and not unsafe.all()
    assert np.isfinite(ours).all()
    np.testing.assert_array_equal(ours[:, :, unsafe], 0.0)
    np.testing.assert_allclose(ours[:, :, ~unsafe], ref[:, :, ~unsafe],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(37, 40, 50), (16, 96, 96)])
def test_jax_state_round_trip(shape):
    v = np.random.default_rng(31).standard_normal(shape).astype(np.float32)
    vk = np.asarray(bpp.to_kernel_layout(jnp.asarray(v)))
    np.testing.assert_array_equal(to_jax_state(torch.from_numpy(v)), vk)
    back = from_jax_state(vk, shape, "cpu")
    assert back.dtype == torch.float32 and back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), v)


def test_accumulate_from_jax_state():
    """Both implementations start from the same non-zero block: the JAX
    Pallas kernel in its (y, x, z) layout, the port from_jax_state."""
    det, vol, projs, ang, _, z_off, roi, _ = _case("z_offset_roi")
    sin, cos = _sincos(ang)
    shape = (16, vol.dim_y, vol.dim_x)
    start = np.random.default_rng(12).standard_normal(shape).astype(
        np.float32)
    vk = bpp.to_kernel_layout(jnp.asarray(start))
    offs = jnp.asarray([roi[0], roi[1], roi[2] + z_off, 0], jnp.int32)
    out_k = bpp.backproject_chunk_pallas_yxz(
        vk, bpp.pad_projections_t(jnp.asarray(projs)), jnp.asarray(sin),
        jnp.asarray(cos), jax_grid(*_jax_geometry(det, vol)), offs,
        interpret=True)
    acc = from_jax_state(np.asarray(vk), shape, "cpu")
    backproject_chunk_torch(acc, torch.from_numpy(projs),
                            torch.from_numpy(sin), torch.from_numpy(cos),
                            make_bp_grid(det, vol), z_off, roi)
    # the Pallas kernel also fills its padding, so compare the block itself
    want = from_jax_state(np.asarray(out_k), shape, "cpu")
    np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_dispatch_cpu_runs_plain_version():
    det, vol, projs, ang, vol0, z_off, roi, _ = _case("offset_detector")
    sin, cos = _sincos(ang)
    before = backproject_chunk_cuda.launches
    out = backproject_chunk(torch.zeros(vol0.shape), torch.from_numpy(projs),
                            torch.from_numpy(sin), torch.from_numpy(cos),
                            make_bp_grid(det, vol))
    want = _port(det, vol, projs, ang, vol0, z_off, roi)
    np.testing.assert_array_equal(out.numpy(), want)
    assert backproject_chunk_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    det, vol, projs, ang, vol0, _, _, _ = _case("offset_detector")
    sin, cos = _sincos(ang)
    before = backproject_chunk_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        backproject_chunk_cuda(torch.zeros(vol0.shape),
                               torch.from_numpy(projs), torch.from_numpy(sin),
                               torch.from_numpy(cos), make_bp_grid(det, vol))
    assert backproject_chunk_cuda.launches == before
