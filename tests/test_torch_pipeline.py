"""paris_tpu_torch Reconstructor / reconstruct vs the JAX pipeline and
the NumPy golden oracle: BASELINE config 1 (64^3, 180 projections,
tests/test_golden_fdk_e2e.py:17-36) on CPU torch and CPU JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from paris_tpu import pipeline as jax_pipeline
from paris_tpu import geometry as jax_geometry
from paris_tpu.golden import golden_fdk
from paris_tpu.phantom import cone_beam_project
from paris_tpu_torch.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu_torch.pipeline import (Reconstructor, from_jax_state,
                                      reconstruct, resolve_backend)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_geo(det, vol):
    """The port's geometry objects as the JAX package's classes."""
    return (jax_geometry.DetectorGeometry(**dataclasses.asdict(det)),
            jax_geometry.VolumeGeometry(**dataclasses.asdict(vol)))


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.abs(b).max())


@pytest.fixture(scope="module")
def scan64():
    det = DetectorGeometry(64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
    vol = derive_volume_geometry(det)
    angles = np.arange(180, dtype=np.float32) * det.delta_phi
    projs = cone_beam_project(_jax_geo(det, vol)[0], angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2.0 * 0.9)
    return det, vol, projs, angles


@pytest.fixture(scope="module")
def golden64(scan64):
    det, vol, projs, angles = scan64
    return golden_fdk(projs, angles, *_jax_geo(det, vol))


@pytest.fixture(scope="module")
def jax_xla64(scan64):
    det, vol, projs, angles = scan64
    return jax_pipeline.reconstruct(*_jax_geo(det, vol), projs, angles, chunk_size=16,
                                    backend="xla")


def test_config1_exact_matches_jax_xla(scan64, jax_xla64):
    """180 projections at C=16: 11 full chunks and a zero-padded tail of 4."""
    det, vol, projs, angles = scan64
    ours = reconstruct(det, vol, projs, angles, chunk_size=16,
                       backend="torch")
    assert ours.shape == vol.shape_zyx and ours.dtype == np.float32
    assert np.abs(ours - jax_xla64).max() <= 1e-4 * np.abs(jax_xla64).max()


@pytest.mark.parametrize("accuracy", ["exact", "fast"])
def test_config1_vs_golden_rmse(scan64, golden64, accuracy):
    det, vol, projs, angles = scan64
    rec = Reconstructor(det, vol, chunk_size=16, backend="torch",
                        accuracy=accuracy)
    rmse = _rel_rmse(rec.run(projs, angles), golden64)
    assert rmse <= 1e-3, f"{accuracy}: relative RMSE {rmse:.2e} > 1e-3"


def test_tail_chunk_not_dividing_chunk_size(scan64, jax_xla64):
    det, vol, projs, angles = scan64
    ours = reconstruct(det, vol, projs, angles, chunk_size=7,
                       backend="torch")
    assert np.abs(ours - jax_xla64).max() <= 1e-4 * np.abs(jax_xla64).max()


def test_z_offset_roi_block_matches_jax(scan64):
    det, vol, projs, angles = scan64
    kw = dict(chunk_size=16, z_offset=20, roi_offset=(5, 3, 2),
              block_shape=(12, 40, 44))
    sub = slice(0, 40)
    ref = jax_pipeline.reconstruct(*_jax_geo(det, vol), projs[sub],
                                   angles[sub], backend="xla", **kw)
    ours = reconstruct(det, vol, projs[sub], angles[sub], backend="torch",
                       **kw)
    assert ours.shape == (12, 40, 44)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_fast_mode_matches_jax_pallas_fast(scan64):
    """Fast mode (u16 staging, bf16 projections) against the JAX Pallas
    fast path in interpret mode: both are within bf16 noise of the
    float32 result."""
    det, vol, projs, angles = scan64
    sub = slice(0, 32)
    block = (8, vol.dim_y, vol.dim_x)
    jax_rec = jax_pipeline.Reconstructor(
        *_jax_geo(det, vol), chunk_size=16, backend="pallas", interpret=True,
        accuracy="fast", block_shape=block)
    ref = jax_rec.run(projs[sub], angles[sub], z_offset=28)
    ours = Reconstructor(det, vol, chunk_size=16, backend="torch",
                         accuracy="fast", block_shape=block).run(
        projs[sub], angles[sub], z_offset=28)
    assert _rel_rmse(ours, ref) < 2e-3
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 2e-2


def test_accumulate_continues_a_jax_block(scan64):
    """A block half-accumulated by the JAX pipeline (Pallas layout) and
    finished by the port equals the JAX pipeline's whole run."""
    det, vol, projs, angles = scan64
    sub = slice(0, 48)
    block = (16, vol.dim_y, vol.dim_x)
    jax_rec = jax_pipeline.Reconstructor(*_jax_geo(det, vol), chunk_size=16,
                                         backend="pallas", interpret=True,
                                         accuracy="exact", block_shape=block)
    half = jax_rec.accumulate(jax_rec.init_block(), projs[:16], angles[:16],
                              z_offset=24)
    rec = Reconstructor(det, vol, chunk_size=16, backend="torch",
                        block_shape=block)
    acc = from_jax_state(np.asarray(half), block, rec.device)
    out = rec.finalize(rec.accumulate(acc, projs[16:48], angles[16:48],
                                      z_offset=24))
    ref = jax_pipeline.reconstruct(*_jax_geo(det, vol), projs[sub],
                                   angles[sub], backend="xla", z_offset=24,
                                   block_shape=block)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_step_staged_loop_equals_accumulate(scan64):
    det, vol, projs, angles = scan64
    rec = Reconstructor(det, vol, chunk_size=16, backend="torch",
                        block_shape=(8, vol.dim_y, vol.dim_x))
    a = rec.accumulate(rec.init_block(), projs[:40], angles[:40], z_offset=4)
    b = rec.init_block()
    for chunk, ang in rec._chunks(projs[:40], angles[:40]):
        b = rec.step_staged(b, rec.stage_chunk(chunk, ang), z_offset=4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_backend_resolution_without_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    assert resolve_backend("auto") == ("torch", torch.device("cpu"))
    with pytest.raises(ValueError, match="cuda"):
        resolve_backend("cuda")
    det = DetectorGeometry(32, 32, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 3.0)
    with pytest.raises(ValueError, match="cuda"):
        Reconstructor(det, derive_volume_geometry(det), backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas")
    with pytest.raises(ValueError, match="accuracy"):
        Reconstructor(det, derive_volume_geometry(det), accuracy="medium")
