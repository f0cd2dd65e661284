"""paris_tpu_torch preprocessing ops vs the JAX package and the NumPy
golden oracle (CPU torch, CPU JAX)."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paris_tpu import geometry as jax_geometry
from paris_tpu.golden import golden_filter, golden_weight
from paris_tpu.ops import filtering as jax_filtering
from paris_tpu.ops import weighting as jax_weighting
from paris_tpu import pipeline as jax_pipeline
from paris_tpu_torch.geometry import DetectorGeometry
from paris_tpu_torch.ops.filtering import (filter_projections,
                                           ramp_filter_spectrum,
                                           ramp_kernel_real)
from paris_tpu_torch.ops.weighting import apply_weights, weight_map
from paris_tpu_torch.pipeline import (dequantize_chunk, identity_qparams,
                                      preprocess_chunk, quantize_chunk_u16,
                                      stage_stream)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


def _jax_det(det):
    """The port's detector geometry as the JAX package's class."""
    return jax_geometry.DetectorGeometry(**dataclasses.asdict(det))


DETECTORS = {
    "centered": DetectorGeometry(96, 80, 1.0, 1.0, 0.0, 0.0, 200.0, 400.0,
                                 2.0),
    "offset": DetectorGeometry(96, 80, 2.0, 2.0, 4.6, -2.0, 500.0, 500.0,
                               2.0),
    "wide": DetectorGeometry(200, 40, 0.25, 0.5, 0.0, 1.5, 2048.0, 1024.0,
                             1.0),
}


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_weight_map_matches_jax(name):
    det = DETECTORS[name]
    ours = weight_map(det, CPU).numpy()
    ref = np.asarray(jax_weighting.weight_map(_jax_det(det)))
    assert ours.shape == (det.n_col, det.n_row)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_weighting_matches_golden(name):
    det = DETECTORS[name]
    p = np.random.default_rng(1).standard_normal(
        (det.n_col, det.n_row)).astype(np.float32)
    ours = apply_weights(torch.from_numpy(p), weight_map(det, CPU)).numpy()
    np.testing.assert_allclose(ours, golden_weight(p, _jax_det(det)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_row,tau", [(64, 2.0), (96, 1.0), (200, 0.25),
                                       (1024, 0.25)])
def test_ramp_filter_spectrum_matches_jax(n_row, tau):
    ours = ramp_filter_spectrum(n_row, tau, CPU)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jax_filtering.ramp_filter_spectrum(n_row, tau)),
        rtol=1e-6)
    np.testing.assert_array_equal(
        ramp_kernel_real(2 * n_row, tau),
        jax_filtering.ramp_kernel_real(2 * n_row, tau))


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_filter_projections_matches_jax_and_golden(name):
    """FFT libraries differ (pocketfft vs XLA/ducc), so the gate is
    1e-5 of the largest filtered value."""
    det = DETECTORS[name]
    p = np.random.default_rng(2).standard_normal(
        (3, det.n_col, det.n_row)).astype(np.float32)
    spec_t = ramp_filter_spectrum(det.n_row, det.l_px_row, CPU)
    ours = filter_projections(torch.from_numpy(p), spec_t, det.n_row).numpy()
    ref = np.asarray(jax_filtering.filter_projections(
        jnp.asarray(p), jax_filtering.ramp_filter_spectrum(
            det.n_row, det.l_px_row), det.n_row))
    gold = np.stack([golden_filter(f, _jax_det(det)) for f in p])
    scale = np.abs(gold).max()
    assert ours.shape == p.shape
    assert np.abs(ours - ref).max() <= 1e-5 * scale
    assert np.abs(ours - gold).max() <= 1e-5 * scale


def test_preprocess_chunk_matches_jax():
    det = DETECTORS["offset"]
    p = np.random.default_rng(3).standard_normal(
        (4, det.n_col, det.n_row)).astype(np.float32)
    ours = preprocess_chunk(torch.from_numpy(p), weight_map(det, CPU),
                            ramp_filter_spectrum(det.n_row, det.l_px_row, CPU),
                            det.n_row).numpy()
    ref = np.asarray(jax_pipeline.preprocess_chunk(
        jnp.asarray(p), jax_weighting.weight_map(_jax_det(det)),
        jax_filtering.ramp_filter_spectrum(det.n_row, det.l_px_row),
        det.n_row))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_filtering_dc_removal():
    det = DETECTORS["centered"]
    out = filter_projections(torch.ones(1, det.n_col, det.n_row),
                             ramp_filter_spectrum(det.n_row, det.l_px_row,
                                                  CPU), det.n_row)
    assert float(out[0, :, 20:-20].abs().max()) < 0.05


@pytest.mark.parametrize("n_real", [4, 2])
def test_quantize_dequantize_matches_jax(n_real):
    """The copied u16 quantizer gives the JAX package's bytes, and the
    torch dequant its values (padded frames come back as exact zeros)."""
    rng = np.random.default_rng(4)
    chunk = rng.uniform(-3.0, 5.0, (n_real, 24, 32)).astype(np.float32)
    q, qp = quantize_chunk_u16(chunk, 4)
    q_ref, qp_ref = jax_pipeline.quantize_chunk_u16(chunk, 4)
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(qp, qp_ref)
    ours = dequantize_chunk(torch.from_numpy(q), torch.from_numpy(qp)).numpy()
    ref = np.asarray(jax_pipeline.dequantize_chunk(jnp.asarray(q),
                                                   jnp.asarray(qp)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours[n_real:], 0.0)
    assert np.abs(ours[:n_real] - chunk).max() <= 8.0 / 65535 * 1.01


def test_identity_qparams_dequantize_is_identity():
    chunk = np.random.default_rng(5).standard_normal((3, 8, 8)).astype(
        np.float32)
    qp = identity_qparams(3)
    np.testing.assert_array_equal(qp, jax_pipeline.identity_qparams(3))
    out = dequantize_chunk(torch.from_numpy(chunk), torch.from_numpy(qp))
    np.testing.assert_array_equal(out.numpy(), chunk)


def test_stage_stream_order_counts_and_errors():
    seen = set()

    def stage(data, ang):
        seen.add(threading.current_thread().name)
        return data * 2

    pairs = [(np.full(3, i), list(range(i + 1))) for i in range(7)]
    out = list(stage_stream(stage, iter(pairs), depth=3, workers=2))
    assert [int(s[0]) for s, _ in out] == [0, 2, 4, 6, 8, 10, 12]
    assert [n for _, n in out] == [1, 2, 3, 4, 5, 6, 7]
    assert all(t.startswith("paris-stage") for t in seen)

    def bad_pairs():
        yield pairs[0]
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(stage_stream(stage, bad_pairs()))

    def bad_stage(data, ang):
        raise ValueError("stage died")

    with pytest.raises(ValueError, match="stage died"):
        list(stage_stream(bad_stage, iter(pairs)))
