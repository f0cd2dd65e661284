"""The port's throughput bench (``paris_tpu_torch.benchmarks.bench``) on the
CPU (``--backend torch``) at a 64³ volume: its one-line schema last, its
plan, and the step it times against the step the root ``bench.py`` times
in the JAX package (``Reconstructor(backend="xla")._step``) on the same
chunk and qparams."""

import dataclasses
import json
import statistics

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paris_tpu import geometry as jax_geometry
from paris_tpu import pipeline as jax_pipeline
from paris_tpu_torch.benchmarks import bench

SIZE, C = 64, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_main_prints_the_schema_last(tmp_path, capsys, monkeypatch,
                                     accuracy):
    """The env knobs set the size and the backend; the last line is the
    JAX bench's four keys, the metric named by the volume's side, the
    backend and the accuracy; vs_baseline is against 3350 GB/s over 8
    bytes; the value is the median of 5 loops (one step each on the
    CPU)."""
    for k, v in (("SIZE", "64"), ("BACKEND", "torch")):
        monkeypatch.setenv(f"PARIS_BENCH_{k}", v)
    out = tmp_path / "bench.json"
    res = bench.main(["--accuracy", accuracy, "--out", str(out)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == ("backprojection_gvoxel_updates_per_s_64cube_"
                              f"torch_{accuracy}")
    assert last["unit"] == "Gupd/s/chip" and last["value"] > 0
    gups = SIZE ** 3 * C / res["step_ms"] / 1e6
    assert last["vs_baseline"] == round(gups / (3350.0 / 8.0), 4)
    assert res["iters"] == 1 and len(res["step_ms_all"]) == 5
    assert res["step_ms"] == statistics.median(res["step_ms_all"])
    assert res["device"] == "cpu" and "k1_bound_share" not in res
    assert res["block_shape"] == [SIZE] * 3 and res["band_rows"] == SIZE
    (record,) = json.loads(out.read_text())
    assert record["metric"] == last["metric"]


def test_plan_and_iterations_are_the_jax_benchs():
    """At 1024: one whole 1024-slice block, no band (it would be the whole
    detector), 3 steps per timing; a forced extent takes the widest band
    over its blocks, as the JAX bench computes it."""
    det, vol = bench.geometry(1024)
    assert vol.shape_zyx == (1024, 1024, 1024)
    block, band = bench.plan(det, vol, 1024)
    assert block == (1024, 1024, 1024) and band is None
    assert bench.jax_iterations(1024 ** 3 * C) == 3
    assert bench.jax_iterations(SIZE ** 3 * C) == 100
    jdet = jax_geometry.DetectorGeometry(**dataclasses.asdict(det))
    jvol = jax_geometry.VolumeGeometry(**dataclasses.asdict(vol))
    block, band = bench.plan(det, vol, 1024, block_dz=256)
    want = max(jax_geometry.detector_row_band(jdet, jvol, z, 256)[1]
               - jax_geometry.detector_row_band(jdet, jvol, z, 256)[0]
               for z in range(0, 1024, 256))
    assert block == (256, 1024, 1024) and band == want < 1024
    assert bench.plan(det, vol, SIZE) == (None, None)
    assert bench.plan(det, vol, 1024, block_dz=-1) == (None, None)


def _border_ties(det, vol, phi, tol=1e-5):
    """Voxels whose float64 detector coordinate h or v lies within ``tol``
    pixels of a border where a bilinear tap turns on or off (0 and n - 1)
    at some angle: float32 cannot say on which side they fall."""
    def centered(n, l):
        return -n * l / 2 + l / 2 + np.arange(n) * l
    x = centered(vol.dim_x, vol.l_vx_x)[None, None, :]
    y = centered(vol.dim_y, vol.l_vx_y)[None, :, None]
    z = centered(vol.dim_z, vol.l_vx_z)[:, None, None]
    ties = np.zeros(vol.shape_zyx, bool)
    for p in phi.astype(np.float64):
        s = x * np.cos(p) + y * np.sin(p)
        f = det.d_sd / (s + det.d_so)
        h = (-x * np.sin(p) + y * np.cos(p)) * f / det.l_px_row \
            + det.n_row / 2 - 0.5
        v = z * f / det.l_px_col + det.n_col / 2 - 0.5
        for c, n in ((h, det.n_row), (v, det.n_col)):
            ties |= (np.abs(c) < tol) | (np.abs(c - (n - 1)) < tol)
    return ties


@pytest.mark.parametrize("size,accuracy", [(48, "exact"), (64, "exact"),
                                           (64, "fast")])
def test_timed_step_matches_the_jax_step(size, accuracy):
    """One step of what bench times, from zero, against the JAX step on
    the same float32 chunk, angles and identity qparams: exact within
    1e-4 max|JAX|; fast (the u16 round trip on the card, which the JAX
    package ran on its host while staging, and bf16 projections into the
    kernel) within the
    pipeline's fast-mode gates (tests/test_torch_pipeline.py).  At 64 one
    voxel's v lies 2.7e-6 px below the last tap row at one angle, under a
    float32 ulp: the port computes v as its kernel does and the XLA step
    otherwise, so they round it to opposite sides and that tap of a random
    projection is in one and out of the other.  The exact gate holds
    everywhere else (``_border_ties``)."""
    rec, staged = bench.setup(size, C, accuracy, "torch")
    chunk, phi = bench.bench_inputs(rec.det, C)
    np.testing.assert_array_equal(staged.chunk.numpy(), chunk)
    assert staged.n == C and staged.ready is None     # every frame is data
    ours = rec.step_staged(rec.init_block(), staged).numpy()
    jrec = jax_pipeline.Reconstructor(
        jax_geometry.DetectorGeometry(**dataclasses.asdict(rec.det)),
        jax_geometry.VolumeGeometry(**dataclasses.asdict(rec.vol)),
        chunk_size=C, backend="xla")
    ref = np.asarray(jrec._step(
        jrec.init_block(), jnp.asarray(chunk), jnp.asarray(np.sin(phi)),
        jnp.asarray(np.cos(phi)),
        jnp.asarray(jax_pipeline.identity_qparams(C)),
        jnp.zeros((4,), jnp.int32)))
    scale = np.abs(ref).max()
    assert ours.shape == ref.shape == (size,) * 3 and scale > 0
    if accuracy == "exact":
        ties = _border_ties(rec.det, rec.vol, phi)
        assert ties.mean() < 0.01
        assert np.abs(ours - ref)[~ties].max() <= 1e-4 * scale
    else:
        assert np.sqrt(np.mean((ours - ref) ** 2)) / scale < 2e-3
        assert np.abs(ours - ref).max() / scale < 2e-2
