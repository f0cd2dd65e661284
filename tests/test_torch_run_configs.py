"""The port's BASELINE config harness (``paris_tpu_torch.benchmarks.
run_configs``) on the CPU (``--backend torch``): configs 1 and 4 at the
JAX driver's sizes against the JAX package's ``reconstruct`` on the same
inputs; configs 2, 3 and 5 at a 48-64² detector with their gates and the
JAX driver's keys (``benchmarks/run_configs.py``, loaded by path for its
``_rel_rmse``; its recorded keys from ``benchmarks/
results_round2_configs.json``, read only); and ``main``'s exit code."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from paris_tpu import geometry as jax_geometry
from paris_tpu import phantom as jax_phantom
from paris_tpu import pipeline as jax_pipeline
from paris_tpu_torch.benchmarks import run_configs as rc
from paris_tpu_torch.geometry import DetectorGeometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = DetectorGeometry(48, 48, 1.0, 1.0, 0.0, 0.0, 384.0, 192.0, 0.5)


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_run_configs", os.path.join(REPO, "benchmarks", "run_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_DRIVER = _jax_driver()
with open(os.path.join(REPO, "benchmarks", "results_round2_configs.json")) as f:
    JAX_KEYS = {r["config"]: set(r) - {"platform"} for r in json.load(f)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_det(*args):
    return jax_geometry.DetectorGeometry(*args)


@pytest.mark.parametrize("config", [1, 4])
def test_config_matches_the_jax_reconstruct(config):
    """The port's config against the JAX package's ``reconstruct`` (XLA) on
    the JAX driver's inputs (its NumPy projector, angles, chunk and ROI):
    within 1e-4 max|JAX|, and the gate against the golden oracle held by
    the JAX driver's own ``_rel_rmse``."""
    vols = {}
    res = rc.CONFIGS[config](backend="torch", volumes=vols)
    if config == 1:
        det = _jax_det(64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
        angles = np.arange(180, dtype=np.float32) * 2.0
        scale, kw = 0.9, {}
    else:
        det = _jax_det(96, 80, 2.0, 2.0, 4.6, -1.5, 500.0, 500.0, 3.0)
        angles = np.arange(120, dtype=np.float32) * 3.0
        scale = 0.8
        kw = dict(roi_offset=(20, 25, 10), block_shape=(40, 40, 50))
    vol = jax_geometry.derive_volume_geometry(det)
    projs = jax_phantom.cone_beam_project(
        det, angles, scale_mm=vol.dim_x * vol.l_vx_x / 2 * scale)
    ref = jax_pipeline.reconstruct(det, vol, projs, angles, chunk_size=16,
                                   backend="xla", **kw)
    ours = vols["ours"]
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
    rmse = JAX_DRIVER._rel_rmse(ours, vols["golden"])
    assert rmse == pytest.approx(res["rel_rmse_vs_golden"], rel=1e-6)
    if config == 4:
        # the ROI in three banded blocks at the offset detector
        blocks = vols["ours_blocks"]
        assert res["blocks"] == 3 and blocks.shape == ref.shape
        assert np.abs(blocks - ref).max() <= 1e-4 * np.abs(ref).max()
        assert JAX_DRIVER._rel_rmse(blocks, vols["golden"]) == \
            pytest.approx(res["rel_rmse_vs_golden_blocks"], rel=1e-6)
    assert res["pass"] and rmse <= 1e-3
    assert JAX_KEYS[config] <= set(res) and res["device"] == "cpu"


def test_config2_shrunk():
    """Both modes' throughput and both RMSE gates at a 48² detector, the
    golden oracle in 2 processes."""
    res = rc.config2("torch", det=SMALL, n_proj=24, n_corr=16, shards=2)
    assert JAX_KEYS[2] <= set(res)
    assert res["pass"] and res["volume"] == (48, 48, 48)
    assert set(res["rel_rmse_vs_golden"]) == {"exact", "fast"}
    assert all(0 < v <= 1e-3 for v in res["rel_rmse_vs_golden"].values())
    assert res["gupd_per_s_exact"] > 0 and res["gupd_per_s_fast"] > 0


def test_config3_shrunk():
    """Two blocks of 32 slices of a 64² detector: both modes, the seam slab
    and the slices on either side of the seam under the gate, the golden
    oracle in 2 processes."""
    det = DetectorGeometry(64, 64, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0, 1.0)
    res = rc.config3("torch", det=det, n_proj=16, shards=2)
    assert JAX_KEYS[3] <= set(res)
    assert res["pass"] and res["block_dz"] == 32 and res["seam_slab_z0"] == 30
    rmse = res["rel_rmse_vs_golden_seam_slab"]
    assert set(rmse) == {f"{a}{s}" for a in ("exact", "fast")
                         for s in ("", "_below_seam", "_above_seam")}
    assert all(0 < v <= 1e-3 for v in rmse.values())


def test_config5_in_a_gloo_group_of_one():
    """The distributed step in a world-1 gloo group made and destroyed by
    the config; the block is the volume's 48 slices (no 128 rounding)."""
    import torch.distributed as dist
    res = rc.config5("torch", det=SMALL)
    assert not dist.is_initialized()
    assert JAX_KEYS[5] <= set(res)
    assert res["mesh_devices"] == 1 and res["block_dz"] == 48
    assert res["chunk_size"] == 8 and res["backend"] == "torch"
    assert res["gupd_per_s_total"] == res["gupd_per_s_per_device"] > 0


def test_main_records_an_error_and_exits_non_zero(tmp_path, monkeypatch,
                                                  capsys):
    """A config that raises is recorded as {"config", "name", "error"},
    the next config still runs, and main exits non-zero at the end."""
    def boom(backend):
        raise ValueError("no such geometry")

    monkeypatch.setitem(rc.CONFIGS, 1, boom)
    monkeypatch.setitem(rc.CONFIGS, 4, lambda backend: {
        "config": 4, "name": rc.NAMES[4], "pass": True})
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as e:
        rc.main(["--configs", "1,4", "--backend", "torch", "--out", str(out)])
    assert e.value.code not in (0, None)
    recs = json.loads(out.read_text())
    assert recs[0] == {"config": 1, "name": "shepp_logan_64",
                       "error": "ValueError: no such geometry"}
    assert recs[1]["config"] == 4
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["config"] for r in lines] == [1, 4]


def test_main_exits_non_zero_on_a_failed_gate(tmp_path, monkeypatch):
    monkeypatch.setitem(rc.CONFIGS, 4, lambda backend: {
        "config": 4, "name": rc.NAMES[4], "pass": False})
    with pytest.raises(SystemExit):
        rc.main(["--configs", "4", "--out", str(tmp_path / "r.json")])
    monkeypatch.setitem(rc.CONFIGS, 4, lambda backend: {
        "config": 4, "name": rc.NAMES[4], "pass": True})
    assert rc.main(["--configs", "4", "--out", str(tmp_path / "r.json")]
                   )["results"][0]["pass"]
