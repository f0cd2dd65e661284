"""The config-5 tooling of paris_tpu_torch at a small detector on the CPU
(``--backend torch``): the scan synthesizer, the sharded golden slabs and
the two full-scale runners (the counterparts of
``benchmarks/synth_c5_3600.py``, ``golden_slab.py``,
``full_scale_2048_3600.py`` and ``full_scale_2048.py``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from paris_tpu_torch import app
from paris_tpu_torch.benchmarks import full_scale_2048 as fs
from paris_tpu_torch.benchmarks import full_scale_2048_3600 as fs3600
from paris_tpu_torch.benchmarks import golden_slab as gs
from paris_tpu_torch.benchmarks import synth_c5_3600 as synth
from paris_tpu_torch.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu_torch.golden import golden_fdk_stream
from paris_tpu_torch.io.his import read_his
from paris_tpu_torch.phantom import cone_beam_project_torch

N_PROJ = 20                    # two files of 8 frames and one of 4
DET = DetectorGeometry(48, 48, 2.0, 2.0, 0.0, 0.0, 300.0, 300.0,
                       360.0 / N_PROJ)
BLOCK_DZ = 16                  # blocks at z 0, 16, 32, 48: first seam at 16
SLABS = ((14, 4), (22, 4))     # the seam slab, and one inside block 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(first, n):
    angles = np.arange(N_PROJ, dtype=np.float64) * DET.delta_phi
    scale = synth.phantom_scale(derive_volume_geometry(DET))
    return cone_beam_project_torch(DET, angles[first:first + n], scale,
                                   device="cpu").numpy()


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """The synthesized scan and the golden partials of SLABS, 2 shards."""
    workdir = str(tmp_path_factory.mktemp("c5"))
    synth.synthesize(workdir, DET, N_PROJ, device="cpu")
    for w in range(2):
        gs.golden_partials(workdir, DET, SLABS, N_PROJ, shard=(w, 2))
    return workdir


def _his_files(workdir):
    pdir = os.path.join(workdir, synth.PROJ_SUBDIR)
    return pdir, sorted(n for n in os.listdir(pdir) if n.endswith(".his"))


def test_synthesizer_writes_the_projectors_frames(scan):
    pdir, names = _his_files(scan)
    assert names == ["b00000.his", "b00008.his", "b00016.his"]
    for name in names:
        first = int(name[1:6])
        got = read_his(os.path.join(pdir, name))
        want = _frames(first, min(synth.BATCH, N_PROJ - first))
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    with open(os.path.join(pdir, synth.DONE_MARKER)) as f:
        assert f.read() == str(N_PROJ)
    assert not [n for n in os.listdir(pdir) if ".tmp" in n]


def test_synthesizer_resumes(tmp_path, monkeypatch):
    """A deleted file is written again, the complete ones are not touched,
    and SYNTH_DONE is renamed into place last."""
    workdir = str(tmp_path)
    synth.synthesize(workdir, DET, N_PROJ, device="cpu")
    pdir, names = _his_files(workdir)

    def stat(name):
        st = os.stat(os.path.join(pdir, name))
        return st.st_ino, st.st_mtime_ns

    before = {n: stat(n) for n in names}
    with open(os.path.join(pdir, "b00008.his"), "rb") as f:
        old = f.read()
    os.remove(os.path.join(pdir, "b00008.his"))
    renamed = []
    real_replace = os.replace

    def replace(src, dst):
        renamed.append(os.path.basename(dst))
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    out = synth.synthesize(workdir, DET, N_PROJ, device="cpu")
    assert renamed == ["b00008.his", synth.DONE_MARKER]
    assert out["frames_written"] == synth.BATCH
    assert out["card_ms_per_batch"] is None
    for n in ("b00000.his", "b00016.his"):
        assert stat(n) == before[n]
    with open(os.path.join(pdir, "b00008.his"), "rb") as f:
        assert f.read() == old


def test_golden_shards_sum_to_the_unsharded_golden(scan):
    """W = 2 partials, merged, equal golden_fdk_stream over the whole scan
    within 1e-4 max (the bound of tests/test_golden_fdk_e2e.py:83-88:
    backprojection is linear, so only the summation order differs)."""
    merged = gs.merge(scan, SLABS, 2)
    angles = np.arange(N_PROJ, dtype=np.float64) * DET.delta_phi
    whole = golden_fdk_stream(zip(_frames(0, N_PROJ), angles), DET,
                              derive_volume_geometry(DET), SLABS,
                              dtype=np.float32)
    for (z0, _dz), ref in zip(SLABS, whole):
        got = np.load(gs.final_path(scan, z0))
        np.testing.assert_array_equal(got, merged[z0])
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        assert np.abs(ref).max() > 0


def test_golden_waits_for_the_synthesizer(tmp_path):
    """A shard whose file is missing after SYNTH_DONE raises, naming it."""
    pdir = tmp_path / synth.PROJ_SUBDIR
    pdir.mkdir()
    (pdir / synth.DONE_MARKER).write_text(str(N_PROJ))
    with pytest.raises(RuntimeError, match="b00000.his"):
        gs.golden_partials(str(tmp_path), DET, SLABS, N_PROJ, poll_s=0.01)


def test_parse_slabs():
    assert gs.parse_slabs("342:4,858:4") == [(342, 4), (858, 4)]


def _spy_plans(monkeypatch):
    """The plans run_job takes, as it takes them."""
    plans = []
    real = app.plan_job

    def spy(*args, **kw):
        plans.append(real(*args, **kw))
        return plans[-1]

    monkeypatch.setattr(app, "plan_job", spy)
    return plans


@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_full_scale_3600_runner(scan, monkeypatch, accuracy):
    """The pinned-extent runner at a small geometry: more than one block,
    the seam and interior slabs within 1e-3 of the golden partials, and
    the plan it reports is the plan the job ran."""
    plans = _spy_plans(monkeypatch)
    res = fs3600.run(scan, accuracy=accuracy, n_proj=N_PROJ, det=DET,
                     block_dz=BLOCK_DZ, slabs=SLABS, backend="torch",
                     golden_timeout_s=0.0)
    assert res["pass"], res
    (job_plan,) = plans
    assert res["planned_blocks"] == job_plan.info.num > 1
    assert res["plan"] == [dataclasses.asdict(b) for b in job_plan.info.blocks]
    assert job_plan.info.blocks[1].z0 == SLABS[0][0] + 2
    for key in ("seam_slab_z14", "interior_slab_z22"):
        assert 0 < res[f"rel_rmse_vs_golden_{key}"] <= 1e-3
    assert len(res["per_block_gupd_per_s"]) == job_plan.info.num
    assert {"reconstruct", "finalize+write"} <= set(res["stage_seconds"])
    assert res["device"] == "cpu" and res["n_proj"] == N_PROJ


def test_full_scale_3600_runner_refuses_a_slab_off_the_seam(scan):
    with pytest.raises(ValueError, match="straddle"):
        fs3600.run(scan, n_proj=N_PROJ, det=DET, block_dz=BLOCK_DZ,
                   slabs=((10, 4),), backend="torch")


def test_full_scale_auto_plan_runner(tmp_path, monkeypatch):
    """The auto-planned runner: it synthesizes, plans as run_job does (on
    the CPU: no budget, one block), pins that plan, and gates the mid-z
    slab against golden shards run in their own processes."""
    plans = _spy_plans(monkeypatch)
    res = fs.run(str(tmp_path), accuracy="exact", n_proj=12, det=DET,
                 backend="torch", golden_shards=2)
    assert res["pass"], res
    (job_plan,) = plans          # the runner's own call is not the job's
    assert res["plan"] == [dataclasses.asdict(b) for b in job_plan.info.blocks]
    assert res["block_dz"] == job_plan.info.dim_z_padded
    assert res["planned_blocks"] == 1 and res["auto_hbm_budget_gb"] is None
    vol = derive_volume_geometry(DET)
    assert res["gate_slab"] == "mid z"
    assert res["gate_slab_z0"] == vol.dim_z // 2 - 2
    assert 0 < res["rel_rmse_vs_golden_gate_slab"] <= 1e-3
    assert os.path.exists(gs.final_path(str(tmp_path), vol.dim_z // 2 - 2))


def test_stage_seconds_and_record_result(tmp_path):
    assert fs3600.stage_seconds(
        "reconstruct: 1m05s (6 calls); finalize+write: 58.20s (6 calls)") \
        == {"reconstruct": 65.0, "finalize+write": 58.2}
    path = str(tmp_path / "out" / "r.json")
    fs3600.record_result(path, {"name": "a", "x": 1})
    fs3600.record_result(path, {"name": "b", "x": 2})
    fs3600.record_result(path, {"name": "a", "x": 3})
    import json
    with open(path) as f:
        assert json.load(f) == [{"name": "b", "x": 2}, {"name": "a", "x": 3}]
