"""The config-5 tooling of paris_tpu_torch at a small detector on the CPU
(``--backend torch``): the scan synthesizer, the sharded golden slabs and
the two full-scale runners (the counterparts of
``benchmarks/synth_c5_3600.py``, ``golden_slab.py``,
``full_scale_2048_3600.py`` and ``full_scale_2048.py``)."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paris_tpu import phantom as jax_phantom
from paris_tpu.app import ReconstructionJob as JaxJob, run_job as jax_run_job
from paris_tpu.geometry import DetectorGeometry as JaxDetectorGeometry
from paris_tpu_torch import app
from paris_tpu_torch.benchmarks import full_scale_2048 as fs
from paris_tpu_torch.benchmarks import full_scale_2048_3600 as fs3600
from paris_tpu_torch.benchmarks import golden_slab as gs
from paris_tpu_torch.benchmarks import synth_c5_3600 as synth
from paris_tpu_torch.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu_torch.golden import golden_fdk_stream
from paris_tpu_torch.io import ddbvf
from paris_tpu_torch.io.his import read_his, read_his_header, write_his
from paris_tpu_torch.phantom import cone_beam_project_torch

N_PROJ = 20                    # two files of 8 frames and one of 4
DET = DetectorGeometry(48, 48, 2.0, 2.0, 0.0, 0.0, 300.0, 300.0,
                       360.0 / N_PROJ)
BLOCK_DZ = 16                  # blocks at z 0, 16 and 32: seams at 16, 32
SLABS = ((14, 4), (22, 4))     # the first seam slab, and one inside block 1
INTERIOR = ((22, 4),)


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
    assert renamed == ["b00008.his", synth.MAP_FILE, synth.DONE_MARKER]
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
    """The pinned-extent runner at a small geometry: three blocks, every
    seam slab of the plan and the interior slab within 1e-3 of the golden
    oracle, and the plan it reports is the plan the job ran."""
    plans = _spy_plans(monkeypatch)
    res = fs3600.run(scan, accuracy=accuracy, n_proj=N_PROJ, det=DET,
                     block_dz=BLOCK_DZ, interior=INTERIOR, backend="torch",
                     golden_shards=1)
    assert res["pass"], res
    (job_plan,) = plans
    assert res["planned_blocks"] == job_plan.info.num == 3
    assert res["plan"] == [dataclasses.asdict(b) for b in job_plan.info.blocks]
    assert [b.z0 for b in job_plan.info.blocks[1:]] == [16, 32]
    for key in ("seam_z14", "seam_z30", "interior_z22"):
        assert 0 < res[f"rel_rmse_vs_golden_{key}"] <= 1e-3
    assert len([k for k in res if k.startswith("rel_rmse")]) == 3
    assert len(res["per_block_gupd_per_s"]) == job_plan.info.num
    assert [d["block"] for d in res["per_block_drain"]] == [0, 1, 2]
    assert {"block", "drain"} <= set(res["stage_seconds"])
    assert res["device"] == "cpu" and res["n_proj"] == N_PROJ
    assert res["name"] == f"full_scale_2048_{N_PROJ}proj_single_card" + (
        "" if accuracy == "fast" else "_exact")
    assert res["scan"]["number_type"] == "float32"


def test_full_scale_3600_runner_refuses_a_slab_off_the_seam(scan):
    """An interior slab across a seam, and a plan whose seam slabs would
    straddle more than their own seam, are refused before any job."""
    with pytest.raises(ValueError, match="straddle"):
        fs3600.run(scan, n_proj=N_PROJ, det=DET, block_dz=BLOCK_DZ,
                   interior=((14, 4),), backend="torch")
    blocks = [SimpleNamespace(z0=z0) for z0 in (0, 8, 9)]
    with pytest.raises(ValueError, match="straddle"):
        fs3600.plan_slabs(SimpleNamespace(blocks=blocks, num=3), 48, ())


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


# ------------------------------------------------------------- uint16 scan

@pytest.fixture(scope="module")
def scan_u16(tmp_path_factory):
    """The scan synthesized as uint16 counts, and the synthesizer's
    record."""
    workdir = str(tmp_path_factory.mktemp("c5u16"))
    out = synth.synthesize(workdir, DET, N_PROJ, device="cpu",
                           number_type="uint16")
    return workdir, out


def _counts(workdir):
    pdir = os.path.join(workdir, synth.PROJ_SUBDIR)
    return np.concatenate([read_his(synth.his_path(pdir, i))
                           for i in range(0, N_PROJ, synth.BATCH)])


def test_u16_synthesizer_counts_match_the_numpy_projector(scan_u16):
    """Counts x scale equal the JAX package's float64 NumPy projector
    within scale/2 plus the projector gates of
    tests/test_golden_fdk_e2e.py:91-103 (relative RMSE 1e-3, max|err|
    5 % of max); the counts are the torch projector's frames rounded;
    HIS number type 4; the map file beside them; nothing clipped."""
    workdir, out = scan_u16
    pdir = os.path.join(workdir, synth.PROJ_SUBDIR)
    scan_map = synth.read_scan_map(pdir)
    scale_mm = synth.phantom_scale(derive_volume_geometry(DET))
    assert scan_map == out["map"]
    assert scan_map == {"number_type": "uint16",
                        "scale": synth.count_scale(scale_mm), "offset": 0.0,
                        "n_proj": N_PROJ, "clipped": 0,
                        "line_integral_bound": pytest.approx(
                            synth.line_integral_bound(scale_mm))}
    for i in range(0, N_PROJ, synth.BATCH):
        assert read_his_header(synth.his_path(pdir, i)).number_type == 4
    q = scan_map["scale"]
    counts = _counts(workdir)
    np.testing.assert_array_equal(
        counts, np.rint(_frames(0, N_PROJ) / np.float32(q)))
    assert 0 <= counts.min() and counts.max() < 65535
    angles = np.arange(N_PROJ, dtype=np.float64) * DET.delta_phi
    ref = jax_phantom.cone_beam_project(
        JaxDetectorGeometry(**dataclasses.asdict(DET)), angles, scale_mm,
        dtype=np.float64)
    err = counts.astype(np.float64) * q - ref
    peak = np.abs(ref).max()
    assert np.sqrt(np.mean(err ** 2)) < 1e-3 * peak + q / 2
    assert np.abs(err).max() < 0.05 * peak + q / 2


def test_u16_synthesizer_resumes(tmp_path):
    """Complete uint16 files are kept (their size comes from their own
    header, not from float32's); a float32 file where a uint16 one
    belongs, and a cut file, are written again."""
    workdir = str(tmp_path)
    synth.synthesize(workdir, DET, N_PROJ, device="cpu", number_type="uint16")
    pdir, names = _his_files(workdir)
    first = {n: open(os.path.join(pdir, n), "rb").read() for n in names}
    inodes = {n: os.stat(os.path.join(pdir, n)).st_ino for n in names}
    again = synth.synthesize(workdir, DET, N_PROJ, device="cpu",
                             number_type="uint16")
    assert again["frames_written"] == 0
    assert {n: os.stat(os.path.join(pdir, n)).st_ino for n in names} == inodes
    write_his(os.path.join(pdir, "b00008.his"),
              np.zeros((8, DET.n_col, DET.n_row), np.float32))
    with open(os.path.join(pdir, "b00016.his"), "r+b") as f:
        f.truncate(1000)
    out = synth.synthesize(workdir, DET, N_PROJ, device="cpu",
                           number_type="uint16")
    assert out["frames_written"] == 8 + 4
    for n in names:
        with open(os.path.join(pdir, n), "rb") as f:
            assert f.read() == first[n]
    assert os.stat(os.path.join(pdir, "b00000.his")).st_ino == inodes[
        "b00000.his"]


def test_golden_over_a_u16_scan(scan_u16):
    """The golden shards read the uint16 files (they used to take them for
    cut float32 files and raise once SYNTH_DONE was there) and sum to the
    unsharded golden over the same counts."""
    workdir, _ = scan_u16
    for w in range(2):
        gs.golden_partials(workdir, DET, SLABS, N_PROJ, shard=(w, 2),
                           poll_s=0.01)
    merged = gs.merge(workdir, SLABS, 2)
    angles = np.arange(N_PROJ, dtype=np.float64) * DET.delta_phi
    whole = golden_fdk_stream(zip(_counts(workdir), angles), DET,
                              derive_volume_geometry(DET), SLABS,
                              dtype=np.float32)
    for (z0, _dz), ref in zip(SLABS, whole):
        assert np.abs(merged[z0] - ref).max() <= 1e-4 * np.abs(ref).max()
        assert np.abs(ref).max() > 0


def test_full_scale_3600_runner_split_by_block(scan_u16):
    """The job run one block per run (--first-block k --max-blocks 1, each
    over a fresh ddbvf) writes the whole job's slices byte for byte, and
    the parts' gates combine into the whole job's: every seam slab of the
    plan and the interior slab, named for the uint16 scan.  A job missing
    a block does not pass."""
    workdir, _ = scan_u16
    kw = dict(accuracies=("exact",), n_proj=N_PROJ, det=DET,
              block_dz=BLOCK_DZ, interior=INTERIOR, backend="torch",
              golden_shards=1)
    whole = fs3600.run_call(workdir, **kw)
    ref = ddbvf.read_volume(os.path.join(workdir, "c5x.ddbvf"))
    parts = []
    for k, (z0, dz) in enumerate(((0, 16), (16, 16), (32, 16))):
        (rec,) = fs3600.run_call(workdir, first_block=k, max_blocks=1, **kw)
        assert rec["blocks"] == [k] and rec["job"] == whole[0]["job"]
        assert rec["name"] == f"{rec['job']}_blocks{k}-{k}"
        got = ddbvf.read_slices(os.path.join(workdir, "c5x.ddbvf"), z0, dz)
        assert got.tobytes() == ref[z0:z0 + dz].tobytes()
        parts.append(rec)
    res, want = fs3600.combine(parts), fs3600.combine(whole)
    assert want["name"] == f"full_scale_2048_{N_PROJ}proj_u16_single_card_exact"
    assert res["pass"] and want["pass"], (res, want)
    keys = [k for k in want if k.startswith("rel_rmse_vs_golden_")]
    assert sorted(keys) == sorted(f"rel_rmse_vs_golden_{k}" for k in (
        "seam_z14", "seam_z30", "interior_z22"))
    for key in keys:
        assert res[key] == pytest.approx(want[key], rel=1e-9)
    assert len(res["per_block_proj_per_s"]) == 3 and len(res["calls"]) == 3
    assert res["scan"]["number_type"] == "uint16"
    short = fs3600.combine(parts[:2])
    assert not short["pass"] and "blocks run [0, 1]" in short["failures"][0]


def test_full_scale_3600_runner_fails_one_slab(scan_u16, monkeypatch,
                                               tmp_path):
    """One golden slab 5 % off (the second seam's) fails the job, naming
    that slab alone; the combining entry point then exits non-zero."""
    workdir, _ = scan_u16
    real = fs3600.finish_shards

    def skewed(procs, wd, slabs, **kw):
        goldens = real(procs, wd, slabs, **kw)
        goldens[30] = goldens[30] * 1.05
        return goldens

    monkeypatch.setattr(fs3600, "finish_shards", skewed)
    (rec,) = fs3600.run_call(workdir, n_proj=N_PROJ, det=DET,
                             block_dz=BLOCK_DZ, interior=INTERIOR,
                             backend="torch", golden_shards=1)
    res = fs3600.combine([rec])
    assert res["rel_rmse_vs_golden_seam_z14"] <= 1e-3
    assert res["rel_rmse_vs_golden_interior_z22"] <= 1e-3
    bad = res["rel_rmse_vs_golden_seam_z30"]
    assert bad > 1e-3 and not res["pass"]
    assert res["failures"] == [f"seam slab z 30: relative RMSE {bad:.3e}"]
    rec = dict(rec, name=rec["job"] + "_blocks0-2")
    path = str(tmp_path / "rec.json")
    fs3600.record_result(path, rec)
    with pytest.raises(SystemExit, match="seam slab z 30"):
        fs3600.main(["--combine", path, "--out", str(tmp_path / "r.json")])


def test_u16_scan_port_job_against_the_jax_job(scan_u16, tmp_path):
    """The slice against the JAX package: the same uint16 files through
    the port's run_job (plain version, exact) and through the JAX
    package's run_job on CPU JAX (its XLA path), three blocks each; the
    volumes agree to relative RMSE <= 1e-5."""
    workdir, _ = scan_u16
    pdir = os.path.join(workdir, synth.PROJ_SUBDIR)
    port = ddbvf.read_volume(app.run_job(app.ReconstructionJob(
        det=DET, input_path=pdir, output_path=str(tmp_path / "port"),
        prefix="v", chunk_size=8, backend="torch", accuracy="exact",
        block_dz=BLOCK_DZ)))
    ref = ddbvf.read_volume(jax_run_job(JaxJob(
        det=JaxDetectorGeometry(**dataclasses.asdict(DET)), input_path=pdir,
        output_path=str(tmp_path / "jax"), prefix="v", chunk_size=8,
        backend="xla", accuracy="exact", block_dz=BLOCK_DZ)))
    assert port.shape == ref.shape == (48, 48, 48)
    rmse = np.sqrt(np.mean((port.astype(np.float64) - ref) ** 2))
    assert rmse <= 1e-5 * np.abs(ref).max()


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
