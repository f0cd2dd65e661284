"""The distributed path of paris_tpu_torch (DistributedReconstructor,
multihost helpers, run_job_distributed through the CLI) against the port's
single-device path and the JAX package's distributed path (CPU torch over
gloo, CPU JAX on the virtual 8-device mesh of tests/conftest.py).

In-process tests share one world-1 gloo group made by a module fixture;
the 2-rank tests spawn the CLI twice, as a user launches it, with a
rendezvous on a free local port (tests/test_multihost_2proc.py)."""

import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from paris_tpu.app import ReconstructionJob as JaxJob, run_job as jax_run_job
from paris_tpu import geometry as jax_geometry
from paris_tpu.io import ddbvf
from paris_tpu.io.geometry_file import dump_geometry_file
from paris_tpu.io.his import write_his
from paris_tpu.parallel import DistributedReconstructor as JaxDistributed
from paris_tpu.parallel import make_z_mesh
from paris_tpu_torch.app import ReconstructionJob, run_job
from paris_tpu_torch.geometry import (DetectorGeometry, RegionOfInterest,
                                      apply_roi, derive_volume_geometry)
from paris_tpu_torch.io.drain import BlockDrain
from paris_tpu_torch.parallel import dist as dist_mod
from paris_tpu_torch.parallel import multihost
from paris_tpu_torch.parallel.dist import DistributedReconstructor, owned_slots
from paris_tpu_torch.pipeline import (ArrayRows, Reconstructor,
                                     quantize_chunk_u16, quantize_u16_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETUP_DET = DetectorGeometry(n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
                             delta_s=0.0, delta_t=0.0, d_so=400.0,
                             d_od=400.0, delta_phi=9.0)
# the HIS scan of tests/test_multihost_2proc.py:25-27
HIS_DET = DetectorGeometry(n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
                           delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0,
                           delta_phi=22.5)
ROI = RegionOfInterest(x1=6, x2=53, y1=10, y2=49, z1=4, z2=51)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-1 gloo group for the in-process tests."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup():
    vol = derive_volume_geometry(SETUP_DET)
    rng = np.random.default_rng(0)
    projs = rng.standard_normal((24, 64, 64)).astype(np.float32)
    angles = np.arange(24, dtype=np.float32) * SETUP_DET.delta_phi
    return SETUP_DET, vol, projs, angles


def _jax_geo(*objs):
    """The port's geometry objects as the JAX package's classes."""
    return tuple(getattr(jax_geometry, type(o).__name__)(
        **dataclasses.asdict(o)) for o in objs)


def _close(got, ref, tol=1e-4):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("case", ["full", "z_offset", "roi", "fast"])
def test_world1_matches_jax_and_single_device(group, setup, case):
    """World-1 DistributedReconstructor: bit for bit the port's
    Reconstructor, and within 1e-4 of the JAX DistributedReconstructor on a
    2-device mesh (XLA backend; the cases of tests/test_distributed.py:31,
    :56, :300)."""
    det, vol, projs, angles = setup
    mesh = make_z_mesh(jax.devices()[:2])
    kw, jax_kw, accuracy = {}, {}, "exact"
    if case == "roi":
        vol = apply_roi(vol, ROI)
        projs, angles = projs[:8], angles[:8]
        kw = jax_kw = dict(roi_offset=(ROI.x1, ROI.y1, ROI.z1))
    dz = 16 if case == "z_offset" else -(-vol.dim_z // 2) * 2
    if case == "z_offset":
        kw = jax_kw = dict(z_offset=8)
    if case == "fast":
        accuracy = "fast"
    shape = (dz, vol.dim_y, vol.dim_x)
    rec = DistributedReconstructor(det, vol, chunk_size=8, block_shape=shape,
                                   backend="torch", accuracy=accuracy)
    assert (rec.world, rec.rank, rec.local_dz) == (1, 0, dz)
    out = rec.finalize(rec.accumulate(rec.init_block(), projs, angles, **kw))
    single = Reconstructor(det, vol, chunk_size=8, block_shape=shape,
                           backend="torch", accuracy=accuracy)
    np.testing.assert_array_equal(out, single.run(projs, angles, **kw))
    if case != "fast":
        jd = JaxDistributed(*_jax_geo(det, vol), mesh=mesh, chunk_size=8, block_dz=dz,
                            backend="xla")
        ref = np.asarray(jd.accumulate(jd.init_block(), projs, angles,
                                       **jax_kw))
        _close(out, ref)


def test_reconstruct_trims_to_the_volume(group, setup):
    det, vol, projs, angles = setup
    rec = DistributedReconstructor(det, vol, chunk_size=8, backend="torch",
                                   block_shape=(72, vol.dim_y, vol.dim_x))
    out = rec.reconstruct(projs[:8], angles[:8])
    assert out.shape == vol.shape_zyx


def test_chunk_not_multiple_of_world_raises(group, setup, monkeypatch):
    det, vol, _, _ = setup
    with pytest.raises(ValueError, match="not divisible"):
        owned_slots(0, 3, 8)
    monkeypatch.setattr(dist_mod, "world_and_rank", lambda group=None: (3, 0))
    with pytest.raises(ValueError, match="chunk_size 8 not divisible"):
        DistributedReconstructor(det, vol, chunk_size=8, backend="torch",
                                 block_shape=(66, 64, 64))
    with pytest.raises(ValueError, match="block dz 64 not divisible"):
        DistributedReconstructor(det, vol, chunk_size=9, backend="torch")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_owned_slots_partition(world):
    """Each rank owns a contiguous run of C/n slots, blockwise over the
    ranks (tests/test_distributed.py:425); the union is a disjoint cover
    of all C slots."""
    C = 8
    slots = [owned_slots(r, world, C) for r in range(world)]
    assert slots[0][0] == 0 and slots[-1][1] == C
    for (lo, hi), (lo2, _) in zip(slots, slots[1:]):
        assert hi - lo == C // world and hi == lo2
    seen = [s for lo, hi in slots for s in range(lo, hi)]
    assert sorted(seen) == list(range(C))


def test_stage_chunk_reads_only_own_slots(group, monkeypatch):
    """Rank 1 of 2 stages only slots [4, 8), raw: it asks the chunk for
    those rows alone (the others, NaN here, are never read), its rows are
    the frames as given and slots past the stream's end are zero; their
    u16 quantization on its device equals a whole-chunk quantization's
    rows, padding (0, 0) (tests/test_distributed.py:446)."""
    monkeypatch.setattr(dist_mod, "world_and_rank", lambda group=None: (2, 1))
    det = DetectorGeometry(64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 45.0)
    vol = derive_volume_geometry(det)
    rec = DistributedReconstructor(det, vol, chunk_size=8, backend="torch",
                                   accuracy="fast")
    assert rec.init_block().shape == (vol.dim_z // 2, 64, 64)
    rng = np.random.default_rng(3)
    data = rng.uniform(-5, 900, (6, 64, 64)).astype(np.float32)
    angs = np.arange(6, dtype=np.float32) * 45.0
    poisoned = data.copy()
    poisoned[:4] = np.nan
    asked = []

    class Rows(ArrayRows):
        def read_into(self, out, lo=0, hi=None):
            asked.append((lo, hi))
            super().read_into(out, lo, hi)

    staged = rec.stage_chunk(Rows(poisoned), angs)
    assert asked == [(4, 8)]
    assert staged.chunk.shape == (4, 64, 64) and staged.sin.shape == (4,)
    assert staged.n == 2 and staged.chunk.dtype == torch.float32
    np.testing.assert_array_equal(staged.chunk[:2].numpy(), data[4:6])
    np.testing.assert_array_equal(staged.chunk[2:].numpy(), 0)
    q, qp = quantize_u16_torch(staged.chunk, staged.n)
    full_q, full_p = quantize_chunk_u16(data, 8)
    np.testing.assert_array_equal(q[:2].numpy(), full_q[4:6])
    np.testing.assert_array_equal(qp[:2].numpy(), full_p[4:6])
    np.testing.assert_array_equal(q[2:].numpy(), 0)
    np.testing.assert_array_equal(qp[2:].numpy(), 0.0)
    np.testing.assert_array_equal(
        staged.sin.numpy(), np.sin(np.deg2rad(np.pad(angs, (0, 2))[4:])))


def test_agree_min_with_none(group):
    """None wins only when no rank has a value; int64 values pass
    through."""
    cpu = torch.device("cpu")
    assert not multihost.is_multihost()
    assert multihost.agree_min(None, 5, 0, 1 << 40, device=cpu) == (
        None, 5, 0, 1 << 40)
    assert multihost.agree_min(device=cpu) == ()


def test_write_local_shards(tmp_path):
    rng = np.random.default_rng(3)
    slab = rng.standard_normal((16, 4, 4)).astype(np.float32)
    path = str(tmp_path / "mh.ddbvf")
    ddbvf.create(path, 4, 4, 30)
    drain = BlockDrain("cpu", (4, 4), 16)
    assert multihost.write_local_shards(path, torch.from_numpy(slab), 5,
                                        max_z=15, drain=drain) == 10
    np.testing.assert_array_equal(ddbvf.read_slices(path, 5, 10), slab[:10])
    np.testing.assert_array_equal(ddbvf.read_slices(path, 15, 15), 0)
    assert multihost.write_local_shards(path, torch.from_numpy(slab), 20,
                                        max_z=20, drain=drain) == 0
    assert multihost.write_local_shards(path, torch.from_numpy(slab), 14,
                                        drain=drain) == 16
    np.testing.assert_array_equal(ddbvf.read_slices(path, 14, 16), slab)


@pytest.mark.parametrize("slices", [3, 16])
def test_write_local_shards_through_a_drain(tmp_path, monkeypatch, slices):
    """The slab written through a drain of ``slices`` slices per slab: the
    same slices at the same offsets as test_write_local_shards, one pwrite
    per slab, the split in ``split``."""
    from paris_tpu_torch.io import drain as drain_mod
    from paris_tpu_torch.utils.logging import StageTimers
    rng = np.random.default_rng(3)
    slab = rng.standard_normal((16, 4, 4)).astype(np.float32)
    path = str(tmp_path / "mh.ddbvf")
    ddbvf.create(path, 4, 4, 30)
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", slices * 64)
    drain = drain_mod.BlockDrain("cpu", (4, 4), 16)
    split = StageTimers()
    assert multihost.write_local_shards(path, torch.from_numpy(slab), 5,
                                        max_z=15, drain=drain,
                                        split=split) == 10
    assert split.counts["write"] == -(-10 // slices)
    np.testing.assert_array_equal(ddbvf.read_slices(path, 5, 10), slab[:10])
    np.testing.assert_array_equal(ddbvf.read_slices(path, 15, 15), 0)


def test_crash_diagnostics_marker(tmp_path, caplog):
    """A failure names the rank and drops a marker
    (tests/test_distributed.py:177)."""
    with caplog.at_level(logging.ERROR, logger="paris_tpu_torch.multihost"):
        with pytest.raises(RuntimeError, match="boom"):
            with multihost.crash_diagnostics("unit-test", str(tmp_path)):
                raise RuntimeError("boom")
    assert "rank 0/1" in caplog.text
    text = (tmp_path / "crash.p0.log").read_text()
    assert "RuntimeError: boom" in text and "stage: unit-test" in text


def test_initialize_refuses_a_second_group(group):
    with pytest.raises(RuntimeError, match="already exists"):
        multihost.initialize(backend="torch")


# ------------------------------------------------------ two ranks, CLI

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def his_scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("his")
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 60000, (16, 64, 64)).astype(np.uint16)
    pdir = root / "proj"
    pdir.mkdir()
    for i in range(0, 16, 8):
        write_his(str(pdir / f"b{i:04d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)
    gpath = root / "scan.geo"
    dump_geometry_file(_jax_geo(HIS_DET)[0], str(gpath))
    return str(pdir), str(gpath)


def _two_ranks(his_scan, out, *extra):
    """Run the CLI as ranks 0 and 1 of a gloo group; returns their
    stderr."""
    pdir, gpath = his_scan
    argv = ["--geometry", gpath, "--input", pdir, "--output", str(out),
            "--name", "v", "--backend", "torch", "--chunk-size", "8",
            "--block-dz", "32", "--distributed",
            "--coordinator", f"127.0.0.1:{_free_port()}",
            "--num-processes", "2", *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paris_tpu_torch.cli", *argv,
         "--process-id", str(rank)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}\n" \
                                  f"{err[-4000:]}"
    return [err for _, err in outs]


def _single(his_scan, out, accuracy):
    return ddbvf.read_volume(run_job(ReconstructionJob(
        det=HIS_DET, input_path=his_scan[0], output_path=str(out),
        prefix="v", chunk_size=8, backend="torch", accuracy=accuracy,
        block_dz=32)))


def test_two_rank_cli_matches_single_process(his_scan, tmp_path):
    """Two gloo ranks through the CLI: byte-identical to the port's
    single-process run_job with the same forced extent, and within 1e-4 of
    the JAX run_job; each rank decoded half the stream."""
    errs = _two_ranks(his_scan, tmp_path / "mh", "--accuracy", "exact")
    for err in errs:
        assert "rank" in err and "decodes 4 of 8 chunk slots" in err
    got = ddbvf.read_volume(str(tmp_path / "mh" / "v.ddbvf"))
    np.testing.assert_array_equal(got, _single(his_scan, tmp_path / "ref",
                                               "exact"))
    manifest = json.load(open(tmp_path / "mh" / "v.ddbvf.manifest.json"))
    assert manifest["completed_blocks"] == [0, 1]
    ref = ddbvf.read_volume(jax_run_job(JaxJob(
        det=_jax_geo(HIS_DET)[0], input_path=his_scan[0],
        output_path=str(tmp_path / "jax"), prefix="v", chunk_size=8,
        backend="xla", accuracy="exact", block_dz=32)))
    _close(got, ref)


def test_two_rank_cli_max_blocks_then_resume(his_scan, tmp_path):
    """--max-blocks 1 writes block 0 only; --resume completes the volume,
    byte-identical to one uninterrupted single-process run (fast mode:
    each rank quantizes its own slots)."""
    out = tmp_path / "mb"
    _two_ranks(his_scan, out, "--max-blocks", "1")
    manifest = json.load(open(out / "v.ddbvf.manifest.json"))
    assert manifest["completed_blocks"] == [0]
    errs = _two_ranks(his_scan, out, "--resume")
    assert all("block 0 already complete" in err for err in errs)
    np.testing.assert_array_equal(
        ddbvf.read_volume(str(out / "v.ddbvf")),
        _single(his_scan, tmp_path / "ref", "fast"))


@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_world1_job_drains_in_slabs_like_run_job(group, his_scan, tmp_path,
                                                 monkeypatch, accuracy):
    """run_job_distributed over the world-1 gloo group, every rank's slab
    drained in slabs of 5 slices (which divide no block): byte for byte
    the single-process run_job, every block in the manifest and a drain
    split in the log per block."""
    from paris_tpu_torch.benchmarks.full_scale_2048_3600 import job_log_tap
    from paris_tpu_torch.io import drain as drain_mod
    from paris_tpu_torch.parallel.app import run_job_distributed
    vol = derive_volume_geometry(HIS_DET)
    monkeypatch.setattr(drain_mod, "SLAB_BYTES",
                        5 * 4 * vol.dim_y * vol.dim_x)
    with job_log_tap() as tap:
        out = run_job_distributed(ReconstructionJob(
            det=HIS_DET, input_path=his_scan[0],
            output_path=str(tmp_path / "dist"), prefix="v", chunk_size=8,
            backend="torch", accuracy=accuracy, block_dz=32))
    single = run_job(ReconstructionJob(
        det=HIS_DET, input_path=his_scan[0], output_path=str(tmp_path / "one"),
        prefix="v", chunk_size=8, backend="torch", accuracy=accuracy,
        block_dz=32))
    with open(out, "rb") as f, open(single, "rb") as g:
        assert f.read() == g.read()
    assert json.load(open(out + ".manifest.json"))["completed_blocks"] == \
        [0, 1]
    assert [(d["block"], d["slabs"], d["slab_slices"]) for d in tap.drain] \
        == [(0, 7, 5), (1, 7, 5)]
