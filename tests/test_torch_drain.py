"""The output drain (``paris_tpu_torch/io/drain.py``) on the CPU: a block
written slab by slab is byte for byte the ddbvf that the port's
``ddbvf.write_slices`` and the JAX package's ``VolumeSink.write_block``
write for it; the job drains every block through it, byte for byte the
parent's ``finalize`` + ``write_block`` composition and within 1e-5 of
the JAX package's job; a pwrite that fails mid-block leaves the block
out of the manifest, and a resumed run rewrites it whole.  The card's
side (the pinned ring, the copy stream, the accumulator's lifetime) is
in tests/test_torch_cuda.py; the distributed job's in
tests/test_torch_distributed.py.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from paris_tpu.app import ReconstructionJob as JaxJob, run_job as jax_run_job
from paris_tpu.geometry import DetectorGeometry as JaxDetectorGeometry
from paris_tpu.geometry import RegionOfInterest as JaxRoi
from paris_tpu.io.sink import VolumeSink as JaxSink
from paris_tpu_torch import app
from paris_tpu_torch.app import ReconstructionJob, run_job
from paris_tpu_torch.benchmarks.full_scale_2048_3600 import job_log_tap
from paris_tpu_torch.exceptions import StageRuntimeError
from paris_tpu_torch.geometry import (DetectorGeometry, RegionOfInterest,
                                      apply_roi, derive_volume_geometry,
                                      plan_z_blocks)
from paris_tpu_torch.io import ddbvf, drain as drain_mod, native
from paris_tpu_torch.io.drain import BlockDrain, slab_slices
from paris_tpu_torch.io.his import write_his
from paris_tpu_torch.utils.logging import StageTimers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def io_path(request, monkeypatch):
    """The block drains through the native writer and the Python one."""
    if not request.param:
        monkeypatch.setenv("PARIS_IO_NO_NATIVE", "1")
    else:
        assert native.available()
    return request.param


DET = DetectorGeometry(40, 48, 2.0, 2.0, 0.0, 0.0, 300.0, 300.0, 7.5)
ROI = RegionOfInterest(3, 30, 5, 27, 4, 28)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# (accumulator (dz, ny, nx), valid slices, global z0, the file's slices,
# slices per slab)
BLOCKS = {
    "slab_not_dividing_dim_z": ((24, 6, 5), 24, 3, 40, 5),
    "tail_block": ((24, 6, 5), 17, 23, 40, 5),
    "thinner_than_a_slab": ((4, 6, 5), 3, 10, 40, 8),
    "roi_volume": None,
}


def _block(name):
    if name != "roi_volume":
        return BLOCKS[name]
    vol = apply_roi(derive_volume_geometry(DET), ROI)
    # the ROI's second block of 16 slices, its tail (24 slices in all)
    return ((16, vol.dim_y, vol.dim_x), vol.dim_z - 16, 16, vol.dim_z, 6)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_drain_writes_the_bytes_of_write_slices_and_the_jax_sink(
        tmp_path, monkeypatch, io_path, name):
    """One block drained slab by slab: the ddbvf is byte for byte the one
    ``write_slices`` of its valid slices writes, and the one the JAX
    package's ``VolumeSink.write_block`` writes; one pwrite per slab."""
    shape, dim_z, z0, file_z, slices = _block(name)
    dz, ny, nx = shape
    volume = np.random.default_rng(dz + dim_z).standard_normal(shape).astype(
        np.float32)
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", slices * 4 * ny * nx)
    drain = BlockDrain("cpu", (ny, nx), dz)
    assert drain.slices == min(slices, dz)
    assert drain.pinned_bytes == 0
    port = ddbvf.create(str(tmp_path / "port.ddbvf"), nx, ny, file_z)
    split = StageTimers()
    n = drain.drain(torch.from_numpy(volume), port, z0, dim_z, split=split)
    assert n == min(dim_z, dz)
    assert split.counts["write"] == -(-n // drain.slices)
    ref = ddbvf.create(str(tmp_path / "ref.ddbvf"), nx, ny, file_z)
    ddbvf.write_slices(ref, volume[:dim_z], z0)
    jax = JaxSink(str(tmp_path / "jax"), "v", nx, ny, file_z)
    jax.write_block(0, volume[:dim_z], z0)
    assert _read(port) == _read(ref) == _read(jax.path)


@pytest.mark.parametrize("slice_bytes,max_slices,slab_bytes,want", [
    (4 << 20, 1024, 128 << 20, 32),     # a 1024^2 slice
    (16 << 20, 344, 128 << 20, 8),      # config 5's 2048^2 slice
    (16 << 20, 344, 8 << 20, 1),        # a slice larger than the target
    (100, 7, 1 << 20, 7),               # a block thinner than a slab
])
def test_slab_slices(slice_bytes, max_slices, slab_bytes, want):
    assert slab_slices(slice_bytes, max_slices, slab_bytes) == want


def test_drain_refuses_another_slice_shape(tmp_path):
    drain = BlockDrain("cpu", (6, 5), 8)
    with pytest.raises(ValueError, match="not the drain's"):
        drain.drain(torch.zeros(8, 5, 6), str(tmp_path / "x.ddbvf"), 0, 8)


# ------------------------------------------------------------ the job

@pytest.fixture(scope="module")
def u16_scan(tmp_path_factory):
    """48 uint16 frames of a phantom (files of 8) on a 40 x 48 detector."""
    from paris_tpu_torch.phantom import cone_beam_project
    d = tmp_path_factory.mktemp("u16scan")
    angles = np.arange(48, dtype=np.float32) * DET.delta_phi
    vol = derive_volume_geometry(DET)
    projs = cone_beam_project(DET, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.9)
    counts = np.rint(projs / projs.max() * 60000).astype(np.uint16)
    for i in range(0, 48, 8):
        write_his(str(d / f"b{i:03d}.his"), counts[i:i + 8],
                  number_dtype=np.uint16)
    return str(d)


BLOCK_DZ = 16      # the ROI's 25 slices: a block of 16 and a tail of 9
SLAB = 5           # slices per slab: divides neither block


def _slab_of(slices):
    """SLAB_BYTES for ``slices`` slices of the ROI volume."""
    vol = apply_roi(derive_volume_geometry(DET), ROI)
    return slices * 4 * vol.dim_y * vol.dim_x


def _job(u16_scan, out, **kw):
    """The ROI job, in two blocks."""
    kw.setdefault("accuracy", "exact")
    return ReconstructionJob(det=DET, input_path=u16_scan,
                             output_path=str(out), prefix="v", chunk_size=8,
                             backend="torch", block_dz=BLOCK_DZ, roi=ROI,
                             **kw)


class _ParentDrain(BlockDrain):
    """The drain before the slab ring: ``Reconstructor.finalize`` (one
    ``.cpu()`` of the accumulator) and ``VolumeSink.write_block``'s
    ``write_slices`` of its valid slices."""

    def drain(self, volume, path, z0, dim_z, ready=None, split=None):
        out = volume.cpu().numpy()
        ddbvf.write_slices(path, out[:dim_z], z0)
        return dim_z


@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_job_drains_every_block_like_the_parents_composition(
        u16_scan, tmp_path, monkeypatch, accuracy):
    """A two-block ROI job (the second a tail block) drained in slabs of 5
    slices, which divide neither block: byte for byte the job whose blocks go
    through ``finalize`` + ``write_block``; every block in the manifest
    and a drain split in the log per block."""
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", _slab_of(SLAB))
    with job_log_tap() as tap:
        out = run_job(_job(u16_scan, tmp_path / "slabs", accuracy=accuracy))
    monkeypatch.setattr(app, "BlockDrain", _ParentDrain)
    ref = run_job(_job(u16_scan, tmp_path / "parent", accuracy=accuracy))
    assert _read(out) == _read(ref)
    info = plan_z_blocks(apply_roi(derive_volume_geometry(DET), ROI),
                         block_dz=BLOCK_DZ)
    sizes = [b.dim_z for b in info.blocks]
    assert sizes == [16, 9] and info.dim_z_padded == 16
    assert json.load(open(out + ".manifest.json"))["completed_blocks"] == \
        [0, 1]
    assert [d["block"] for d in tap.drain] == [0, 1]
    assert [d["slabs"] for d in tap.drain] == [-(-n // SLAB) for n in sizes]
    assert all(d["slab_slices"] == SLAB and d["pinned_bytes"] == 0
               and d["d2h_s"] == 0 and d["wait_s"] == 0 and d["write_s"] > 0
               for d in tap.drain)


def test_job_against_the_jax_job(u16_scan, tmp_path, monkeypatch):
    """The slab-drained two-block ROI job against the JAX package's run_job
    on CPU JAX (exact): relative RMSE <= 1e-5, the tolerance of
    tests/test_torch_ingest.py::test_u16_scan_job_against_the_jax_job."""
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", _slab_of(SLAB))
    port = ddbvf.read_volume(run_job(_job(u16_scan, tmp_path / "port")))
    ref = ddbvf.read_volume(jax_run_job(JaxJob(
        det=JaxDetectorGeometry(**dataclasses.asdict(DET)),
        input_path=u16_scan, output_path=str(tmp_path / "jax"), prefix="v",
        chunk_size=8, backend="xla", accuracy="exact", block_dz=BLOCK_DZ,
        roi=JaxRoi(**dataclasses.asdict(ROI)))))
    assert port.shape == ref.shape and np.abs(ref).max() > 0
    rmse = np.sqrt(np.mean((port.astype(np.float64) - ref) ** 2))
    assert rmse <= 1e-5 * np.abs(ref).max()


# block 0 drains in slabs at z 0, 5, 10, 15; block 1 (the tail) at 16, 21
@pytest.mark.parametrize("fail_call,done", [(2, []), (5, [0])],
                         ids=["block0_third_slab", "block1_second_slab"])
def test_failed_pwrite_leaves_the_block_to_resume(u16_scan, tmp_path,
                                                  monkeypatch, fail_call,
                                                  done):
    """A pwrite that fails at a slab raises StageRuntimeError from run_job
    and leaves that block out of the manifest (the blocks drained before
    it are in it; block 0's drain fails while block 1 reconstructs, block
    1's is the last thing the job waits for); a resume=True run skips
    the blocks in it, rewrites the failed one whole and completes the file
    byte for byte the uninterrupted run's."""
    monkeypatch.setattr(drain_mod, "SLAB_BYTES", _slab_of(SLAB))
    whole = run_job(_job(u16_scan, tmp_path / "whole"))
    real = ddbvf.write_slices
    calls = []

    def failing(path, volume, first):
        calls.append(first)
        if len(calls) == fail_call + 1:
            raise OSError(28, "No space left on device")
        real(path, volume, first)
    monkeypatch.setattr(ddbvf, "write_slices", failing)
    with pytest.raises(StageRuntimeError, match="No space left"):
        run_job(_job(u16_scan, tmp_path / "cut"))
    out = str(tmp_path / "cut" / "v.ddbvf")
    assert json.load(open(out + ".manifest.json"))["completed_blocks"] == done
    assert calls == [0, 5, 10, 15, 16, 21][:fail_call + 1]
    monkeypatch.setattr(ddbvf, "write_slices", real)
    with job_log_tap() as tap:
        run_job(_job(u16_scan, tmp_path / "cut", resume=True))
    assert [d["block"] for d in tap.drain] == [b for b in (0, 1)
                                               if b not in done]
    assert json.load(open(out + ".manifest.json"))["completed_blocks"] == \
        [0, 1]
    assert _read(out) == _read(whole)


def test_traced_job_holds_each_blocks_drain_wait(u16_scan, tmp_path):
    """A traced two-block job: one Chrome trace per block, each holding
    one "drain_wait" range (the wait for the previous block's drain,
    which the block's trace covers after its reconstruct stage)."""
    trace_dir = tmp_path / "trace"
    run_job(_job(u16_scan, tmp_path / "out", trace_dir=str(trace_dir)))
    names = sorted(trace_dir.iterdir())
    assert len(names) == 2
    for name in names:
        events = json.load(open(name))["traceEvents"]
        waits = [e for e in events if e.get("name") == "drain_wait"
                 and e.get("ph") == "X"
                 and str(e.get("cat", "")).lower() == "user_annotation"]
        assert len(waits) == 1
