"""The job's z-block plan on the card (``app.card_block_dz``, used by
``plan_job`` and the distributed job), the resume manifest's recorded
extent, and the plan sweep's runners, on the CPU.

The rule is a pure function of the volume, the free-memory estimate and
the stream's bytes and frames, so its plans for a card are checked here
with the card's free memory given (``_free_hbm_bytes`` patched) and a
file table that only lists chunks.  The jobs run on the CPU at forced
extents: a plan changes where the seams fall, never a voxel."""

import dataclasses
import json
import logging
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from paris_tpu.app import ReconstructionJob as JaxJob, run_job as jax_run_job
from paris_tpu import geometry as jax_geometry
from paris_tpu_torch import app
from paris_tpu_torch.app import (ReconstructionJob, card_block_dz, plan_job,
                                 predicted_job_seconds, run_job)
from paris_tpu_torch.benchmarks import full_scale_2048 as fs
from paris_tpu_torch.benchmarks import plan_sweep
from paris_tpu_torch.benchmarks.config3_stream import geometry as c3_geometry
from paris_tpu_torch.benchmarks.synth_c5_3600 import config5
from paris_tpu_torch.exceptions import StageConstructionError
from paris_tpu_torch.geometry import (DetectorGeometry, derive_volume_geometry,
                                      plan_z_blocks)
from paris_tpu_torch.io import ddbvf
from paris_tpu_torch.io.his import write_his
from paris_tpu_torch.io.sink import VolumeSink
from paris_tpu_torch.parallel.app import run_job_distributed
from paris_tpu_torch.phantom import cone_beam_project

CARD_FREE = 79 * 10**9           # an 80 GB card's free memory
CUDA = torch.device("cuda")      # a device of the card's type (no card)
DET = DetectorGeometry(48, 48, 2.0, 2.0, 0.0, 0.0, 300.0, 300.0, 360.0 / 24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the rule

def _table(n_proj, dtype):
    """A file table of ``n_proj`` frames of ``dtype``: what ``plan_job``
    reads of a source (its chunks' frames and raw type)."""
    def chunk_reads(chunk, n_threads=None):
        return [types.SimpleNamespace(dtype=np.dtype(dtype),
                                      rows=min(chunk, n_proj - i))
                for i in range(0, n_proj, chunk)]
    return types.SimpleNamespace(chunk_reads=chunk_reads)


def _card_plan(monkeypatch, caplog, det, n_proj, dtype, chunk, *,
               free=CARD_FREE, device=CUDA, rule=True, **kw):
    """``plan_job`` for a card with ``free`` bytes free (``rule=False``:
    with the card's rule taken out, which is the plan before it); returns
    (plan, its "block plan" log line)."""
    monkeypatch.setattr(app, "_free_hbm_bytes",
                        lambda d: free if d.type == "cuda" else None)
    if not rule:
        monkeypatch.setattr(app, "card_block_dz",
                            lambda *a, **k: (None, "taken out"))
    job = ReconstructionJob(det=det, input_path="unused", output_path="unused",
                            chunk_size=chunk, backend="torch",
                            max_cache_bytes=1 << 40, **kw)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        plan = plan_job(job, derive_volume_geometry(det), device,
                        _table(n_proj, dtype))
    (line,) = [m for m in caplog.messages if m.startswith("block plan")]
    return plan, line


def test_config5_3600_u16_splits_on_an_80gb_card(monkeypatch, caplog):
    """Config 5 (2048 x 2048 x 2055) from 3600 uint16 frames, chunk 8: more
    than one block, the write overlap on and the stream kept on the card;
    before the rule the same card planned one 2056-slice block."""
    plan, line = _card_plan(monkeypatch, caplog, config5(3600), 3600,
                            np.uint16, 8)
    assert plan.info.num > 1 and plan.overlap and plan.cache == "card"
    assert plan.cache_bytes == 3600 * 2 * 2048 * 2048
    assert plan.info.dim_z_padded % 8 == 0 and plan.info.dim_z_padded >= 128
    assert line.startswith(f"block plan: {plan.info.num} blocks of "
                           f"{plan.info.dim_z_padded} slices, predicted")
    before, _ = _card_plan(monkeypatch, caplog, config5(3600), 3600,
                           np.uint16, 8, rule=False)
    assert (before.info.num, before.info.dim_z_padded) == (1, 2056)
    assert before.cache == "off"


def test_config3_stream_splits_in_two(monkeypatch, caplog):
    """config3_stream's job (1024^3 from 360 float32 frames, chunk 16)
    and the same geometry at 3600 frames: two blocks of 512, the sweep's
    fastest count at 3600 frames."""
    for n in (360, 3600):
        plan, _ = _card_plan(monkeypatch, caplog, c3_geometry(1024, n), n,
                             np.float32, 16)
        assert (plan.info.num, plan.info.dim_z_padded) == (2, 512)
        assert plan.overlap and plan.cache == "card"


def test_stream_too_large_for_the_card_keeps_todays_plan(monkeypatch,
                                                         caplog):
    """No split fits two accumulators beside a 9000-frame float32 stream
    (151 GB): the plan is the one before the rule, and says why."""
    args = (config5(9000), 9000, np.float32, 8)
    plan, line = _card_plan(monkeypatch, caplog, *args)
    before, _ = _card_plan(monkeypatch, caplog, *args, rule=False)
    assert plan == before and plan.info.num == 1
    assert line.startswith("block plan: the memory rule (no split")


@pytest.mark.parametrize("how", ["block_dz", "budget", "overlap_off",
                                 "no_cache"])
def test_forced_plans_are_todays(monkeypatch, caplog, how):
    """A forced extent, a device-memory budget (--hbm-budget-gb),
    PARIS_WRITE_OVERLAP=0 or cache_projections=False: the plan the job
    took before the rule (test_torch_band.py holds the overlap switch's
    own plan), and the line names the reason."""
    kw, reason = {
        "block_dz": (dict(block_dz=344), "the job's block_dz"),
        "budget": (dict(hbm_budget_bytes=20 << 30),
                   "the memory rule (the job's device-memory budget)"),
        "overlap_off": ({}, "the memory rule (PARIS_WRITE_OVERLAP=0)"),
        "no_cache": (dict(cache_projections=False),
                     "the memory rule (cache_projections=False)"),
    }[how]
    if how == "overlap_off":
        monkeypatch.setenv("PARIS_WRITE_OVERLAP", "0")
    args = (config5(3600), 3600, np.uint16, 8)
    plan, line = _card_plan(monkeypatch, caplog, *args, **kw)
    before, _ = _card_plan(monkeypatch, caplog, *args, rule=False, **kw)
    assert plan == before
    assert line == f"block plan: {reason}"
    if how == "block_dz":
        assert plan.info.num == 6
    if how == "budget":              # the budget's blocks, cut for overlap
        assert plan.info.num > plan_z_blocks(
            derive_volume_geometry(config5(3600)),
            hbm_budget_bytes=20 << 30,
            proj_buffer_bytes=4 * 4 * 2048 * 2048 * 8).num > 1


def test_off_the_card_one_block(monkeypatch, caplog):
    """On the CPU the rule does not run: one block, as before."""
    def never(*a, **k):
        raise AssertionError("the card's rule ran off the card")
    monkeypatch.setattr(app, "card_block_dz", never)
    plan, line = _card_plan(monkeypatch, caplog, config5(3600), 3600,
                            np.uint16, 8, device=torch.device("cpu"))
    assert plan.info.num == 1 and plan.hbm_budget is None
    assert line == "block plan: the memory rule (off the card)"


def _rule(det, n_proj, itemsize, chunk, **kw):
    vol = derive_volume_geometry(det)
    px = det.n_row * det.n_col
    kw.setdefault("free_est", int(CARD_FREE * 0.95))
    kw.setdefault("proj_buffer", 4 * 4 * px * chunk)
    return card_block_dz(
        vol, stream_card_bytes=-(-n_proj // chunk) * chunk * px * itemsize,
        stream_host_bytes=n_proj * px * itemsize, n_proj=n_proj,
        frame_pixels=px, **kw)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_distributed_extent_is_aligned_to_8_per_rank(world):
    """Each rank holds 1/world of a block: the extent is a multiple of 8 x
    world slices, and every split it takes fits the ranks' memory."""
    dz, why = _rule(config5(3600), 3600, 2, 8 * world, n_shards=world,
                    align=8 * world)
    assert dz is not None and dz % (8 * world) == 0, why
    assert dz >= app.MIN_SPLIT_DZ


def test_rule_caps_the_extent_at_the_budget():
    """The budget's largest extent caps the split: nothing above it."""
    free_dz, _ = _rule(config5(1000), 1000, 2, 8)
    dz, _ = _rule(config5(1000), 1000, 2, 8, budget_dz=free_dz - 8)
    assert dz == free_dz - 8


def test_rule_needs_room_for_the_cache_and_two_accumulators():
    """Config 5 from 3600 float32 frames (60.4 GB of stream): split where
    the card holds both, never on a card that holds the stream alone."""
    dz, _ = _rule(config5(3600), 3600, 4, 8)
    assert dz is not None
    vol = derive_volume_geometry(config5(3600))
    room = (int(CARD_FREE * 0.95) - 4 * 4 * 2048 * 2048 * 8
            - 3600 * 4 * 2048 * 2048 - app.CARD_CACHE_MARGIN)
    assert 2 * 4 * dz * vol.dim_y * vol.dim_x <= room
    dz, why = _rule(config5(3600), 3600, 4, 8, free_est=62 * 10**9)
    assert dz is None and why.startswith("no split")


def test_model_orders_the_sweeps_counts():
    """predicted_job_seconds at config 3 from 3600 frames orders the block
    counts as the sweep measured them (PERF.md section 6, PR 12): 2, 1, 4,
    8 (6.63-6.85, 7.00-7.20, 7.48-8.35 and 8.23 s)."""
    vol = derive_volume_geometry(c3_geometry(1024, 3600))
    t = {k: predicted_job_seconds(
        k, updates=vol.voxels * 3600, volume_bytes=vol.nbytes_f32,
        read_bytes=3600 * 4 * 1024 ** 2, pixels=3600 * 1024 ** 2)
        for k in (1, 2, 4, 8)}
    assert t[2] < t[1] < t[4] < t[8]


# ------------------------------------------------- plans and the voxels

@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("plan")
    vol = derive_volume_geometry(DET)
    angles = np.arange(24, dtype=np.float32) * DET.delta_phi
    projs = cone_beam_project(DET, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.9)
    pdir = root / "proj"
    pdir.mkdir()
    for i in range(0, 24, 8):
        write_his(str(pdir / f"b{i:03d}.his"), projs[i:i + 8],
                  number_dtype=np.float32)
    return str(pdir)


def _job(pdir, out, **kw):
    kw.setdefault("accuracy", "exact")
    return ReconstructionJob(det=DET, input_path=pdir, output_path=str(out),
                             chunk_size=8, backend="torch", **kw)


@pytest.mark.parametrize("accuracy", ["fast", "exact"])
def test_split_plan_writes_the_one_block_plans_bytes(scan, tmp_path,
                                                     accuracy):
    """The port's job at a split extent (3 blocks of 16) and at one block:
    the same ddbvf byte for byte; and within 1e-4 of the JAX package's job
    at one block (exact), the parity tests' tolerance."""
    one = run_job(_job(scan, tmp_path / "one", accuracy=accuracy))
    split = run_job(_job(scan, tmp_path / "split", accuracy=accuracy,
                         block_dz=16))
    with open(one, "rb") as a, open(split, "rb") as b:
        assert a.read() == b.read()
    if accuracy == "exact":
        jax_det = jax_geometry.DetectorGeometry(**dataclasses.asdict(DET))
        ref = ddbvf.read_volume(jax_run_job(JaxJob(
            det=jax_det, input_path=scan, output_path=str(tmp_path / "jax"),
            chunk_size=8, backend="xla", accuracy="exact")))
        got = ddbvf.read_volume(split)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


# ---------------------------------------------- resume keeps its plan

def _manifest(out):
    with open(out + ".manifest.json") as f:
        return json.load(f)


def test_resume_takes_the_recorded_extent(scan, tmp_path, caplog):
    """A job stopped after one block of 16 and resumed with no extent
    forced (whose own plan is one block) finishes the 16-slice plan: the
    volume of an uninterrupted run, byte for byte."""
    out = run_job(_job(scan, tmp_path, block_dz=16, max_blocks=1))
    assert _manifest(out) == {"dims": [48, 48, 48], "completed_blocks": [0],
                              "block_dz": 16}
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        run_job(_job(scan, tmp_path, resume=True))
    assert "resume: blocks of 16 slices, as the output's manifest records" \
        in caplog.messages
    assert any("z-split: 3 block(s) of 16 slices" in m
               for m in caplog.messages)
    assert _manifest(out)["completed_blocks"] == [0, 1, 2]
    whole = run_job(_job(scan, tmp_path / "whole"))
    np.testing.assert_array_equal(ddbvf.read_volume(out),
                                  ddbvf.read_volume(whole))


def test_resume_refuses_another_forced_extent(scan, tmp_path):
    """A forced extent that plans to other blocks than the recorded ones
    is a construction error, and writes nothing; the recorded one
    resumes."""
    out = run_job(_job(scan, tmp_path, block_dz=16, max_blocks=1))
    before = _manifest(out)
    with pytest.raises(StageConstructionError, match="records blocks of 16"):
        run_job(_job(scan, tmp_path, resume=True, block_dz=24))
    assert _manifest(out) == before
    run_job(_job(scan, tmp_path, resume=True, block_dz=16))
    assert _manifest(out)["completed_blocks"] == [0, 1, 2]


def test_resume_of_a_manifest_without_an_extent(scan, tmp_path):
    """A manifest written before extents were recorded resumes as before
    (the job's own extent, here forced to the writer's), and records the
    extent from then on."""
    out = run_job(_job(scan, tmp_path, block_dz=16, max_blocks=1))
    with open(out + ".manifest.json", "w") as f:
        json.dump({"dims": [48, 48, 48], "completed_blocks": [0]}, f)
    run_job(_job(scan, tmp_path, resume=True, block_dz=16))
    assert _manifest(out) == {"dims": [48, 48, 48],
                              "completed_blocks": [0, 1, 2], "block_dz": 16}
    whole = run_job(_job(scan, tmp_path / "whole"))
    np.testing.assert_array_equal(ddbvf.read_volume(out),
                                  ddbvf.read_volume(whole))


def test_sink_records_and_checks_the_extent(tmp_path):
    """The sink writes the extent it is given, reads it back on resume
    and in ``attach`` and ``recorded_block_dz``, and refuses to resume at
    another; given none, it keeps what the manifest records."""
    sink = VolumeSink(str(tmp_path), "v", 3, 4, 6, block_dz=2)
    sink.mark_done(0)
    assert VolumeSink.recorded_block_dz(str(tmp_path), "v", 3, 4, 6) == 2
    assert VolumeSink.recorded_block_dz(str(tmp_path), "v", 3, 4, 7) is None
    assert VolumeSink.recorded_block_dz(str(tmp_path), "w", 3, 4, 6) is None
    attached = VolumeSink.attach(str(tmp_path), "v", 3, 4, 6)
    assert attached.block_dz == 2 and attached.completed_blocks == {0}
    again = VolumeSink(str(tmp_path), "v", 3, 4, 6, resume=True)
    assert again.block_dz == 2 and again.is_done(0)
    with pytest.raises(ValueError, match="records blocks of 2"):
        VolumeSink(str(tmp_path), "v", 3, 4, 6, resume=True, block_dz=4)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-1 gloo group for the distributed job."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_distributed_resume_takes_the_recorded_extent(group, scan, tmp_path,
                                                      caplog):
    """The distributed job records its extent (rank 0's sink; a rank that
    attaches reads it), and a resume with none forced takes it: the volume
    of the single-process job at that extent, byte for byte; another
    forced extent is refused."""
    out = run_job_distributed(_job(scan, tmp_path, block_dz=16,
                                   max_blocks=1))
    assert _manifest(out)["block_dz"] == 16
    assert VolumeSink.attach(str(tmp_path), "vol", 48, 48, 48).block_dz == 16
    with pytest.raises(StageConstructionError, match="records blocks of 16"):
        run_job_distributed(_job(scan, tmp_path, resume=True, block_dz=32))
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        run_job_distributed(_job(scan, tmp_path, resume=True))
    assert "resume: blocks of 16 slices, as the output's manifest records" \
        in caplog.messages
    assert _manifest(out)["completed_blocks"] == [0, 1, 2]
    single = run_job(_job(scan, tmp_path / "single", block_dz=16))
    np.testing.assert_array_equal(ddbvf.read_volume(out),
                                  ddbvf.read_volume(single))


# ------------------------------------------------------- the sweep tools

@pytest.mark.parametrize("dim_z, k, want", [(1024, 1, 1024), (1024, 2, 512),
                                             (1024, 8, 128), (2055, 6, 344),
                                             (2055, 8, 264), (20, 3, 8)])
def test_extent_for(dim_z, k, want):
    assert app.extent_for(dim_z, k) == want


def test_cache_place():
    assert plan_sweep.cache_place(
        ["projection cache: on the card, 5 bytes (9 bytes ...)"]) == "card"
    assert plan_sweep.cache_place(
        ["projection cache: on the host, 5 bytes"]) == "host"
    assert plan_sweep.cache_place(["projection cache: off (one block)"]) \
        == "off"


def test_dirty_sampler_peaks(tmp_path, monkeypatch):
    """Dirty + Writeback from the meminfo file, its peak over a window;
    None where the host does not report them."""
    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal: 100 kB\nDirty: 7 kB\nWriteback: 5 kB\n")
    monkeypatch.setattr(plan_sweep, "MEMINFO", str(meminfo))
    with plan_sweep.DirtySampler(period=0.01) as s:
        pass
    assert s.peak() == 12 * 1024 and s.peak(t1=0.0) is None
    meminfo.write_text("MemTotal: 100 kB\n")
    with plan_sweep.DirtySampler(period=0.01) as s:
        pass
    assert s.samples == [] and s.peak() is None


def test_plan_sweep_runner(tmp_path):
    """The sweep at a 32^2 detector, 16 frames, blocks 1 2 4 1 in fast
    mode: one record per job in order, each with its plan, splits per
    block, cache place, K1 launches (0 off the card) and the same volume
    as the first job."""
    res = plan_sweep.main(["--size", "32", "--n-proj", "16", "--blocks",
                           "1", "2", "4", "1", "--accuracy", "fast",
                           "--backend", "torch", "--workdir",
                           str(tmp_path / "w"), "--out",
                           str(tmp_path / "r.json")])
    assert [r["k"] for r in res["runs"]] == ["1", "2", "4", "1"]
    assert [r["blocks"] for r in res["runs"]] == [1, 2, 4, 1]
    for r in res["runs"]:
        assert len(r["ingest"]) == len(r["drain"]) == r["blocks"]
        assert r["plan"][0].startswith(f"z-split: {r['blocks']} block(s)")
        assert r["cache"] == ("off" if r["blocks"] == 1 else "host")
        assert r["k1_launches"] == 0 and r["max_abs_diff_vs_first"] == 0.0
    assert json.load(open(tmp_path / "r.json"))[0]["name"] \
        == "plan_sweep_32_16proj"
    assert not any(n.endswith(".ddbvf") for n in os.listdir(tmp_path / "w"))


def test_full_scale_runner_at_two_extents(tmp_path):
    """The config-5 runner on a uint16 scan at a 48^2 detector, at its own
    plan and at a forced extent: the plan and the splits per block
    recorded, the gate held, and the slices either side of every seam the
    same bytes under both plans."""
    recs = {dz: fs.run(str(tmp_path), accuracy="fast", n_proj=24, det=DET,
                       backend="torch", golden_shards=2,
                       number_type="uint16", block_dz=dz)
            for dz in (None, 16)}
    assert [recs[dz]["planned_blocks"] for dz in (None, 16)] == [1, 3]
    for dz, r in recs.items():
        assert r["pass"] and r["block_dz_given"] == dz
        assert len(r["per_block_ingest"]) == r["planned_blocks"]
        assert len(r["per_block_drain"]) == r["planned_blocks"]
        assert r["cache"] == ("off" if dz is None else "host")
    assert recs[None]["slice_digests"] == recs[16]["slice_digests"]
    assert set(recs[16]["slice_digests"]) == {
        str(z) for z in fs.digest_slices(48)}
