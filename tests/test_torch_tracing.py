"""The port's tracer (``paris_tpu_torch/utils/profiling.py``) on the CPU:
with no profiler running a span only feeds its ``StageTimers`` (no
``record_function``, no event, no record); under a profiler the spans
nest, their self times hold, and a new session starts the record afresh;
a profiled job puts every span of its path into its Chrome trace, all
under one job id; the counters count the HIS bytes read and the ddbvf
bytes written; the job's log lines keep the templates the benchmark's
log reader reads.  The card's side (device-timed spans against the
kernels' own times) is in tests/test_torch_cuda.py."""

import json
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paris_tpu_torch.app import ReconstructionJob, run_job
from paris_tpu_torch.geometry import (DetectorGeometry, RegionOfInterest,
                                      apply_roi, derive_volume_geometry)
from paris_tpu_torch.io.his import write_his
from paris_tpu_torch.utils import profiling
from paris_tpu_torch.utils.logging import StageTimers
from paris_tpu_torch.utils.profiling import span

DET = DetectorGeometry(40, 48, 2.0, 2.0, 0.0, 0.0, 300.0, 300.0, 7.5)
ROI = RegionOfInterest(3, 30, 5, 27, 4, 28)
N_PROJ, PER_FILE, CHUNK, BLOCK_DZ = 48, 8, 8, 16
# the spans of a job's path on the CPU (the card adds "h2d",
# "card_wait", "d2h" and "copy_wait")
JOB_SPANS = {"job", "job_setup", "block", "read", "stage_wait", "step",
             "step.prep", "step.filter", "step.k1", "drain_wait", "drain",
             "write"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiler():
    """A CPU profiler session over every thread, as ``trace()`` and the
    benchmark start one."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _no_tracer(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a span entered record_function or made a "
                             "CUDA event with no profiler running")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)


def test_span_without_a_profiler_only_feeds_its_timers(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    _no_tracer(monkeypatch)
    before = profiling.records()
    timers = StageTimers()
    with span("outer", timers=timers, device=True) as outer:
        with span("inner", timers=timers, device=True):
            time.sleep(0.01)
        with span("inner", timers=timers):
            pass
    assert outer.device_seconds() is None
    assert timers.counts == {"outer": 1, "inner": 2}
    assert timers.totals["outer"] >= timers.totals["inner"] >= 0.01
    assert profiling.records() == before


@pytest.fixture(scope="module")
def u16_scan(tmp_path_factory):
    """48 uint16 frames of a phantom (files of 8) on a 40 x 48 detector."""
    from paris_tpu_torch.phantom import cone_beam_project
    d = tmp_path_factory.mktemp("u16scan")
    angles = np.arange(N_PROJ, dtype=np.float32) * DET.delta_phi
    vol = derive_volume_geometry(DET)
    projs = cone_beam_project(DET, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.9)
    counts = np.rint(projs / projs.max() * 60000).astype(np.uint16)
    for i in range(0, N_PROJ, PER_FILE):
        write_his(str(d / f"b{i:03d}.his"), counts[i:i + PER_FILE],
                  number_dtype=np.uint16)
    return str(d)


def _job(u16_scan, out, **kw):
    """The ROI job in two blocks (16 and 9 slices), every block reading
    the HIS files."""
    return ReconstructionJob(det=DET, input_path=u16_scan,
                             output_path=str(out), prefix="v",
                             chunk_size=CHUNK, backend="torch",
                             block_dz=BLOCK_DZ, roi=ROI, accuracy="fast",
                             cache_projections=False, **kw)


def test_job_without_a_profiler_enters_no_record_function(u16_scan, tmp_path,
                                                          monkeypatch):
    _no_tracer(monkeypatch)
    before = profiling.records()
    run_job(_job(u16_scan, tmp_path))
    assert profiling.records() == before


def test_spans_nest_and_their_self_times_hold():
    with _profiler():
        with span("outer"):
            time.sleep(0.02)
            with span("inner"):
                time.sleep(0.03)
                with span("leaf"):
                    time.sleep(0.01)
            with span("inner"):
                pass
    parents = {(r["name"], r["parent"]) for r in profiling.records()}
    assert parents == {("outer", None), ("inner", "outer"),
                       ("leaf", "inner")}
    got = profiling.collected()["spans"]
    assert set(got) == {"outer", "inner", "leaf"}
    outer, inner, leaf = got["outer"], got["inner"], got["leaf"]
    assert (outer["count"], inner["count"], leaf["count"]) == (1, 2, 1)
    assert outer["self_host_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_host_s"] == pytest.approx(
        inner["host_s"] - leaf["host_s"], abs=1e-9)
    assert leaf["self_host_s"] == leaf["host_s"] >= 0.01
    assert outer["self_host_s"] >= 0.02 and inner["self_host_s"] >= 0.03
    assert outer["device_s"] is None


def test_a_new_session_starts_the_record_afresh(tmp_path):
    with _profiler():
        with span("first"):
            pass
    assert set(profiling.collected()["spans"]) == {"first"}
    with _profiler():
        with span("second"):
            pass
    assert set(profiling.collected()["spans"]) == {"second"}
    with profiling.trace(str(tmp_path)):
        with span("third"):
            pass
    assert set(profiling.collected()["spans"]) == {"third"}
    assert [r["name"] for r in profiling.records()] == ["third"]


def test_spans_of_worker_threads_carry_the_job_id():
    def work():
        with span("worker"):
            pass

    with _profiler():
        with profiling.job() as first:
            t = threading.Thread(target=work, name="paris-test-worker")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with profiling.job() as second:
            with span("after"):
                pass
    assert first != second
    rec = {r["name"]: r for r in profiling.records()}
    assert rec["worker"]["job"] == first and rec["worker"]["parent"] is None
    assert rec["worker"]["thread"] == "paris-test-worker"
    assert rec["after"]["job"] == second and rec["after"]["parent"] == "job"
    with _profiler():
        with span("outside"):
            pass
    assert profiling.records()[0]["job"] is None


def test_counts_are_thread_safe():
    """16 threads, more than the cores, add to one counter with a short
    switch interval: no increment is lost."""
    before = profiling.counters()["steps"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                profiling.count("steps")
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["steps"] - before == 16 * 2000


class _Tap(logging.Handler):
    """The job's log records, unformatted."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture(scope="module")
def profiled_job(u16_scan, tmp_path_factory):
    """One job run inside ``trace()``: its Chrome trace, its span
    records and sums, its log records, and its counters' change."""
    out = tmp_path_factory.mktemp("profiled")
    tap = _Tap()
    log = logging.getLogger("paris_tpu_torch")
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(tap)
    before = profiling.counters()
    try:
        with profiling.trace(str(out / "trace")):
            path = run_job(_job(u16_scan, out))
    finally:
        log.removeHandler(tap)
        log.setLevel(level)
    after = profiling.counters()
    (name,) = os.listdir(out / "trace")
    with open(out / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    return {"path": path, "events": events, "records": profiling.records(),
            "collected": profiling.collected(), "log": tap.records,
            "counted": {k: after[k] - before[k] for k in after}}


def test_profiled_job_puts_every_span_of_its_path_in_its_trace(profiled_job):
    marks = [e["name"] for e in profiled_job["events"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    records = profiled_job["records"]
    assert JOB_SPANS <= set(marks)
    for name in JOB_SPANS:
        assert marks.count(name) == sum(r["name"] == name for r in records)
    jobs = {r["job"] for r in records if r["name"] in JOB_SPANS}
    assert len(jobs) == 1 and None not in jobs
    # the staging workers' and the writer's spans carry it too
    threads = {r["thread"] for r in records}
    assert any(t.startswith("paris-stage") for t in threads)
    assert any(t.startswith("paris-write") for t in threads)
    spans = profiled_job["collected"]["spans"]
    n_chunks = -(-N_PROJ // CHUNK)
    assert spans["block"]["count"] == 2 and spans["job"]["count"] == 1
    assert spans["step"]["count"] == spans["step.k1"]["count"] \
        == spans["read"]["count"] == 2 * n_chunks
    parent = {r["name"]: r["parent"] for r in records}
    assert parent["step.k1"] == parent["step.prep"] == "step"
    assert parent["step"] == "block" and parent["job_setup"] == "job"


def test_counters_count_the_bytes_read_and_written(profiled_job):
    counted = profiled_job["counted"]
    vol = apply_roi(derive_volume_geometry(DET), ROI)
    frame = DET.n_row * DET.n_col * 2                  # uint16
    assert counted["his_bytes_read"] == 2 * N_PROJ * frame   # two blocks
    assert counted["ddbvf_bytes_written"] == \
        4 * vol.dim_x * vol.dim_y * vol.dim_z
    assert os.path.getsize(profiled_job["path"]) >= \
        counted["ddbvf_bytes_written"]
    assert counted["steps"] == 2 * -(-N_PROJ // CHUNK)
    assert counted["h2d_bytes"] == counted["d2h_bytes"] == 0
    assert counted["backproject_chunk_cuda.launches"] == 0
    (line,) = [r for r in profiled_job["log"]
               if r.msg == "job counters: %s"]
    assert f"his_bytes_read {counted['his_bytes_read']}" in line.args[0]
    assert "ddbvf_bytes_written " \
        f"{counted['ddbvf_bytes_written']}" in line.args[0]


def test_ingest_and_drain_lines_keep_what_the_log_reader_reads(profiled_job):
    """The benchmark reads the "block K ingest" and "block K drain"
    records by template and argument position
    (``fdk_bench/drivers/job_loop.job_split``); their numbers are the
    spans' host seconds."""
    from fdk_bench.drivers.job_loop import job_split
    log = profiled_job["log"]
    ingest = [r for r in log if r.msg.startswith("block %d ingest from")]
    drain = [r for r in log if r.msg.startswith("block %d drain: d2h")]
    assert [r.args[0] for r in ingest] == [r.args[0] for r in drain] == [0, 1]
    assert ingest[0].msg == (
        "block %d ingest from the %s: reconstruct %.3f s, read %.3f s (%d "
        "chunks), stage_wait %.3f s, step_enqueue %.3f s (%d steps), "
        "card_wait %.3f s")
    assert drain[0].msg == ("block %d drain: d2h %.3f s, write %.3f s, "
                            "wait %.3f s (%d slabs of %d slices, %d pinned "
                            "bytes)")
    spans = profiled_job["collected"]["spans"]
    split = job_split(log)
    assert split["blocks"] == 2
    assert split["reconstruct"] == pytest.approx(spans["block"]["host_s"])
    assert split["stage_wait"] == pytest.approx(spans["stage_wait"]["host_s"])
    assert split["drain"] == pytest.approx(spans["write"]["host_s"])
    assert sum(r.args[6] for r in ingest) == pytest.approx(
        spans["step"]["host_s"])
    assert sum(r.args[7] for r in ingest) == spans["step"]["count"]
    assert all(r.args[1] == 0.0 for r in drain)     # no card: no d2h
