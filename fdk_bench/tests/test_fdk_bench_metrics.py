"""The metric readers on a canned record and a canned mini Chrome
trace."""

import pytest

from fdk_bench import run as R
from fdk_bench.lib import trace as tr
from fdk_bench.lib.work import k1_pass_least_s


def read(name, record):
    return R.load_module("metric", name).read(record)


TRACE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": "fdk_bench.block_pass",
     "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "h2d", "ts": 100,
     "dur": 300},
    {"ph": "X", "cat": "kernel", "name": "void bp_kernel<float, 8>",
     "ts": 0, "dur": 400},
    {"ph": "X", "cat": "kernel", "name": "fft", "ts": 300, "dur": 200},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700,
     "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "void bp_kernel<float, 8>",
     "ts": 1500, "dur": 100},      # outside the span
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 10},
]}


def test_summary_of_a_mini_trace():
    s = tr.summarize(TRACE, "fdk_bench.block_pass")
    assert s["busy_s"] == pytest.approx(600e-6)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["device_ops"][0] == ["void bp_kernel<float, 8>",
                                  pytest.approx(400e-6)]
    assert [g[0] for g in s["idle_gaps"]] == ["fdk_bench.block_pass",
                                              "fdk_bench.block_pass"]
    assert sorted(g[1] for g in s["idle_gaps"]) == [pytest.approx(200e-6),
                                                    pytest.approx(200e-6)]
    assert tr.summarize(TRACE, "fdk_bench.job") is None
    assert tr.gap_name((150, 350), tr.spans(tr.events(TRACE))) == \
        "fdk_bench.block_pass/h2d"


def test_block_readers():
    s = tr.summarize(TRACE, "fdk_bench.block_pass")
    least, _ = k1_pass_least_s(8, 16, 16, 10, 4, 16, 2)
    rec = {"trace": {"block": s},
           "block": {"updates": 2e9, "window_s": 4.0, "traced_steps": 4,
                     "k1_least_s": least}}
    assert read("block_gupd_per_s", rec) == pytest.approx(0.5)
    assert read("k1_roofline", rec) == pytest.approx(100 * least / 400e-6)
    assert read("step_other_ms", rec) == pytest.approx(1e3 * 200e-6 / 4)
    assert read("device_idle_share.block", rec) == pytest.approx(40.0)
    assert read("step_mfu", rec) == pytest.approx(100 * least / 1e-3)
    assert read("device_idle_share.job", rec) is None
    assert read("job_gupd_per_s", rec) is None


def test_job_readers():
    jobs = [dict(wall_s=1.0 + k / 100, reconstruct=0.5, drain=0.25,
                 stage_wait=0.125, blocks=1, updates=1e9)
            for k in range(100)]
    rec = {"jobs": jobs, "job_window_s": 200.0, "setup_s": 7.5, "trace": {}}
    assert read("job_gupd_per_s", rec) == pytest.approx(0.5)
    assert read("job_s_p90", rec) == pytest.approx(1.899)
    assert read("job_other_s", rec) == pytest.approx(1.495 - 0.75)
    assert read("ingest_wait_s", rec) == pytest.approx(0.125)
    assert read("drain_s", rec) == pytest.approx(0.25)
    assert read("setup_s", rec) == 7.5
    assert read("k1_roofline", rec) is None


def test_k1_count_is_per_block_pass():
    t, what = k1_pass_least_s(296, 2048, 2048, 3600, 456, 2048, 2)
    flops = 296 * 2048 * 2048 * 3600 * 15 + 2048 * 2048 * 3600 * 19
    assert what == "operations" and t == pytest.approx(flops / 67e12)
    assert k1_pass_least_s(1, 4, 4, 1, 1000, 1000, 4)[1] == "bytes"


def test_job_split_reads_the_program_log():
    import logging
    from fdk_bench.drivers import job_loop
    mk = logging.LogRecord
    recs = [mk("a", 20, "", 0, "block %d ingest from the %s: reconstruct "
               "%.3f s, read %.3f s (%d chunks), stage_wait %.3f s, "
               "step_enqueue %.3f s (%d steps), card_wait %.3f s",
               (0, "HIS files", 0.5, 0.7, 31, 0.25, 0.01, 31, 0.0), None),
            mk("a", 20, "", 0, "block %d drain: d2h %.3f s, write %.3f s, "
               "wait %.3f s (%d slabs of %d slices, %d pinned bytes)",
               (0, 0.01, 0.125, 0.0625, 1, 972, 100), None)]
    assert job_loop.job_split(recs) == {"reconstruct": 0.5,
                                        "stage_wait": 0.25,
                                        "drain": 0.1875, "blocks": 1}
