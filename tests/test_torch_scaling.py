"""The port's config-5 scaling harnesses on the CPU: the all-gather count of
``weak_scaling_projection`` against its model (the band from the JAX
package's ``detector_row_band``) at world 1 and in 2 spawned gloo ranks,
the projection (which needs a kernel rate), and ``weak_scaling`` at
N = 1, 2."""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from paris_tpu import geometry as jax_geometry
from paris_tpu_torch.benchmarks import weak_scaling as ws
from paris_tpu_torch.benchmarks import weak_scaling_projection as wsp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(banded):
    """C x vp x n_row + 2C gathered elements at the small geometry, vp
    from the JAX package's band (no 128 rounding, no row padding)."""
    jdet = jax_geometry.DetectorGeometry(**dataclasses.asdict(wsp.SMALL_DET))
    jvol = jax_geometry.derive_volume_geometry(jdet)
    vp = jdet.n_col
    if banded:
        lo, hi = jax_geometry.detector_row_band(jdet, jvol, 0, wsp.SMALL_DZ)
        vp = hi - lo
    return wsp.SMALL_C * vp * jdet.n_row + 2 * wsp.SMALL_C, vp


def _check(counts, world):
    for name, banded in (("banded", True), ("full", False)):
        c = counts[name]
        want, vp = _model(banded)
        assert c["world"] == world and c["vp"] == vp
        assert c["elements"] == c["model_elements"] == want
        # fast mode: the filtered band in bf16, sin and cos in f32
        assert c["bytes"] == 2 * (want - 2 * wsp.SMALL_C) \
            + 4 * 2 * wsp.SMALL_C
        assert c["gathers"] == 3
    assert counts["banded"]["vp"] < counts["full"]["vp"] == 256


def test_gather_count_equals_the_model_at_world_1():
    _check(wsp.gather_counts_in(), 1)
    assert not dist.is_initialized()


def test_gather_count_equals_the_model_in_2_ranks():
    """Each rank stages its half of the chunk; the gathered tensors are
    the whole chunk's, so the count does not change with the world."""
    _check(ws.spawn_ranks(wsp.MODULE, 2, [], threads=1), 2)


def test_projection_needs_a_kernel_rate(monkeypatch):
    monkeypatch.delenv("PARIS_BENCH_KERNEL_GUPS", raising=False)
    with pytest.raises(RuntimeError, match="kernel rate"):
        wsp.run()


def test_projection_from_a_given_rate(monkeypatch):
    """With PARIS_BENCH_KERNEL_GUPS: the NVLink model and its source, the
    config-5 gather on the job's widest band, and the crossover at which
    32 cards keep 80 %."""
    monkeypatch.setenv("PARIS_BENCH_KERNEL_GUPS", "700")
    res = wsp.run()
    assert res["kernel_gups_measured"] == 700.0
    assert res["kernel_gups_source"] == "PARIS_BENCH_KERNEL_GUPS"
    assert res["nvlink_gbps_assumed"] == 450.0
    assert "nvidia.com/en-us/data-center/h100" in res["nvlink_gbps_source"]
    assert set(res["projected_sensitivity"]) == {"450_gbps", "150_gbps"}
    assert [r["chips"] for r in res["projected"]] == [2, 4, 8, 16, 32]
    gather = res["projected"][0]["gather_mb_per_step"] * 1e6
    assert gather == pytest.approx(8 * 2048 * res["vp_band"] * 2, rel=1e-3)
    t_comp = 344 * 2048 * 2048 / 32 * 8 / 700e9
    assert res["crossover_gbps_for_80pct_at_32_chips"] == pytest.approx(
        4 * gather * 31 / 32 / t_comp / 1e9, rel=1e-3)
    at32 = res["projected"][-1]
    assert at32["projected_efficiency"] == pytest.approx(
        at32["t_comp_ms"] / (at32["t_comp_ms"] + at32["t_comm_ms"]),
        rel=1e-3)
    assert res["pass"] == all(r["projected_efficiency"] >= 0.8
                              for r in res["projected"])
    assert not dist.is_initialized()


def test_weak_scaling_at_1_and_2_ranks():
    """The same total problem (8 slices of the 256-class volume) in gloo
    groups of 1 and 2 spawned single-threaded ranks, against the ideal
    t_1 / N."""
    res = ws.run([1, 2], total_dz=8, cores=2, backend="torch")
    assert res["platform"] == "cpu-gloo"
    assert [r["n"] for r in res["rows"]] == [1, 2]
    one, two = res["rows"]
    assert one["overhead_vs_unsharded"] == 0.0
    assert all(r["sec_per_step"] > 0 and r["threads_per_rank"] == 1
               for r in res["rows"])
    assert two["ideal_sec_per_step"] == pytest.approx(
        one["sec_per_step"] / 2, abs=1e-4)
    assert two["overhead_vs_unsharded"] == pytest.approx(
        two["sec_per_step"] * 2 / one["sec_per_step"] - 1, abs=2e-3)
    over = two["overhead_vs_unsharded"]
    assert res["pass"] == (None if over < 0 else over <= 0.25)
    assert res["total_block_dz"] == 8


@pytest.mark.parametrize("kw", [{}, {"backend": "cuda"},
                                {"backend": "torch", "cores": 1}])
def test_weak_scaling_runs_only_as_asked(kw):
    """The card is the default and this CPU harness raises on it, naming
    ``--backend torch``; more single-threaded ranks than cores raise."""
    with pytest.raises(ValueError, match="backend torch|cores"):
        ws.run([1, 2], total_dz=8, **kw)
