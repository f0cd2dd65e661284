"""The port's streaming and driver A/B runners on the CPU (``--backend
torch``) at a 48² detector: ``config3_stream`` (its keys, the JAX driver's
recorded ones, and its centre slab against the JAX package's golden oracle
over the same stored frames), its scan cache, ``dist_parity_ab`` and
``dist_overlap_ab`` (the two drivers' ddbvf byte for byte), and process
groups made one after the other in one process."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from paris_tpu import geometry as jax_geometry
from paris_tpu.golden import golden_fdk
from paris_tpu_torch.benchmarks import config3_stream as cs
from paris_tpu_torch.benchmarks import dist_overlap_ab as oa
from paris_tpu_torch.benchmarks import dist_parity_ab as pa
from paris_tpu_torch.io import ddbvf
from paris_tpu_torch.io.his import read_his
from paris_tpu_torch.io.source import scan_directory
from paris_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, N_PROJ = 48, 16


def _jax_keys(results, name):
    with open(os.path.join(REPO, "benchmarks", results)) as f:
        return {k for r in json.load(f) if r["name"] == name for k in r}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """config3_stream at 48² and 16 frames, its scan and output kept, the
    kernel rate measured by bench first."""
    root = tmp_path_factory.mktemp("c3s")
    res = cs.run(SIZE, "fast", "torch", n_proj=N_PROJ,
                 scandir=str(root / "scan"), workdir=str(root / "work"),
                 golden_shards=2)
    return root, res


def test_config3_stream_keys_and_gates(stream):
    _, res = stream
    assert _jax_keys("results_round4.json", "streaming_full_scan_1024") \
        <= set(res)
    assert res["name"] == f"streaming_full_scan_{SIZE}"
    assert res["n_proj"] == N_PROJ and res["volume"] == (SIZE,) * 3
    assert res["pass_rmse"] and res["pass"] == (res["pass_rmse"]
                                                and res["pass_rate"])
    assert 0 < res["rel_rmse_vs_golden_center_slab"] <= 1e-3
    assert res["kernel_only_source"].startswith("bench.run")
    assert res["kernel_only_gupd_per_s"] > 0
    assert res["reconstruct_seconds"] > 0 and res["blocks"] == 1
    assert res["device"] == "cpu"
    (drain,) = res["drain_split"]
    assert drain["block"] == 0 and drain["slabs"] >= 1
    assert drain["write_s"] > 0 and drain["pinned_bytes"] == 0


def test_config3_stream_slab_against_the_jax_golden(stream):
    """The centre slab of the job's ddbvf against the JAX package's
    ``golden_fdk`` over the stored frames, at the gate."""
    root, res = stream
    frames = np.concatenate([read_his(p) for p in scan_directory(
        str(root / "scan" / cs.SCAN_SUBDIR))])
    det = cs.geometry(SIZE, N_PROJ)
    jdet = jax_geometry.DetectorGeometry(**dataclasses.asdict(det))
    jvol = jax_geometry.derive_volume_geometry(jdet)
    mid = jvol.dim_z // 2 - 2
    golden = golden_fdk(frames, np.arange(N_PROJ) * det.delta_phi, jdet,
                        jvol, dz=4, z_offset=mid)
    got = ddbvf.read_slices(str(root / "work" / "c3.ddbvf"), mid, 4)
    rmse = np.sqrt(np.mean((got - golden) ** 2)) / np.abs(golden).max()
    assert rmse <= 1e-3
    assert rmse == pytest.approx(res["rel_rmse_vs_golden_center_slab"],
                                 rel=1e-2)


def test_scan_cache_reused_only_on_an_exact_match(stream, tmp_path):
    root, _ = stream
    scan = str(root / "scan")
    pdir = os.path.join(scan, cs.SCAN_SUBDIR)
    det = cs.geometry(SIZE, N_PROJ)
    assert cs.scan_matches(pdir, det, N_PROJ)
    assert not cs.scan_matches(pdir, det, N_PROJ + 8)
    assert not cs.scan_matches(pdir, cs.geometry(40, N_PROJ), N_PROJ)
    assert not cs.scan_matches(str(tmp_path), det, N_PROJ)
    before = {p: os.stat(p).st_mtime_ns for p in scan_directory(pdir)}
    assert cs.cached_scan(scan, det, N_PROJ, "cpu") == (0.0, [])
    assert {p: os.stat(p).st_mtime_ns for p in scan_directory(pdir)} \
        == before
    # another frame count: the old scan goes, the new one is written
    other = str(tmp_path / "other")
    os.makedirs(os.path.join(other, cs.SCAN_SUBDIR))
    for p in before:
        os.link(p, os.path.join(other, cs.SCAN_SUBDIR, os.path.basename(p)))
    with open(os.path.join(other, cs.SCAN_SUBDIR, "SYNTH_DONE"), "w") as f:
        f.write(str(N_PROJ))
    seconds, procs = cs.cached_scan(other, cs.geometry(SIZE, 8), 8, "cpu")
    assert seconds > 0 and procs == []
    assert len(scan_directory(os.path.join(other, cs.SCAN_SUBDIR))) == 1
    assert cs.scan_matches(os.path.join(other, cs.SCAN_SUBDIR),
                           cs.geometry(SIZE, 8), 8)


def test_dist_parity_ab_outputs_identical(stream, tmp_path):
    """Two pairs in turns over the cached scan: byte-identical outputs,
    the JAX driver's keys, the ratio gate computed from the medians."""
    root, _ = stream
    res = pa.run(SIZE, 1, "torch", n_scan=N_PROJ, scandir=str(root / "scan"),
                 pairs=2, workdir=str(tmp_path))
    assert _jax_keys("results_round4.json", "dist_parity_ab_mesh1") <= set(res)
    assert res["outputs_identical"] and res["max_rel_diff"] == 0.0
    assert res["n_proj"] == N_PROJ
    assert all(len(v) == 2 for v in res["reconstruct_s_all"].values())
    pps = res["proj_per_s"]
    assert res["ratio_dist_over_single"] == pytest.approx(
        pps["distributed"] / pps["single"], abs=2e-3)
    assert res["pass"] == (res["ratio_dist_over_single"] >= 0.85)
    ref = ddbvf.read_volume(str(tmp_path / "reference.ddbvf"))
    assert ref.shape == (SIZE,) * 3 and np.abs(ref).max() > 0
    assert not dist.is_initialized()


def test_dist_overlap_ab_outputs_identical(stream, tmp_path):
    """A forced multi-block split with the write overlap on in both
    drivers: byte-identical outputs and the JAX driver's keys."""
    root, _ = stream
    res = oa.run(SIZE, N_PROJ, "torch", pairs=1, scandir=str(root / "scan"),
                 workdir=str(tmp_path))
    assert _jax_keys("results_round5.json", "dist_overlap_ab_mesh1_1024") \
        <= set(res)
    assert res["outputs_identical"] and res["max_rel_diff"] == 0.0
    assert res["blocks"] >= 2 and res["write_overlap"]
    assert res["pass"] == (res["ratio_dist_over_single"] <= 1.2)
    assert not dist.is_initialized()


@pytest.mark.parametrize("module", [pa, oa])
def test_ab_main_scan_size(stream, tmp_path, monkeypatch, module):
    """Both A/Bs take the scan size the same way: ``--n-proj``, default
    ``PARIS_BENCH_CFG3_NPROJ``; the cached scan of that size is reused."""
    root, _ = stream
    scan = str(root / "scan")
    pdir = os.path.join(scan, cs.SCAN_SUBDIR)
    before = {p: os.stat(p).st_mtime_ns for p in scan_directory(pdir)}
    monkeypatch.setenv("PARIS_BENCH_CFG3_SCANDIR", scan)
    monkeypatch.setenv("PARIS_BENCH_CFG3_NPROJ", str(N_PROJ))
    argv = ["--size", str(SIZE), "--backend", "torch",
            "--out", str(tmp_path / "r.json")]
    res = module.main(argv + (["--quality", "1"] if module is pa else []))
    assert res["n_proj"] == N_PROJ and res["outputs_identical"]
    assert {p: os.stat(p).st_mtime_ns for p in scan_directory(pdir)} \
        == before
    # the option over the variable: a scan of 8 frames, made anew
    monkeypatch.setenv("PARIS_BENCH_CFG3_SCANDIR", str(tmp_path / "s8"))
    res = module.main(argv + ["--n-proj", "8"]
                      + (["--quality", "1"] if module is pa else []))
    assert res["n_proj"] == 8 and res["outputs_identical"]
    assert cs.scan_matches(str(tmp_path / "s8" / cs.SCAN_SUBDIR),
                           cs.geometry(SIZE, 8), 8)


def test_two_gloo_groups_one_after_the_other():
    """A group of one made, used, destroyed, and made again in the same
    process (each with a fresh store), as the runners do."""
    for value in (3, 5):
        device = multihost.initialize(backend="torch")
        try:
            t = torch.tensor([value], device=device)
            dist.all_reduce(t)
            assert t.item() == value and dist.get_world_size() == 1
        finally:
            multihost.shutdown()
        assert not dist.is_initialized()
