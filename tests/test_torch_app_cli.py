"""paris_tpu_torch run_job / CLI vs the JAX CLI on the same HIS files
(mirrors tests/test_app_cli.py:41-165; CPU torch, CPU JAX)."""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paris_tpu.cli import main as jax_cli_main
from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu.io import ddbvf
from paris_tpu.io.geometry_file import dump_geometry_file
from paris_tpu.io.his import write_his
from paris_tpu.phantom import cone_beam_project
from paris_tpu_torch import geometry as port_geometry
from paris_tpu_torch.app import ReconstructionJob, run_job
from paris_tpu_torch.cli import main as cli_main
from paris_tpu_torch.exceptions import ParisError, StageConstructionError
from paris_tpu_torch.utils.profiling import span, trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROI_ARGS = ["--roi", "--roi-x1", "10", "--roi-x2", "29",
            "--roi-y1", "12", "--roi-y2", "31",
            "--roi-z1", "4", "--roi-z2", "23"]


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan")
    det = DetectorGeometry(64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 6.0)
    vol = derive_volume_geometry(det)
    angles = np.arange(60, dtype=np.float32) * det.delta_phi
    projs = cone_beam_project(det, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2.0 * 0.9)
    pdir = root / "proj"
    pdir.mkdir()
    for i in range(0, 60, 15):
        write_his(str(pdir / f"b{i:03d}.his"), projs[i:i + 15])
    gpath = root / "scan.geo"
    dump_geometry_file(det, str(gpath))
    common = ["--geometry", str(gpath), "--input", str(pdir),
              "--output", str(root / "jax"), "--backend", "xla"]
    assert jax_cli_main(common + ["--name", "full"]) == 0
    assert jax_cli_main(common + ["--name", "roi"] + ROI_ARGS) == 0
    assert jax_cli_main(common + ["--name", "q2", "--quality", "2"]) == 0
    jax_out = {n: ddbvf.read_volume(str(root / "jax" / f"{n}.ddbvf"))
               for n in ("full", "roi", "q2")}
    # the port's job takes the port's own geometry class
    port_det = port_geometry.DetectorGeometry(**dataclasses.asdict(det))
    return dict(det=port_det, vol=vol, pdir=str(pdir), gpath=str(gpath),
                jax=jax_out)


def _close(got, ref, tol=1e-4):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _job(scan, out, **kw):
    kw.setdefault("backend", "torch")
    kw.setdefault("accuracy", "exact")
    return ReconstructionJob(det=scan["det"], input_path=scan["pdir"],
                             output_path=str(out), chunk_size=16, **kw)


def _multi_block_budget(vol):
    """A device-memory budget that splits the volume into ~24-slice
    blocks."""
    return 4 * vol.dim_x * vol.dim_y * 24 + 4 * (4 * 64 * 64) * 16


def test_run_job_single_block(scan, tmp_path):
    out = run_job(_job(scan, tmp_path, prefix="v1"))
    vol = scan["vol"]
    assert ddbvf.open_meta(out) == (vol.dim_x, vol.dim_y, vol.dim_z)
    _close(ddbvf.read_volume(out), scan["jax"]["full"])


def test_run_job_multi_block_matches_jax(scan, tmp_path, caplog):
    job = _job(scan, tmp_path, prefix="v2",
               hbm_budget_bytes=_multi_block_budget(scan["vol"]))
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        out = run_job(job)
    assert any("z-split: 3 block(s)" in m for m in caplog.messages)
    _close(ddbvf.read_volume(out), scan["jax"]["full"])


def test_run_job_resume_after_max_blocks(scan, tmp_path, caplog):
    kw = dict(prefix="v3", hbm_budget_bytes=_multi_block_budget(scan["vol"]))
    out = run_job(_job(scan, tmp_path, max_blocks=1, **kw))
    manifest = json.load(open(out + ".manifest.json"))
    assert manifest["completed_blocks"] == [0]
    run_job(_job(scan, tmp_path, resume=True, **kw))
    manifest = json.load(open(out + ".manifest.json"))
    assert manifest["completed_blocks"] == [0, 1, 2]
    _close(ddbvf.read_volume(out), scan["jax"]["full"])
    # resume on a complete output: every block skipped
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        run_job(_job(scan, tmp_path, resume=True, **kw))
    assert sum("skipping" in m for m in caplog.messages) == 3
    assert not any("reconstructing block" in m for m in caplog.messages)


def test_max_blocks_zero_computes_nothing(scan, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        out = run_job(_job(scan, tmp_path, prefix="v0", max_blocks=0))
    assert json.load(open(out + ".manifest.json"))["completed_blocks"] == []
    assert not any("reconstructing block" in m for m in caplog.messages)


def test_run_job_quality(scan, tmp_path):
    out = run_job(_job(scan, tmp_path, prefix="vq", quality=2))
    _close(ddbvf.read_volume(out), scan["jax"]["q2"])


def test_run_job_fast_mode(scan, tmp_path):
    """Fast mode (u16 staging, bf16 projections) stays within bf16 noise
    of the JAX float32 result."""
    out = run_job(_job(scan, tmp_path, prefix="vf", accuracy="fast"))
    got, ref = ddbvf.read_volume(out), scan["jax"]["full"]
    rmse = np.sqrt(np.mean((got - ref) ** 2)) / np.abs(ref).max()
    assert rmse < 1e-3, rmse


def _traces(trace_dir):
    """The Chrome-trace files in ``trace_dir``, each parsed."""
    names = sorted(os.listdir(trace_dir))
    assert all(n.endswith(".pt.trace.json") for n in names), names
    traces = []
    for n in names:
        with open(os.path.join(trace_dir, n)) as f:
            traces.append(json.load(f))
    return traces


def test_run_job_trace_dir_not_ported(scan, tmp_path):
    """trace_dir on a multi-block job: one Chrome trace per block, and the
    volume still matches the JAX CLI's."""
    trace_dir = tmp_path / "trace"
    out = run_job(_job(scan, tmp_path, prefix="vt", trace_dir=str(trace_dir),
                       hbm_budget_bytes=_multi_block_budget(scan["vol"])))
    traces = _traces(trace_dir)
    assert len(traces) == 3
    for t in traces:
        assert any(e.get("ph") == "X" for e in t["traceEvents"])
    _close(ddbvf.read_volume(out), scan["jax"]["full"])


def test_annotate_without_nvtx(tmp_path, monkeypatch):
    """Without a card, a span (what annotated a region before) names a
    region in the trace and never touches NVTX or a CUDA event (whose
    calls raise on a CPU build of torch)."""
    def no_card(*_a, **_k):
        raise AssertionError("NVTX or a CUDA event touched without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda.nvtx, "range", no_card)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_card)
    monkeypatch.setattr(torch.cuda, "Event", no_card)
    with trace(str(tmp_path)):
        with span("paris-annotated-region"):
            torch.ones(8).sum()
    (t,) = _traces(tmp_path)
    assert any(e.get("name") == "paris-annotated-region"
               for e in t["traceEvents"])


def test_trace_without_dir_is_a_no_op(tmp_path):
    with trace(None), trace(""):
        torch.ones(8).sum()
    assert os.listdir(tmp_path) == []


def test_two_tier_exceptions(tmp_path):
    """The port raises its own exception classes."""
    det = port_geometry.DetectorGeometry(32, 32, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 3.0)
    with pytest.raises(StageConstructionError):
        run_job(ReconstructionJob(det=det, input_path=str(tmp_path),
                                  output_path="/proc/nope/denied",
                                  backend="torch"))
    with pytest.raises(ParisError):
        run_job(ReconstructionJob(det=det,
                                  input_path=str(tmp_path / "missing"),
                                  output_path=str(tmp_path), backend="torch"))
    with pytest.raises(StageConstructionError):
        run_job(ReconstructionJob(det=det, input_path=str(tmp_path),
                                  output_path=str(tmp_path), backend="torch",
                                  block_dz=0))


# ------------------------------------------------------------------ CLI

def _cli(scan, out, *extra):
    return cli_main(["--geometry", scan["gpath"], "--input", scan["pdir"],
                     "--output", str(out), "--backend", "torch",
                     "--accuracy", "exact", "--chunk-size", "16", *extra])


def test_cli_full_reconstruction(scan, tmp_path):
    assert _cli(scan, tmp_path, "--name", "clivol") == 0
    _close(ddbvf.read_volume(str(tmp_path / "clivol.ddbvf")),
           scan["jax"]["full"])


def test_cli_multi_block_and_resume(scan, tmp_path):
    args = ("--name", "mb", "--block-dz", "24")
    assert _cli(scan, tmp_path, *args, "--max-blocks", "2") == 0
    path = str(tmp_path / "mb.ddbvf")
    assert json.load(open(path + ".manifest.json"))[
        "completed_blocks"] == [0, 1]
    assert _cli(scan, tmp_path, *args, "--resume") == 0
    _close(ddbvf.read_volume(path), scan["jax"]["full"])


def test_cli_roi_reconstruction(scan, tmp_path):
    assert _cli(scan, tmp_path, "--name", "roivol", *ROI_ARGS) == 0
    got = ddbvf.read_volume(str(tmp_path / "roivol.ddbvf"))
    assert got.shape == (20, 20, 20)
    _close(got, scan["jax"]["roi"])


@pytest.mark.parametrize("flags", [
    ["--distributed"], ["--distributed", "--trace-dir", "t"],
    ["--coordinator", "h:1"], ["--num-processes", "2"],
    ["--process-id", "0"],
])
def test_cli_unported_flags_exit_2(scan, tmp_path, capsys, flags):
    """The multi-device flags: --coordinator, --num-processes and
    --process-id without --distributed exit 2 (paris_tpu/cli.py:104-121);
    --distributed alone runs the job over a group of one and leaves no
    group behind."""
    if "--distributed" not in flags:
        assert _cli(scan, tmp_path, *flags) == 2
        assert "require --distributed" in capsys.readouterr().err
        return
    flags = [str(tmp_path / f) if f == "t" else f for f in flags]
    assert _cli(scan, tmp_path, "--name", "dv", *flags) == 0
    assert not torch.distributed.is_initialized()
    _close(ddbvf.read_volume(str(tmp_path / "dv.ddbvf")), scan["jax"]["full"])
    if "--trace-dir" in flags:
        (t,) = _traces(tmp_path / "t")
        assert any(e.get("ph") == "X" for e in t["traceEvents"])


def test_cli_distributed_init_failure_exits_2(scan, tmp_path, capsys):
    """--distributed with flags that cannot make a group exits 2 with the
    error; so does the card's backend without a card."""
    assert _cli(scan, tmp_path, "--distributed", "--coordinator", "h:1") == 2
    assert "go together" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli_main(["--geometry", scan["gpath"], "--distributed",
                         "--backend", "cuda"]) == 2
        assert "initialization failed" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_cli_trace_dir_writes_a_trace(scan, tmp_path):
    trace_dir = tmp_path / "trace"
    assert _cli(scan, tmp_path, "--name", "tr", "--trace-dir",
                str(trace_dir)) == 0
    (t,) = _traces(trace_dir)
    assert any(e.get("ph") == "X" for e in t["traceEvents"])
    _close(ddbvf.read_volume(str(tmp_path / "tr.ddbvf")), scan["jax"]["full"])


def test_cli_backend_choices(capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--backend", "pallas"])
    assert e.value.code == 2
    assert "cuda" in capsys.readouterr().err


def test_cli_cuda_backend_without_card(scan, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    rc = cli_main(["--geometry", scan["gpath"], "--input", scan["pdir"],
                   "--output", str(tmp_path), "--backend", "cuda"])
    assert rc == 1
    assert "cuda" in capsys.readouterr().err


def test_cli_geometry_format(capsys):
    assert cli_main(["--geometry-format"]) == 0
    assert "n_row" in capsys.readouterr().out


def test_cli_dry_run(scan):
    assert cli_main(["--geometry", scan["gpath"]]) == 0


def test_cli_missing_geometry():
    assert cli_main([]) == 2


def test_cli_io_pair_enforced(scan, capsys):
    assert cli_main(["--geometry", scan["gpath"], "--input",
                     scan["pdir"]]) == 2
    assert "--output" in capsys.readouterr().err


def test_cli_roi_requires_coords(scan, capsys):
    assert cli_main(["--geometry", scan["gpath"], "--roi",
                     "--roi-x1", "0"]) == 2
    assert "roi" in capsys.readouterr().err


def test_port_never_imports_jax():
    """The machine with the card has no JAX: importing the port's entry
    points must not pull it in."""
    code = ("import sys, paris_tpu_torch, paris_tpu_torch.cli, "
            "paris_tpu_torch.app, paris_tpu_torch.pipeline, "
            "paris_tpu_torch.ops, paris_tpu_torch.utils.profiling, "
            "paris_tpu_torch.parallel, paris_tpu_torch.parallel.app, "
            "paris_tpu_torch.benchmarks.gather_micro, "
            "paris_tpu_torch.benchmarks.gather_micro2; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_default_backend_without_card(scan, tmp_path, capsys):
    """``auto``, the default of the job, the CLI and the distributed CLI,
    is the card: without one each fails, names ``--backend torch``, and
    writes no volume."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    with pytest.raises(StageConstructionError, match="--backend torch"):
        run_job(ReconstructionJob(det=scan["det"], input_path=scan["pdir"],
                                  output_path=str(tmp_path)))
    args = ["--geometry", scan["gpath"], "--input", scan["pdir"],
            "--output", str(tmp_path)]
    assert cli_main(args) == 1
    assert "--backend torch" in capsys.readouterr().err
    assert cli_main(args + ["--distributed"]) == 2
    assert "--backend torch" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
    assert not any(n.endswith(".ddbvf") for n in os.listdir(tmp_path))


def test_projection_cache_peak_is_the_cache(tmp_path):
    """The host cache of a multi-block job keeps the stream's chunks as
    they came: the job's traced host peak rises by at most
    ``max_cache_bytes`` plus one chunk over the same job with no cache
    (joining the chunks into one array doubled it), the stream is decoded
    once, and the volume is byte for byte the same."""
    import tracemalloc
    from paris_tpu_torch.io import his as port_his
    det = port_geometry.DetectorGeometry(32, 32, 2.0, 2.0, 0.0, 0.0,
                                         500.0, 500.0, 1.5)
    n_proj, chunk = 240, 16
    frames = np.random.default_rng(11).uniform(
        0, 1, (n_proj, 32, 32)).astype(np.float32)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, n_proj, 8):
        write_his(str(pdir / f"b{i:05d}.his"), frames[i:i + 8])
    stream = frames.nbytes
    peaks, volumes, decoded = {}, {}, {}
    for cache in (False, False, True):
        job = ReconstructionJob(
            det=det, input_path=str(pdir), output_path=str(tmp_path),
            prefix=f"c{int(cache)}", chunk_size=chunk, backend="torch",
            accuracy="exact", block_dz=8, cache_projections=cache,
            max_cache_bytes=stream)
        before = port_his.DECODE_STATS["frames"]
        tracemalloc.start()
        try:
            out = run_job(job)
            peaks[cache] = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        decoded[cache] = port_his.DECODE_STATS["frames"] - before
        with open(out, "rb") as f:
            volumes[cache] = f.read()
    n_blocks = port_geometry.plan_z_blocks(
        port_geometry.derive_volume_geometry(det), block_dz=8).num
    assert n_blocks > 1
    assert decoded == {False: n_blocks * n_proj, True: n_proj}
    assert volumes[True] == volumes[False]
    assert peaks[True] - peaks[False] <= stream + chunk * 32 * 32 * 4, peaks


# ------------------------------------------------ the host cache's cap

def _cap_job(tmp_path, prefix, n_proj=48, **kw):
    """A multi-block job (block_dz=8) over ``n_proj`` random 32 x 32
    frames; returns (job, bytes of the stream, blocks)."""
    det = port_geometry.DetectorGeometry(32, 32, 2.0, 2.0, 0.0, 0.0,
                                         500.0, 500.0, 7.5)
    pdir = tmp_path / "proj"
    if not pdir.exists():
        pdir.mkdir()
        frames = np.random.default_rng(12).uniform(
            0, 1, (n_proj, 32, 32)).astype(np.float32)
        for i in range(0, n_proj, 8):
            write_his(str(pdir / f"b{i:05d}.his"), frames[i:i + 8])
    job = ReconstructionJob(
        det=det, input_path=str(pdir), output_path=str(tmp_path),
        prefix=prefix, chunk_size=16, backend="torch", accuracy="exact",
        block_dz=8, **kw)
    n_blocks = port_geometry.plan_z_blocks(
        port_geometry.derive_volume_geometry(det), block_dz=8).num
    assert n_blocks > 1
    return job, n_proj * 32 * 32 * 4, n_blocks


def _run_counting(job):
    """(the job's ddbvf bytes, frames it decoded)."""
    from paris_tpu_torch.io import his as port_his
    before = port_his.DECODE_STATS["frames"]
    out = run_job(job)
    with open(out, "rb") as f:
        return f.read(), port_his.DECODE_STATS["frames"] - before


def test_cache_cap_follows_the_hosts_memory(tmp_path, monkeypatch, caplog):
    """With little memory available the default cap falls below the
    stream: a two-block job streams the scan once per block instead of
    caching it, writes the same bytes as with the cache on, and logs what
    it decided."""
    from paris_tpu_torch import app
    job, stream, n_blocks = _cap_job(tmp_path, "small")
    assert job.max_cache_bytes is None
    monkeypatch.setattr(app, "_available_host_bytes", lambda: stream)
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        small, decoded_small = _run_counting(job)
    assert decoded_small == n_blocks * 48
    assert f"cap {stream // 2 / 2**30:.2f} GiB" in caplog.text
    assert f"passed the cap of {stream // 2} bytes" in caplog.text
    caplog.clear()
    monkeypatch.setattr(app, "_available_host_bytes", lambda: 1 << 40)
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        cached, decoded_cached = _run_counting(
            dataclasses.replace(job, prefix="large"))
    assert decoded_cached == 48
    assert "projection cache: on, cap 64.00 GiB" in caplog.text
    assert f"kept the stream's {stream} bytes" in caplog.text
    assert small == cached


def test_explicit_cache_cap_does_not_read_the_hosts_memory(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    from paris_tpu_torch import app

    def probe():
        raise AssertionError("the probe was consulted")
    monkeypatch.setattr(app, "_available_host_bytes", probe)
    job, stream, n_blocks = _cap_job(tmp_path, "fits", max_cache_bytes=0)
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        streamed, decoded = _run_counting(job)
        assert decoded == n_blocks * 48
        assert "the job's max_cache_bytes" in caplog.text
        cached, decoded = _run_counting(dataclasses.replace(
            job, prefix="kept", max_cache_bytes=stream))
        assert decoded == 48
        assert cached == streamed
        # a job that does not cache never asks either
        _run_counting(dataclasses.replace(
            job, prefix="off", max_cache_bytes=None,
            cache_projections=False))
    assert "projection cache: off (cache_projections=False)" in caplog.text


@pytest.mark.parametrize("explicit,available,want", [
    (None, None, 64 << 30),              # sysconf lacks the names
    (None, 10 << 30, 5 << 30),           # half of what is available
    (None, 1 << 40, 64 << 30),           # never above 64 GiB
    (123, 10 << 30, 123),                # an explicit cap as given
])
def test_resolve_cache_cap(monkeypatch, explicit, available, want):
    from paris_tpu_torch import app
    monkeypatch.setattr(app, "_available_host_bytes", lambda: available)
    job = ReconstructionJob(det=None, input_path="", output_path="",
                            max_cache_bytes=explicit)
    assert app.resolve_cache_cap(job) == want


def test_available_host_bytes_probe(monkeypatch):
    from paris_tpu_torch import app
    got = app._available_host_bytes()
    assert got is None or got > 0

    def no_names(name):
        raise ValueError("unrecognized configuration name")
    monkeypatch.setattr(os, "sysconf", no_names)
    assert app._available_host_bytes() is None
