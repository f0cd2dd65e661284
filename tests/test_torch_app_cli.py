"""paris_tpu_torch run_job / CLI vs the JAX CLI on the same HIS files
(mirrors tests/test_app_cli.py:41-165; CPU torch, CPU JAX)."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paris_tpu import StageConstructionError
from paris_tpu.cli import main as jax_cli_main
from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu.io import ddbvf
from paris_tpu.io.geometry_file import dump_geometry_file
from paris_tpu.io.his import write_his
from paris_tpu.phantom import cone_beam_project
from paris_tpu_torch.app import ReconstructionJob, run_job
from paris_tpu_torch.cli import main as cli_main
from paris_tpu_torch.utils.profiling import annotate, trace


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
    return dict(det=det, vol=vol, pdir=str(pdir), gpath=str(gpath),
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
    """Without a card, annotate names a region in the trace and never
    touches NVTX (whose calls raise on a CPU build of torch)."""
    def no_nvtx(*_a, **_k):
        raise AssertionError("NVTX touched without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda.nvtx, "range", no_nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_nvtx)
    with trace(str(tmp_path)):
        with annotate("paris-annotated-region"):
            torch.ones(8).sum()
    (t,) = _traces(tmp_path)
    assert any(e.get("name") == "paris-annotated-region"
               for e in t["traceEvents"])


def test_trace_without_dir_is_a_no_op(tmp_path):
    with trace(None), trace(""):
        torch.ones(8).sum()
    assert os.listdir(tmp_path) == []


def test_two_tier_exceptions(tmp_path):
    from paris_tpu import ParisError
    det = DetectorGeometry(32, 32, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 3.0)
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
    ["--distributed", "--coordinator", "h:1"],
    ["--distributed", "--num-processes", "2"],
    ["--distributed", "--process-id", "0"],
])
def test_cli_unported_flags_exit_2(scan, tmp_path, capsys, flags):
    assert _cli(scan, tmp_path, *flags) == 2
    assert "not yet ported to paris_tpu_torch" in capsys.readouterr().err


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
            "paris_tpu_torch.benchmarks.gather_micro, "
            "paris_tpu_torch.benchmarks.gather_micro2; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
