"""paris_tpu_torch at offset detectors: the port's CLI against the JAX
CLI's XLA path job by job, the detector-row band against the taps the
backprojection reads, and the fast mode against the golden oracle (CPU
torch, CPU JAX).

A vertical detector offset (``delta_t``) moves the rows every z-block
samples; a multi-block job cuts each block's band of rows before it
weights, filters and backprojects, so a band placed with the wrong sign
of the offset drops the rows the block's edge slices read.  The one-block
job never cuts a band.  Every case here runs in more than one block."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from paris_tpu import geometry as jax_geometry
from paris_tpu.cli import main as jax_cli_main
from paris_tpu.golden import golden_fdk_stream
from paris_tpu.io import ddbvf
from paris_tpu.io.geometry_file import dump_geometry_file
from paris_tpu.io.his import read_his, write_his
from paris_tpu.phantom import cone_beam_project
from paris_tpu_torch import geometry as port_geometry
from paris_tpu_torch.cli import main as cli_main
from paris_tpu_torch.ops.backprojection_torch import (kernel_constants,
                                                      make_bp_grid)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (n_row, n_col, l_px_row, l_px_col, delta_s, delta_t, d_so, d_od)
BASE = (48, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0)


def _det(**kw):
    """The JAX package's detector: BASE with ``kw`` replaced, one frame
    every 7.2 degrees (50 frames a turn)."""
    names = ("n_row", "n_col", "l_px_row", "l_px_col", "delta_s", "delta_t",
             "d_so", "d_od")
    args = dict(zip(names, BASE), delta_phi=7.2)
    args.update(kw)
    return jax_geometry.DetectorGeometry(**args)


ROI_ARGS = ["--roi", "--roi-x1", "6", "--roi-x2", "33", "--roi-y1", "4",
            "--roi-y2", "31", "--roi-z1", "9", "--roi-z2", "44"]

# id -> (detector, scan number type, flags both CLIs take, the port's
# expected block count)
CASES = {
    "dt-6.5_dz13": (_det(delta_t=-6.5), "f32", ["--block-dz", "13"], 5),
    "dt-2_ds3_dz9": (_det(delta_s=3.0, delta_t=-2.0), "f32",
                     ["--block-dz", "9"], 5),
    "dt0.6_ds-2.5_dso300_dod200": (
        _det(delta_s=-2.5, delta_t=0.6, d_so=300.0, d_od=200.0), "f32",
        ["--block-dz", "20"], 3),
    "dt3_dso900_dod500_budget": (
        _det(delta_t=3.0, d_so=900.0, d_od=500.0), "f32",
        ["--hbm-budget-gb", "0.0012"], 2),
    "dt-2_rect_pixels": (
        _det(n_row=40, n_col=72, l_px_row=2.0, l_px_col=1.5, delta_s=1.5,
             delta_t=-2.0), "f32", ["--block-dz", "8"], 8),
    "dt3_ds2_roi_dz8": (_det(delta_s=2.0, delta_t=3.0), "f32",
                        ROI_ARGS + ["--block-dz", "8"], 5),
    "dt-6.5_roi_dz16": (_det(delta_t=-6.5, d_so=300.0, d_od=200.0), "f32",
                        ROI_ARGS + ["--block-dz", "16"], 3),
    "dt-6.5_ds4.6_quality2": (_det(delta_s=4.6, delta_t=-6.5), "f32",
                              ["--quality", "2", "--block-dz", "11"], 5),
    "dt0.6_quality3": (_det(delta_t=0.6, d_so=900.0, d_od=200.0), "f32",
                       ["--quality", "3", "--block-dz", "12"], 5),
    "dt-2_chunk_tail": (_det(delta_t=-2.0, delta_s=-3.0), "f32",
                        ["--chunk-size", "12", "--block-dz", "11"], 5),
    "dt3_u16": (_det(delta_t=3.0), "u16", ["--block-dz", "10"], 5),
    "dt-6.5_ds4.6_u16": (_det(delta_s=4.6, delta_t=-6.5), "u16",
                         ["--block-dz", "24"], 4),
    "dt0_ds3_dz7": (_det(delta_s=3.0), "f32", ["--block-dz", "7"], 8),
}
N_PROJ = 50


def _scan_frames(det, number_type):
    """The Shepp-Logan scan of ``det`` as it lies in the HIS files: float32
    line integrals, or uint16 counts of one scale."""
    vol = jax_geometry.derive_volume_geometry(det)
    angles = np.arange(N_PROJ, dtype=np.float32) * det.delta_phi
    projs = cone_beam_project(det, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2.0 * 0.9)
    if number_type == "u16":
        projs = np.round(projs * (60000.0 / projs.max())).astype(np.uint16)
    return projs.astype(np.float32 if number_type == "f32" else np.uint16)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """(detector, number type) -> (scan directory, geometry file, stored
    frames as float32), written once."""
    made = {}

    def get(det, number_type):
        key = (det, number_type)
        if key not in made:
            root = tmp_path_factory.mktemp("scan")
            frames = _scan_frames(det, number_type)
            pdir = root / "proj"
            pdir.mkdir()
            for i in range(0, N_PROJ, 20):
                write_his(str(pdir / f"b{i:03d}.his"), frames[i:i + 20],
                          number_dtype=frames.dtype)
            gpath = root / "scan.geo"
            dump_geometry_file(det, str(gpath))
            made[key] = (str(pdir), str(gpath), frames.astype(np.float32))
        return made[key]
    return get


def _argv(scan, out, name, backend, flags):
    pdir, gpath, _ = scan
    return ["--geometry", gpath, "--input", pdir, "--output", str(out),
            "--name", name, "--backend", backend, "--accuracy", "exact",
            *flags]


def _jax_volume(scan, out, flags):
    assert jax_cli_main(_argv(scan, out, "jax", "xla", flags)) == 0
    return ddbvf.read_volume(str(out / "jax.ddbvf"))


def _port(scan, out, name, flags, accuracy="exact"):
    """The port's CLI on the CPU; returns (volume, completed blocks)."""
    argv = _argv(scan, out, name, "torch", flags)
    argv[argv.index("exact")] = accuracy
    assert cli_main(argv) == 0
    path = str(out / f"{name}.ddbvf")
    done = json.load(open(path + ".manifest.json"))["completed_blocks"]
    return ddbvf.read_volume(path), done


def _close(got, ref, tol=1e-4):
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("case", list(CASES))
def test_offset_job_matches_jax(scans, tmp_path, case):
    """The port's multi-block exact job equals the JAX CLI's XLA job on the
    same HIS files within 1e-4 of max|JAX|, in every slice."""
    det, number_type, flags, blocks = CASES[case]
    scan = scans(det, number_type)
    ref = _jax_volume(scan, tmp_path, flags)
    got, done = _port(scan, tmp_path, "port", flags)
    assert done == list(range(blocks))
    _close(got, ref)


def test_offset_resume_after_max_blocks(scans, tmp_path):
    """--max-blocks 2 at an offset writes blocks 0 and 1; --resume writes
    the rest, and the volume equals the JAX job's."""
    scan = scans(_det(delta_s=4.6, delta_t=-6.5), "f32")
    flags = ["--block-dz", "12", "--chunk-size", "16"]
    ref = _jax_volume(scan, tmp_path, flags)
    _, done = _port(scan, tmp_path, "r", flags + ["--max-blocks", "2"])
    assert done == [0, 1]
    got, done = _port(scan, tmp_path, "r", flags + ["--resume"])
    assert done == [0, 1, 2, 3, 4]
    _close(got, ref)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_offset_two_rank_cli(scans, tmp_path):
    """Two gloo ranks through the CLI at an offset (started as
    tests/test_torch_distributed.py starts them): byte for byte the
    one-process job, and within 1e-4 of the JAX job."""
    scan = scans(_det(delta_s=4.6, delta_t=-6.5), "u16")
    flags = ["--block-dz", "24", "--chunk-size", "8"]
    argv = _argv(scan, tmp_path / "mh", "v", "torch", flags + [
        "--distributed", "--coordinator", f"127.0.0.1:{_free_port()}",
        "--num-processes", "2"])
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
    path = str(tmp_path / "mh" / "v.ddbvf")
    assert json.load(open(path + ".manifest.json"))[
        "completed_blocks"] == [0, 1, 2]
    single, _ = _port(scan, tmp_path, "one", flags)
    with open(path, "rb") as f, \
            open(str(tmp_path / "one.ddbvf"), "rb") as g:
        assert f.read() == g.read()
    _close(single, _jax_volume(scan, tmp_path, flags))


# --------------------------------------------------------- band coverage

ANGLES_DEG = np.arange(0.0, 360.0, 1.5)


def _tapped_rows(det, vol, z0, dz, roi=(0, 0, 0), dims=None):
    """Brute force: [lo, hi) of the detector rows the backprojection's
    bilinear taps read for the voxels of slices [z0, z0 + dz) (global z
    of ``vol``) at every angle of ``ANGLES_DEG``, with the float32
    constants and operations of ``backproject_chunk_torch`` (its own
    ``v_min``); (n_col, 0) when no voxel is on the detector.  ``roi``
    and ``dims`` (nx, ny) cut the voxel columns to a region."""
    k = kernel_constants(make_bp_grid(det, vol))
    nx, ny = dims or (vol.dim_x, vol.dim_y)
    f32 = np.float32
    xs = (np.arange(roi[0], roi[0] + nx, dtype=f32) * f32(k["l_vx_x"])
          + f32(k["off_x"]))[None, None, :]
    ys = (np.arange(roi[1], roi[1] + ny, dtype=f32) * f32(k["l_vx_y"])
          + f32(k["off_y"]))[None, :, None]
    zs = (np.arange(z0, z0 + dz, dtype=f32) * f32(k["l_vx_z"])
          + f32(k["off_z"]))
    phi = np.deg2rad(ANGLES_DEG).astype(f32)
    sin, cos = np.sin(phi)[:, None, None], np.cos(phi)[:, None, None]
    s = xs * cos + ys * sin
    t = -xs * sin + ys * cos
    denom = s + f32(k["d_so"])
    safe = denom > f32(k["safe_min"])
    inv = np.where(safe, f32(1.0) / np.where(safe, denom, f32(1.0)), f32(0.0))
    factor = inv * f32(k["d_sd"])
    h = (t * factor - f32(k["h_min"])) * f32(k["inv_lpr"]) - f32(0.5)
    h0 = np.floor(h)
    on = safe & (h0 >= 0) & (h0 <= det.n_row - 2)
    fscale = factor * f32(k["inv_lpc"])
    lo, hi = det.n_col, 0
    for z in zs:
        v0 = np.floor(z * fscale + f32(k["vb"]))
        valid = on & (v0 >= 0) & (v0 <= det.n_col - 2)
        if valid.any():
            rows = v0[valid]
            lo = min(lo, int(rows.min()))
            hi = max(hi, int(rows.max()) + 2)     # the tap row below too
    return max(lo, 0), min(hi, det.n_col)


def _parity_examples(test):
    """Each job's detector of ``CASES`` as a fixed example of the property
    test, in as many blocks as the job runs."""
    for det, _, flags, blocks in CASES.values():
        test = example(
            n_row=det.n_row, n_col=det.n_col, l_px_row=det.l_px_row,
            l_px_col=det.l_px_col, delta_s=det.delta_s, delta_t=det.delta_t,
            d_so=det.d_so, d_od=det.d_od, n_blocks=blocks,
            roi="--roi" in flags)(test)
    return test


@settings(max_examples=60, deadline=None, derandomize=True)
@given(n_row=st.integers(16, 40), n_col=st.integers(16, 80),
       l_px_row=st.sampled_from([0.75, 1.0, 2.0, 3.0]),
       l_px_col=st.sampled_from([0.75, 1.0, 1.5, 2.0, 3.0]),
       delta_s=st.floats(-8.0, 8.0), delta_t=st.floats(-12.0, 12.0),
       d_so=st.floats(150.0, 1200.0), d_od=st.floats(80.0, 800.0),
       n_blocks=st.integers(1, 8), roi=st.booleans())
@_parity_examples
def test_band_covers_every_tap(n_row, n_col, l_px_row, l_px_col, delta_s,
                               delta_t, d_so, d_od, n_blocks, roi):
    """Every detector row the backprojection's taps reach over a block's
    voxels, at any angle, lies inside ``detector_row_band`` of the block,
    for every block of a plan: of the full volume, or of an ROI that
    starts at z1 > 0 (the job's global z0 + z1)."""
    det = port_geometry.DetectorGeometry(n_row, n_col, l_px_row, l_px_col,
                                         delta_s, delta_t, d_so, d_od, 1.0)
    full = port_geometry.derive_volume_geometry(det)
    if full.dim_z < 4 or full.dim_x < 4:
        return
    cut, origin, dims = full, (0, 0, 0), None
    if roi:
        box = port_geometry.RegionOfInterest(
            x1=full.dim_x // 4, x2=full.dim_x - 2, y1=1,
            y2=full.dim_y * 3 // 4, z1=full.dim_z // 5,
            z2=full.dim_z - 1 - full.dim_z // 7)
        cut = port_geometry.apply_roi(full, box)
        origin, dims = (box.x1, box.y1, box.z1), (cut.dim_x, cut.dim_y)
    info = port_geometry.plan_z_blocks(cut, block_dz=-(-cut.dim_z // n_blocks))
    for block in info.blocks:
        z0, dz = block.z0 + origin[2], block.dim_z_padded
        lo, hi = port_geometry.detector_row_band(det, full, z0, dz)
        t_lo, t_hi = _tapped_rows(det, full, z0, dz, roi=origin, dims=dims)
        assert t_lo >= t_hi or lo <= t_lo and t_hi <= hi, \
            (det, z0, dz, (lo, hi), (t_lo, t_hi))


# ------------------------------------------------------------- fast mode

@pytest.mark.parametrize("case,block_dz", [
    ("dt-6.5_ds4.6_u16", "13"), ("dt3_u16", "8"), ("dt-2_ds3_dz9", "7")])
def test_offset_fast_mode_against_golden(scans, tmp_path, case, block_dz):
    """The fast multi-block job at an offset: within 1e-3 relative RMSE of
    golden_fdk_stream over the stored frames, and byte for byte the
    one-block fast job (the band cuts rows after the whole-frame
    quantization, so the blocks see the rows one block sees)."""
    det, number_type = CASES[case][:2]
    scan = scans(det, number_type)
    split, done = _port(scan, tmp_path, "split", ["--block-dz", block_dz],
                        accuracy="fast")
    assert len(done) >= 3
    _, one = _port(scan, tmp_path, "one", [], accuracy="fast")
    assert one == [0]
    with open(tmp_path / "split.ddbvf", "rb") as f, \
            open(tmp_path / "one.ddbvf", "rb") as g:
        assert f.read() == g.read()
    vol = jax_geometry.derive_volume_geometry(det)
    frames = np.concatenate([read_his(os.path.join(scan[0], n))
                             for n in sorted(os.listdir(scan[0]))])
    np.testing.assert_array_equal(frames, scan[2])
    angles = np.arange(N_PROJ, dtype=np.float32) * det.delta_phi
    (ref,) = golden_fdk_stream(zip(frames, angles), det, vol,
                               [(0, vol.dim_z)], dtype=np.float32)
    rmse = np.sqrt(np.mean((split.astype(np.float64) - ref) ** 2)) \
        / np.abs(ref).max()
    assert rmse <= 1e-3, rmse


# ------------------------------------------- the card's runner, shrunk

def test_offset_detector_runner(tmp_path):
    """``benchmarks.offset_detector`` (the card's offset-detector jobs,
    ``chip_smoke.py`` phase 9) at a 48 x 40 detector on the CPU: both
    modes' jobs pass every gate (seams and interior slab against the
    golden oracle, the split and world-1 distributed files byte for byte
    the one-block file); off the card the auto plan is one block."""
    from paris_tpu_torch.benchmarks import offset_detector
    res = offset_detector.main([
        "--size", "48", "--rows", "40", "--n-proj", "24", "--split-dz",
        "24", "--backend", "torch", "--shards", "2", "--workdir",
        str(tmp_path / "w"), "--out", str(tmp_path / "od.json")])
    assert res["pass"] and res["failures"] == []
    assert res["volume"] == [53, 57, 57]
    fast, exact = res["modes"]["fast"], res["modes"]["exact"]
    assert (fast["number_type"], exact["number_type"]) == ("uint16",
                                                           "float32")
    assert fast["slabs"] == [(22, 4), (46, 4), (48, 4)]
    assert set(fast["jobs"]) == {"auto", "split", "split distributed"}
    assert set(exact["jobs"]) == {"auto", "split"}
    for mode in (fast, exact):
        assert mode["jobs"]["auto"]["blocks"] == 1
        assert mode["jobs"]["split"]["blocks"] == 3
        assert mode["jobs"]["split"]["same_bytes"]
    assert fast["jobs"]["split distributed"]["same_bytes"]
    assert json.load(open(tmp_path / "od.json"))[0]["name"] == \
        "offset_detector_48x40_24proj"
