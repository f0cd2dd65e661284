"""The detector-row band of paris_tpu_torch (plain backprojection,
Reconstructor, run_job) and the write-overlap planning of run_job,
against the unbanded port and the JAX package (CPU torch, CPU JAX).

The 160-row detector and its 4-block split are those of
tests/test_distributed.py:128-131."""

import dataclasses
import logging
import types

import numpy as np
import pytest
import torch

from paris_tpu import geometry as jax_geometry
from paris_tpu import pipeline as jax_pipeline
from paris_tpu.io import ddbvf
from paris_tpu.io.his import write_his
from paris_tpu_torch.geometry import (DetectorGeometry,
                                      derive_volume_geometry,
                                      detector_row_band, plan_z_blocks)
from paris_tpu_torch.app import (ReconstructionJob, _overlap_block_dz,
                                 _plan_write_overlap, run_job)
from paris_tpu_torch.ops.backprojection_torch import (backproject_chunk_torch,
                                                      make_bp_grid)
from paris_tpu_torch.pipeline import Reconstructor

TALL = DetectorGeometry(n_row=64, n_col=160, l_px_row=2.0, l_px_col=2.0,
                        delta_s=0.0, delta_t=0.0, d_so=400.0, d_od=400.0,
                        delta_phi=9.0)


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
def tall():
    vol = derive_volume_geometry(TALL)
    rng = np.random.default_rng(4)
    projs = rng.standard_normal((8, TALL.n_col, TALL.n_row)).astype(np.float32)
    angles = np.arange(8, dtype=np.float32) * 9.0
    return TALL, vol, projs, angles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_plain_banded_equals_unbanded(tall, index, dtype):
    """At every block of a 4-block split, the plain backprojection of the
    block's band of rows equals the one of the whole detector exactly:
    the band holds every tap the block reads."""
    det, vol, projs, angles = tall
    info = plan_z_blocks(vol, block_dz=-(-vol.dim_z // 4))
    assert info.num == 4
    block = info.blocks[index]
    lo, hi = detector_row_band(det, vol, block.z0, block.dim_z_padded)
    assert hi - lo < det.n_col
    phi = np.deg2rad(angles)
    sin, cos = torch.from_numpy(np.sin(phi)), torch.from_numpy(np.cos(phi))
    full = torch.from_numpy(projs).to(dtype)
    band = full[:, lo:hi].contiguous()
    grid = make_bp_grid(det, vol)
    shape = (block.dim_z_padded, vol.dim_y, vol.dim_x)
    ref = backproject_chunk_torch(torch.zeros(shape), full, sin, cos, grid,
                                  z_offset=block.z0)
    got = backproject_chunk_torch(torch.zeros(shape), band, sin, cos, grid,
                                  z_offset=block.z0, v_lo=lo)
    assert float(ref.abs().max()) > 0
    assert torch.equal(got, ref)


def test_reconstructor_band_matches_jax(tall):
    """Reconstructor(v_band_width=128) on a z-sub-block against the JAX
    pipeline (tests/test_distributed.py:126-149), and bit for bit against
    the unbanded Reconstructor."""
    det, vol, projs, angles = tall
    dz, z0 = 16, vol.dim_z // 2
    block = (dz, vol.dim_y, vol.dim_x)
    rec = Reconstructor(det, vol, chunk_size=8, backend="torch",
                        block_shape=block, v_band_width=128)
    assert rec._vp == 128 and rec._v_band_lo(z0) > 0
    out = rec.run(projs, angles, z_offset=z0)
    full = jax_pipeline.reconstruct(
        jax_geometry.DetectorGeometry(**dataclasses.asdict(det)),
        jax_geometry.VolumeGeometry(**dataclasses.asdict(vol)), projs, angles,
        chunk_size=8, backend="xla")
    np.testing.assert_allclose(out, full[z0:z0 + dz], rtol=1e-4, atol=1e-4)
    unbanded = Reconstructor(det, vol, chunk_size=8, backend="torch",
                             block_shape=block).run(projs, angles,
                                                    z_offset=z0)
    np.testing.assert_array_equal(out, unbanded)


def test_v_band_lo_raises_when_too_narrow(tall):
    det, vol, projs, angles = tall
    rec = Reconstructor(det, vol, chunk_size=8, backend="torch",
                        block_shape=(40, vol.dim_y, vol.dim_x),
                        v_band_width=16)
    with pytest.raises(ValueError, match="too narrow"):
        rec._v_band_lo(40)
    with pytest.raises(ValueError, match="too narrow"):
        rec.run(projs, angles, z_offset=40)


@pytest.fixture(scope="module")
def tall_scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("tall")
    rng = np.random.default_rng(11)
    frames = rng.uniform(0, 60000, (16, TALL.n_col, TALL.n_row)).astype(
        np.uint16)
    pdir = root / "proj"
    pdir.mkdir()
    for i in range(0, 16, 8):
        write_his(str(pdir / f"b{i:03d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)
    return str(pdir)


def _job(pdir, out, **kw):
    return ReconstructionJob(det=TALL, input_path=pdir, output_path=str(out),
                             chunk_size=8, backend="torch", accuracy="exact",
                             **kw)


def test_multi_block_banded_run_job_matches_single_block(tall_scan, tmp_path,
                                                         caplog):
    with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
        banded = run_job(_job(tall_scan, tmp_path, prefix="b", block_dz=40))
    assert any("detector row band: 51 of 160 rows" in m
               for m in caplog.messages)
    whole = run_job(_job(tall_scan, tmp_path, prefix="w"))
    got, ref = ddbvf.read_volume(banded), ddbvf.read_volume(whole)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_overlap_block_dz():
    """None when two accumulators already fit (or nothing above 128
    slices does), else the largest aligned extent whose two accumulators
    fit; ``n_shards`` counts one rank's share."""
    vol = types.SimpleNamespace(dim_x=64, dim_y=64)
    per_slice, proj = 4 * 64 * 64, 1000
    assert _overlap_block_dz(vol, None, proj, 512) is None
    assert _overlap_block_dz(vol, 2 * per_slice * 512 + proj, proj,
                             512) is None
    assert _overlap_block_dz(vol, 2 * per_slice * 300 + proj, proj,
                             512) == 296
    assert _overlap_block_dz(vol, per_slice * 300 + proj, proj, 512,
                             n_shards=2, align=16) == 288
    assert _overlap_block_dz(vol, 2 * per_slice * 100, proj, 512) is None


def test_plan_write_overlap_and_its_switch(monkeypatch):
    vol = types.SimpleNamespace(dim_x=64, dim_y=64, dim_z=1024)
    per_slice, proj = 4 * 64 * 64, 1000
    info = plan_z_blocks(vol, block_dz=512)
    free = 2 * per_slice * 300 + proj
    job = types.SimpleNamespace(block_dz=None)
    adjusted, overlap = _plan_write_overlap(
        job, vol, info, free, proj, hbm_budget=None, proj_buffer=proj)
    assert adjusted.dim_z_padded <= 296 and overlap
    # a forced extent is kept; the overlap then does not fit
    forced, overlap = _plan_write_overlap(
        types.SimpleNamespace(block_dz=512), vol, info, free, proj,
        hbm_budget=None, proj_buffer=proj)
    assert forced is info and not overlap
    monkeypatch.setenv("PARIS_WRITE_OVERLAP", "0")
    kept, overlap = _plan_write_overlap(
        job, vol, info, free, proj, hbm_budget=None, proj_buffer=proj)
    assert kept is info and not overlap


def test_write_overlap_switch_run_job(tall_scan, tmp_path, caplog,
                                      monkeypatch):
    """PARIS_WRITE_OVERLAP=0 turns the writer overlap off and changes no
    byte of the output."""
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("PARIS_WRITE_OVERLAP", flag)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="paris_tpu_torch.app"):
            outs[flag] = ddbvf.read_volume(run_job(_job(
                tall_scan, tmp_path / flag, prefix="o", block_dz=40)))
        assert any("z-split: 4 block(s)" in m for m in caplog.messages)
        said = any("write overlap" in m for m in caplog.messages)
        assert said == (flag == "1")
    np.testing.assert_array_equal(outs["1"], outs["0"])
