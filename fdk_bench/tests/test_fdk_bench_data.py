"""The frozen generator, HIS writer, ddbvf reader and geometry: seeded
and deterministic, and equal to the program's own where they are its
copies (tests may import both)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fdk_bench.lib import phantom
from fdk_bench.lib.ddbvf import read_volume
from fdk_bench.lib.geometry import Scan, derive_volume, row_band, scan_from
from fdk_bench.lib.his import his_bytes, write_his_u16
from fdk_bench.tests.conftest import TINY

from paris_tpu_torch.geometry import (DetectorGeometry,
                                      derive_volume_geometry,
                                      detector_row_band)

SCANS = [scan_from(TINY),
         Scan(1248, 960, 0.308, 0.308, 0.0, 0.0, 785.0, 415.0, 360 / 496),
         Scan(1248, 960, 0.308, 0.308, -7.5, 0.0, 785.0, 415.0, 360 / 496),
         Scan(2048, 2048, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0, 0.1),
         Scan(512, 384, 1.0, 1.0, 4.6, -6.5, 900.0, 300.0, 1.0)]


def _det(s: Scan) -> DetectorGeometry:
    return DetectorGeometry(**dataclasses.asdict(s))


@pytest.mark.parametrize("s", SCANS, ids=range(len(SCANS)))
def test_geometry_is_the_programs(s):
    v = derive_volume(s)
    pv = derive_volume_geometry(_det(s))
    assert (v.dim_x, v.dim_y, v.dim_z, v.l_vx) == (
        pv.dim_x, pv.dim_y, pv.dim_z, pv.l_vx_x)
    for z0, dz in ((0, 8), (v.dim_z // 3, 40), (v.dim_z - 16, 16)):
        assert row_band(s, v, z0, dz) == detector_row_band(_det(s), pv, z0,
                                                           dz)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 11, 2 ** 40 + 3])
def test_generator_is_seeded_and_never_clips(seed):
    s = scan_from(TINY)
    v = derive_volume(s)
    a = phantom.Projector(s, v, seed, "cpu").counts(np.arange(6))
    b = phantom.Projector(s, v, seed, "cpu").counts(np.arange(6))
    c = phantom.Projector(s, v, seed + 1, "cpu").counts(np.arange(6))
    assert a.dtype == torch.int16 and a.shape == (6, s.n_col, s.n_row)
    assert torch.equal(a, b) and not torch.equal(a, c)
    counts = phantom.as_float(a)
    assert 0 < float(counts.max()) <= phantom.U16_MAX
    assert phantom.ellipsoids(seed).shape == phantom.SHEPP_LOGAN.shape


def test_projector_is_the_programs(monkeypatch):
    from paris_tpu_torch.phantom import cone_beam_project_torch
    monkeypatch.setattr(phantom, "ellipsoids",
                        lambda seed: phantom.SHEPP_LOGAN.copy())
    s = SCANS[4]
    v = derive_volume(s)
    p = phantom.Projector(s, v, 0, "cpu").line_integrals(np.arange(3))
    q = cone_beam_project_torch(_det(s), np.arange(3) * s.delta_phi,
                                phantom.phantom_scale(v), device="cpu")
    torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-4)


def test_his_writer_is_read_by_the_program(tmp_path):
    from paris_tpu_torch.io.his import read_his_raw, write_his
    frames = np.random.default_rng(3).integers(
        0, 65536, size=(3, 5, 7)).astype(np.uint16)
    a, b = str(tmp_path / "a.his"), str(tmp_path / "b.his")
    assert write_his_u16(a, frames) == his_bytes(3, 5, 7) == \
        os.path.getsize(a)
    write_his(b, frames, number_dtype=np.uint16)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(read_his_raw(a), frames)


def test_ddbvf_reader_reads_the_programs(tmp_path):
    from paris_tpu_torch.io import ddbvf
    vol = np.random.default_rng(5).standard_normal((4, 3, 5)).astype(
        np.float32)
    path = ddbvf.create(str(tmp_path / "v.ddbvf"), 5, 3, 4)
    ddbvf.write_slices(path, vol, 0)
    np.testing.assert_array_equal(read_volume(path), vol)
