"""The plain reference against the program's plain path (``--backend
torch``) at a tiny size, and its lower-precision control."""

import dataclasses

import numpy as np
import pytest
import torch

from fdk_bench.lib import phantom
from fdk_bench.lib.geometry import derive_volume, scan_from
from fdk_bench.reference.compare import rel_rmse, judge
from fdk_bench.reference.fdk import fdk_at_voxels
from fdk_bench.tests.conftest import TINY

from paris_tpu_torch.geometry import DetectorGeometry
from paris_tpu_torch.pipeline import Reconstructor


def _whole(scan, accuracy):
    det = DetectorGeometry(**dataclasses.asdict(scan))
    vol = derive_volume(scan)
    proj = phantom.Projector(scan, vol, 21, "cpu")
    idx = np.arange(int(TINY["scan"]["n_proj"]))
    from paris_tpu_torch.geometry import derive_volume_geometry
    rec = Reconstructor(det, derive_volume_geometry(det), chunk_size=8,
                        backend="torch", accuracy=accuracy)
    frames = proj.counts(idx).cpu().numpy().view(np.uint16)
    out = torch.from_numpy(rec.run(frames, idx * scan.delta_phi))
    zz, yy, xx = torch.meshgrid(*(torch.arange(n) for n in out.shape),
                                indexing="ij")
    vox = torch.stack([zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)], 1)
    return proj, idx, vol, vox, out.reshape(-1)


@pytest.mark.parametrize("delta_s", [0.0, -3.5])
def test_reference_is_the_programs_plain_path(delta_s):
    scan = dataclasses.replace(scan_from(TINY), delta_s=delta_s)
    proj, idx, vol, vox, got = _whole(scan, "exact")
    ref = fdk_at_voxels(lambda p: phantom.as_float(proj.counts(p)), idx,
                        scan, vol, vox, device="cpu", chunk=5)
    assert rel_rmse(got, ref) < 2e-6
    fast = _whole(scan, "fast")[4]
    assert 1e-6 < rel_rmse(fast, ref) < 1e-3


def test_control_is_coarser_than_the_program():
    scan = scan_from(TINY)
    proj, idx, vol, vox, got = _whole(scan, "fast")

    def frames(p):
        return phantom.as_float(proj.counts(p))

    ref = fdk_at_voxels(frames, idx, scan, vol, vox, device="cpu")
    lowp = {p: rel_rmse(fdk_at_voxels(frames, idx, scan, vol, vox,
                                      device="cpu", lowp=p), ref)
            for p in ("bfloat16", "float8_e4m3fn")}
    assert lowp["float8_e4m3fn"] > 3 * rel_rmse(got, ref)
    assert lowp["float8_e4m3fn"] > 1e-3 > lowp["bfloat16"]


def test_judge_and_rel_rmse():
    ref = torch.tensor([1.0, -2.0, 4.0])
    assert rel_rmse(ref, ref) == 0.0
    assert rel_rmse(torch.tensor([1.0, float("nan"), 4.0]), ref) == \
        float("inf")
    assert judge({"a": 1e-4}, {"a": 1e-3}) == (
        True, {"a": {"value": 1e-4, "limit": 1e-3}})
    assert not judge({"a": 2e-3}, {"a": 1e-3})[0]
    assert not judge({"a": float("nan")}, {"a": 1e-3})[0]
    assert not judge({}, {"a": 1e-3})[0]
