"""The five BASELINE configs on the card (the counterpart of
``benchmarks/run_configs.py``).

    python -m paris_tpu_torch.benchmarks.run_configs [--configs 1,2,3,4,5] [--backend torch] [--out F]

  1. Shepp-Logan 64³, 180 projections: RMSE gate against the golden oracle
  2. 256-class: step throughput in both modes, and the RMSE gate of a
     decimated scan (``PARIS_BENCH_CFG2_NPROJ``, 90) in both modes
  3. 1024-class streaming blocks: ``run_job`` over HIS files
     (``PARIS_BENCH_CFG3_NPROJ``, 64) in two 512-slice blocks, chunk 8, in
     both modes; gates on the slab straddling the seam and on each slice
     beside it
  4. offset-detector ROI: RMSE gate on the ROI crop, reconstructed in one
     block and by ``run_job`` from HIS files in blocks of
     ``CFG4_BLOCK_DZ`` slices (each block fed only its band of detector
     rows)
  5. the distributed path at world size 1: step throughput of a
     ``DistributedReconstructor`` in a group of one (NCCL on the card,
     gloo with ``--backend torch``), made by ``multihost.initialize`` and
     destroyed afterwards

Names, keys and gates (relative RMSE = RMSE / max|golden| <= 1e-3) are the
JAX driver's.  What differs:
  * the throughputs (configs 2 and 5) time ``step_staged`` on a float32
    chunk already on the device, as ``bench`` does, between CUDA events on
    the card;
  * config 2's and 3's scans come from the analytic projector on the
    backend's device (``config3_stream.cached_scan``: HIS files of 8
    float32 frames) and their golden oracle reads the same frames, as one
    process per core (``golden_slab``); configs 1 and 4 take the NumPy
    projector, as the JAX driver does;
  * config 5's block is ceil(dim_z / world) x world slices: the TPU's
    rounding to 128 slices per device is not carried over;
  * an exception is recorded as ``{"config", "name", "error"}`` and the
    next config runs; once all have run, ``main`` exits non-zero if one
    raised or failed its gate.
Every record names its device (``card_record``).  The list goes to
``results/run_configs.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
import traceback
from typing import Optional

import numpy as np

from ..app import ReconstructionJob, run_job
from ..geometry import (DetectorGeometry, RegionOfInterest, apply_roi,
                        derive_volume_geometry)
from ..golden import golden_fdk
from ..io import ddbvf
from ..io.his import read_his, write_his
from ..io.source import scan_directory
from ..parallel import multihost
from ..parallel.dist import DistributedReconstructor
from ..parallel.mesh import world_and_rank
from ..phantom import cone_beam_project
from ..pipeline import Reconstructor, reconstruct, resolve_backend
from .bench import bench_inputs, staged_chunk, step_ms
from .full_scale_2048_3600 import (GATE_RMSE, RESULTS_DIR, card_record,
                                   record_result, rel_rmse)
from .config3_stream import SCAN_SUBDIR, cached_scan
from .golden_slab import finish_shards, stop_shards

__all__ = ["NAMES", "CONFIGS", "config1", "config2", "config3", "config4",
           "config5", "main"]

NAMES = {1: "shepp_logan_64", 2: "single_chip_256",
         3: "streaming_1024_blocks", 4: "offset_detector_roi",
         5: "mesh_scaling"}
GATE = f"<= {GATE_RMSE:g}"
DET_256 = DetectorGeometry(256, 256, 1.0, 1.0, 0.0, 0.0, 2048.0, 1024.0, 0.5)
CFG4_BLOCK_DZ = 16       # config 4's forced blocks: 16 + 16 + 8 ROI slices


def config1(backend: str = "cuda", volumes: Optional[dict] = None) -> dict:
    """64³ Shepp-Logan, 180 projections, against the golden oracle.
    ``volumes`` (a dict) receives the reconstruction as ``ours`` and the
    oracle's volume as ``golden``."""
    det = DetectorGeometry(64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
    vol = derive_volume_geometry(det)
    angles = np.arange(180, dtype=np.float32) * 2.0
    projs = cone_beam_project(det, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.9)
    t0 = time.perf_counter()
    ours = reconstruct(det, vol, projs, angles, chunk_size=16,
                       backend=backend)
    dt = time.perf_counter() - t0
    golden = golden_fdk(projs, angles, det, vol)
    rmse = rel_rmse(ours, golden)
    if volumes is not None:
        volumes.update(ours=ours, golden=golden)
    return {"config": 1, "name": NAMES[1], "rel_rmse_vs_golden": rmse,
            "gate": GATE, "pass": rmse <= GATE_RMSE, "seconds": round(dt, 3),
            **card_record(resolve_backend(backend)[1])}


def _throughput(rec: Reconstructor, reps: int) -> float:
    """Gupd/s of ``rec.step_staged`` on the bench's staged float32 chunk,
    after one warm-up step (the update count is the whole block's: every
    rank of a group backprojects every projection into its slab)."""
    staged = staged_chunk(rec, *bench_inputs(rec.det, rec.chunk_size))
    v = rec.init_block()
    ms = step_ms(rec.device, lambda: rec.step_staged(v, staged), reps)
    dz, ny, nx = rec.block_shape
    return dz * ny * nx * rec.chunk_size / ms / 1e6


def config2(backend: str = "cuda", det: DetectorGeometry = DET_256,
            n_proj: int = 720, n_corr: Optional[int] = None,
            shards: Optional[int] = None) -> dict:
    """256-class: the step's Gupd/s in both modes (``n_proj`` / 8 steps at
    most, as the JAX driver counts them), then the RMSE gate of an
    ``n_corr``-projection scan (``PARIS_BENCH_CFG2_NPROJ``, 90) in both
    modes against the golden oracle over the whole volume, computed by
    ``shards`` processes (default one per core) that tail the scan's
    synthesis and run on while the two reconstructions do."""
    chunk = 8
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    out = {"config": 2, "name": NAMES[2], "volume": vol.shape_zyx,
           **card_record(device)}
    reps = min(max(1, n_proj // chunk),
               max(3, int(2e10 / (vol.voxels * chunk))))
    for acc in ("exact", "fast"):
        rec = Reconstructor(det, vol, chunk_size=chunk, backend=backend,
                            accuracy=acc)
        out[f"gupd_per_s_{acc}"] = round(_throughput(rec, reps), 2)
        out["backend"] = rec.backend

    if n_corr is None:
        n_corr = int(os.environ.get("PARIS_BENCH_CFG2_NPROJ", "90"))
    scan_det = dataclasses.replace(det, delta_phi=360.0 / n_corr)
    slabs = [(0, vol.dim_z)]
    with tempfile.TemporaryDirectory(prefix="paris_cfg2_") as workdir:
        _, procs = cached_scan(workdir, scan_det, n_corr, device, slabs,
                               shards or os.cpu_count() or 1)
        try:
            projs = np.concatenate([read_his(p) for p in scan_directory(
                os.path.join(workdir, SCAN_SUBDIR))])
            angles = np.arange(n_corr, dtype=np.float32) * scan_det.delta_phi
            recs = {acc: Reconstructor(det, vol, chunk_size=chunk,
                                       backend=backend, accuracy=acc).run(
                projs, angles) for acc in ("exact", "fast")}
        except BaseException:
            stop_shards(procs)
            raise
        golden = finish_shards(procs, workdir, slabs)[0]
    rmse = {acc: rel_rmse(v, golden) for acc, v in recs.items()}
    out["n_proj_gate"] = n_corr
    out["rel_rmse_vs_golden"] = rmse
    out["gate"] = GATE
    out["pass"] = all(v <= GATE_RMSE for v in rmse.values())
    return out


def config3(backend: str = "cuda", det: Optional[DetectorGeometry] = None,
            n_proj: Optional[int] = None, shards: Optional[int] = None
            ) -> dict:
    """1024-class streaming: a phantom scan (``n_proj``, default
    ``PARIS_BENCH_CFG3_NPROJ`` or 64) synthesized as HIS files
    (``config3_stream.cached_scan``), reconstructed by ``run_job`` in
    forced blocks of 512 slices (half the volume below 1024 slices) in both
    modes; the 4-slice slab straddling the first seam, and each slice
    beside the seam, against the golden oracle over the stored frames,
    computed by ``shards`` processes (default one per core) that tail the
    synthesis and are joined before the jobs run.  ``det`` shrinks it
    (its ``delta_phi`` is set to 360 / n_proj)."""
    if n_proj is None:
        n_proj = int(os.environ.get("PARIS_BENCH_CFG3_NPROJ", "64"))
    base = det or DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0,
                                   2048.0, 1024.0, 1.0)
    # run_job derives the angles from delta_phi (idx * delta_phi)
    det = dataclasses.replace(base, delta_phi=360.0 / n_proj)
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    block_dz = 512 if vol.dim_z > 512 else vol.dim_z // 2
    chunk = 8
    seam0 = max(0, block_dz - 2)            # slab straddling the seam
    slabs = [(seam0, 4)]
    res = {"config": 3, "name": NAMES[3], "volume": vol.shape_zyx,
           "n_proj": n_proj, "block_dz": block_dz, "seam_slab_z0": seam0,
           "chunk_size": chunk, **card_record(device)}
    rmse = {}
    with tempfile.TemporaryDirectory(prefix="paris_cfg3_") as d:
        _, procs = cached_scan(d, det, n_proj, device, slabs,
                               shards or os.cpu_count() or 1)
        golden = finish_shards(procs, d, slabs)[seam0]
        for acc in ("exact", "fast"):
            job = ReconstructionJob(
                det=det, input_path=os.path.join(d, SCAN_SUBDIR),
                output_path=d, prefix=f"c3{acc}", chunk_size=chunk,
                block_dz=block_dz, accuracy=acc, backend=backend)
            t0 = time.perf_counter()
            out = run_job(job)
            dt = time.perf_counter() - t0
            res[f"seconds_{acc}"] = round(dt, 1)
            res[f"gupd_per_s_end_to_end_{acc}"] = round(
                vol.voxels * n_proj / dt / 1e9, 2)
            slab = ddbvf.read_slices(out, seam0, slabs[0][1])
            os.remove(out)
            rmse[acc] = rel_rmse(slab, golden)
            # a wrong write offset or a bad boundary block would blow up
            # one of the two slices at the seam
            rmse[acc + "_below_seam"] = rel_rmse(slab[1], golden[1])
            rmse[acc + "_above_seam"] = rel_rmse(slab[2], golden[2])
    res["rel_rmse_vs_golden_seam_slab"] = rmse
    res["gate"] = GATE
    res["pass"] = all(v <= GATE_RMSE for v in rmse.values())
    return res


def _job_blocks(det, projs, roi, block_dz, backend):
    """The ROI crop as ``run_job`` writes it from HIS files of ``projs`` in
    z-blocks of ``block_dz`` slices (exact mode); returns (crop, number of
    blocks)."""
    with tempfile.TemporaryDirectory(prefix="paris_cfg4_") as d:
        pdir = os.path.join(d, "proj")
        os.makedirs(pdir)
        write_his(os.path.join(pdir, "scan.his"), projs)
        out = run_job(ReconstructionJob(
            det=det, input_path=pdir, output_path=d, prefix="c4", roi=roi,
            chunk_size=16, block_dz=block_dz, accuracy="exact",
            backend=backend))
        with open(out + ".manifest.json") as f:
            blocks = len(json.load(f)["completed_blocks"])
        return ddbvf.read_volume(out), blocks


def config4(backend: str = "cuda", volumes: Optional[dict] = None) -> dict:
    """Offset-detector ROI at a reduced size, against the golden oracle on
    the same crop, in one block and in ``run_job``'s banded blocks (the
    rows each block samples move with the vertical offset).  ``volumes`` receives the
    reconstructions as ``ours`` and ``ours_blocks`` and the oracle's crop
    as ``golden``."""
    det = DetectorGeometry(96, 80, 2.0, 2.0, 4.6, -1.5, 500.0, 500.0, 3.0)
    vol = derive_volume_geometry(det)
    angles = np.arange(120, dtype=np.float32) * 3.0
    projs = cone_beam_project(det, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.8)
    roi = RegionOfInterest(x1=20, x2=69, y1=25, y2=64, z1=10, z2=49)
    roi_geo = apply_roi(vol, roi)
    ours = reconstruct(det, vol, projs, angles, chunk_size=16,
                       backend=backend,
                       roi_offset=(roi.x1, roi.y1, roi.z1),
                       block_shape=roi_geo.shape_zyx)
    golden = golden_fdk(projs, angles, det, vol, dz=roi_geo.dim_z,
                        dy=roi_geo.dim_y, dx=roi_geo.dim_x,
                        roi_offset=(roi.x1, roi.y1, roi.z1))
    blocks, n_blocks = _job_blocks(det, projs, roi, CFG4_BLOCK_DZ, backend)
    rmse = rel_rmse(ours, golden)
    rmse_blocks = rel_rmse(blocks, golden)
    if volumes is not None:
        volumes.update(ours=ours, ours_blocks=blocks, golden=golden)
    return {"config": 4, "name": NAMES[4], "rel_rmse_vs_golden": rmse,
            "blocks": n_blocks, "rel_rmse_vs_golden_blocks": rmse_blocks,
            "gate": GATE,
            "pass": rmse <= GATE_RMSE and rmse_blocks <= GATE_RMSE,
            **card_record(resolve_backend(backend)[1])}


def config5(backend: str = "cuda", det: DetectorGeometry = DET_256
            ) -> dict:
    """The distributed step's Gupd/s in a process group made here (a group
    of one, or torchrun's), fast mode, a block of ceil(dim_z / world) x
    world slices, 8 x world projections per step; the group is destroyed
    afterwards."""
    device = multihost.initialize(backend=backend)
    try:
        world, _ = world_and_rank()
        vol = derive_volume_geometry(det)
        block = -(-vol.dim_z // world) * world
        chunk = 8 * world
        rec = DistributedReconstructor(
            det, vol, chunk_size=chunk, backend=backend, accuracy="fast",
            block_shape=(block, vol.dim_y, vol.dim_x), device=device)
        gups = _throughput(rec, 20)
        return {"config": 5, "name": NAMES[5], "mesh_devices": world,
                "backend": rec.backend, "block_dz": block,
                "chunk_size": chunk, "gupd_per_s_total": round(gups, 2),
                "gupd_per_s_per_device": round(gups / world, 2),
                **card_record(device)}
    finally:
        multihost.shutdown()


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "run_configs.json"))
    args = ap.parse_args(argv)
    results, failed = [], []
    for cid in [int(c) for c in args.configs.split(",")]:
        try:
            r = CONFIGS[cid](backend=args.backend)
        except Exception as e:  # record it, run the next config
            traceback.print_exc()
            r = {"config": cid, "name": NAMES[cid],
                 "error": f"{type(e).__name__}: {e}"}
        if "error" in r or r.get("pass") is False:
            failed.append(cid)
        print(json.dumps(r), flush=True)
        record_result(args.out, r)
        results.append(r)
    if failed:
        raise SystemExit(f"run_configs: config(s) {failed} raised or "
                         "failed a gate")
    return {"results": results}


if __name__ == "__main__":
    main()
