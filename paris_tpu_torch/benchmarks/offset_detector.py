"""The job at a vertically offset detector: multi-block jobs through the
CLI against the golden oracle and against the one-block job.

    python -m paris_tpu_torch.benchmarks.offset_detector [--size 512] [--rows 384] [--n-proj 256] [--split-dz 136] [--backend auto] [--workdir D] --out F

  * geometry: config 3's streaming detector (``config3_stream.geometry``:
    1 mm pixels, d_so 8 x size, d_od 4 x size), ``--size`` columns and
    ``--rows`` rows, offset by ``DELTA_S`` = 4.6 and ``DELTA_T`` = -6.5
    pixels; its derived volume (521 x 521 x 397 at the defaults);
  * per mode, a scan of ``--n-proj`` frames synthesized on the backend's
    device (``synth_c5_3600.synthesize``): fast mode from uint16 counts
    (HIS type 4), exact mode from float32 line integrals;
  * per mode, through ``cli.main``: the job's own plan ("auto"), a forced
    split in blocks of ``--split-dz`` slices, and the one-block plan (not
    run again when the auto plan is one block: that job is it); in fast
    mode also the split job over a world-1 process group
    (``--distributed``);
  * gates: every seam of every plan run (the slab z0 - 2 .. z0 + 1 about
    each block's first slice) and one interior slab, against
    ``golden_fdk_stream`` over the stored frames (``golden_slab``, one
    process per core, started once the auto job has shown its seams),
    relative RMSE <= 1e-3; the split, auto and distributed ddbvf files
    byte for byte the one-block file (the split file, for the
    distributed one); on the card, K1 launched blocks x chunks times per
    job.

A failed gate exits non-zero after the JSON is printed and recorded.
Writes the two scans and one volume per job (0.40 GiB each at the
defaults, six jobs), each volume removed once held.  The JSON goes to
``results/offset_detector.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import logging
import os
import time
from typing import List, Optional, Tuple

from .. import cli
from ..geometry import DetectorGeometry, derive_volume_geometry
from ..io import ddbvf
from ..io.geometry_file import dump_geometry_file
from ..ops.backprojection_cuda import backproject_chunk_cuda
from ..pipeline import resolve_backend
from .config3_stream import geometry as stream_geometry
from .config3_stream import workdir_or_temp
from .full_scale_2048_3600 import (GATE_RMSE, RESULTS_DIR, card_record,
                                   job_log_tap, record_result, rel_rmse)
from .golden_slab import finish_shards, start_shards, stop_shards
from .synth_c5_3600 import synthesize

__all__ = ["DELTA_S", "DELTA_T", "MODES", "geometry", "seam_slabs",
           "interior_slab", "failures", "run", "main"]

DELTA_S, DELTA_T = 4.6, -6.5     # detector offsets [px]
MODES = (("fast", "uint16"), ("exact", "float32"))
CHUNK = 16
SUBDIR = "proj"


def geometry(size: int, rows: int, n_proj: int) -> DetectorGeometry:
    """``size`` x ``rows`` pixels of config 3's streaming detector, offset
    by (``DELTA_S``, ``DELTA_T``), ``n_proj`` frames over 360 degrees."""
    return dataclasses.replace(stream_geometry(size, n_proj), n_col=rows,
                               delta_s=DELTA_S, delta_t=DELTA_T)


def seam_slabs(extent: int, dim_z: int) -> List[Tuple[int, int]]:
    """The 4-slice slab about each seam of a plan of ``extent`` slices."""
    return [(z - 2, 4) for z in range(extent, dim_z, extent)]


def interior_slab(extent: int, dim_z: int) -> Tuple[int, int]:
    """4 slices in the middle of the last block of ``extent`` slices."""
    last = (dim_z - 1) // extent * extent
    return ((last + dim_z) // 2 - 2, 4)


def _job(label, argv, out, n_chunks, on_card) -> dict:
    """One job through ``cli.main``: its seconds, blocks, extent, plan
    lines and band, and on the card K1's launches and whether they were
    blocks x chunks."""
    launches = backproject_chunk_cuda.launches
    with job_log_tap() as tap:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main ({label}) exited {rc}")
    with open(out + ".manifest.json") as f:
        manifest = json.load(f)
    blocks = len(manifest["completed_blocks"])
    r = {"seconds": seconds, "blocks": blocks,
         "block_dz": manifest.get("block_dz"), "plan": tap.plan,
         "band_rows": tap.band_rows, "out": out}
    if on_card:
        r["k1_launches"] = backproject_chunk_cuda.launches - launches
        r["k1_launches_ok"] = r["k1_launches"] == blocks * n_chunks
    return r


def _run_mode(work, det, vol, mode, number_type, n_proj, split_dz, backend,
              device, shards) -> dict:
    sdir = os.path.join(work, number_type)
    os.makedirs(sdir)
    t0 = time.perf_counter()
    synthesize(sdir, det, n_proj, device=device, subdir=SUBDIR,
               number_type=number_type)
    synth_s = time.perf_counter() - t0
    pdir = os.path.join(sdir, SUBDIR)
    geo = os.path.join(sdir, "scan.geo")
    dump_geometry_file(det, geo)
    n_chunks = -(-n_proj // CHUNK)
    on_card = device.type == "cuda"

    def job(label, dz=None, extra=()):
        name = f"{mode}_{label}"
        argv = ["--geometry", geo, "--input", pdir, "--output", sdir,
                "--name", name, "--backend", backend, "--chunk-size",
                str(CHUNK), "--accuracy", mode, *extra]
        if dz is not None:
            argv += ["--block-dz", str(dz)]
        return _job(f"{mode} {label}", argv,
                    os.path.join(sdir, name + ".ddbvf"), n_chunks, on_card)

    jobs = {"auto": job("auto")}
    auto_dz = jobs["auto"]["block_dz"] or vol.dim_z
    slabs = sorted(set(seam_slabs(auto_dz, vol.dim_z)
                       + seam_slabs(split_dz, vol.dim_z)
                       + [interior_slab(split_dz, vol.dim_z)]))
    procs = start_shards(sdir, det, slabs, n_proj, shards, subdir=SUBDIR)
    try:
        jobs["split"] = job("split", split_dz)
        if jobs["auto"]["blocks"] > 1:
            jobs["one block"] = job("one_block", vol.dim_z)
        if mode == "fast":
            jobs["split distributed"] = job("split_dist", split_dz,
                                            ["--distributed"])
        t0 = time.perf_counter()
        golden = finish_shards(procs, sdir, slabs)
    except BaseException:
        stop_shards(procs)
        raise
    golden_wait = time.perf_counter() - t0
    one = "one block" if "one block" in jobs else "auto"
    for label, r in jobs.items():
        r["rel_rmse"] = {
            f"z{z0}..{z0 + dz - 1}": rel_rmse(
                ddbvf.read_slices(r["out"], z0, dz), golden[z0])
            for z0, dz in slabs}
        if label != one:
            ref = "split" if label == "split distributed" else one
            r["same_bytes_as"] = ref
            r["same_bytes"] = filecmp.cmp(r["out"], jobs[ref]["out"],
                                         shallow=False)
    for r in jobs.values():
        os.remove(r.pop("out"))
    return {"number_type": number_type, "synthesize_seconds": synth_s,
            "golden_wait_seconds": golden_wait, "slabs": slabs,
            "jobs": jobs}


def failures(res: dict) -> List[str]:
    """What failed a gate in a record of ``run``."""
    bad = []
    for mode, m in res["modes"].items():
        for label, r in m["jobs"].items():
            for slab, e in r["rel_rmse"].items():
                if not e <= GATE_RMSE:
                    bad.append(f"{mode} {label} {slab}: RMSE {e:.3e}")
            if r.get("same_bytes") is False:
                bad.append(f"{mode} {label}: bytes differ from the "
                           f"{r['same_bytes_as']} job's")
            if r.get("k1_launches_ok") is False:
                bad.append(f"{mode} {label}: K1 launched "
                           f"{r['k1_launches']} times")
        if m["jobs"]["split"]["blocks"] < 3:
            bad.append(f"{mode}: the split job ran "
                       f"{m['jobs']['split']['blocks']} blocks")
    return bad


def run(size: int = 512, rows: int = 384, n_proj: int = 256,
        split_dz: int = 136, backend: str = "auto",
        workdir: Optional[str] = None, shards: Optional[int] = None) -> dict:
    """Both modes' scans and jobs; returns the record (``pass`` and the
    ``failures`` of its gates)."""
    det = geometry(size, rows, n_proj)
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    shards = shards or os.cpu_count() or 1
    res = {"name": f"offset_detector_{size}x{rows}_{n_proj}proj",
           "detector": dataclasses.asdict(det),
           "volume": list(vol.shape_zyx), "n_proj": n_proj,
           "chunk_size": CHUNK, "split_dz": split_dz, "modes": {},
           **card_record(device)}
    with workdir_or_temp(workdir) as work:
        for mode, number_type in MODES:
            res["modes"][mode] = _run_mode(
                work, det, vol, mode, number_type, n_proj, split_dz,
                backend, device, shards)
    res["failures"] = failures(res)
    res["pass"] = not res["failures"]
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--n-proj", type=int, default=256)
    ap.add_argument("--split-dz", type=int, default=136)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch"])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "offset_detector.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    res = run(args.size, args.rows, args.n_proj, args.split_dz,
              args.backend, args.workdir, args.shards)
    print(json.dumps(res), flush=True)
    record_result(args.out, res)
    if not res["pass"]:
        raise SystemExit("offset_detector: " + "; ".join(res["failures"]))
    return res


if __name__ == "__main__":
    main()
