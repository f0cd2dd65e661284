"""BASELINE config 5 at its stated volume on one card, planned by the
job's own plan or at a given block extent (the counterpart of
``benchmarks/full_scale_2048.py``).

    python -m paris_tpu_torch.benchmarks.full_scale_2048 [--workdir D] [--accuracy exact] [--n-proj N] [--number-type uint16] [--block-dz DZ]

The 2048 x 2048 x 2055 volume (34.5 GB) reconstructed end to end through
``run_job``: a Shepp-Logan scan synthesized on the card and written as HIS
files (``synth_c5_3600``: float32, or uint16 counts under one scale), the
z-blocks of the job's own plan (``app.plan_job`` over the scan's file
table, with no budget given) or of ``--block-dz``, the detector-row band,
the ddbvf output.  The plan is pinned into the job (``block_dz``) so the
seam the gate reads is the seam the job wrote.

Order: the synthesis; the plan; the golden of the gate slab, run to its
end (``golden_slab``, one process per core over the same stored frames);
on the card a warm-up job (``config3_stream.warm_up``); then the timed
job alone, through ``plan_sweep.measure_job`` (the dirty pages flushed
first).  Recorded: the plan (blocks, extent, overlap, where the
projection cache was planned and where it lived), the job's plan lines,
seconds end to end, the ingest and drain splits per block, K1's
launches, the peak of ``Dirty`` + ``Writeback`` over the job and per
block, and the sha256 of the slices either side of every seam of a plan
of 2-8 blocks (``digest_slices``): two runs under two plans wrote the
same bytes there when their digests agree.

Gate: a 4-slice slab read back from the ddbvf at relative RMSE <= 1e-3
against the golden: the slab straddling the first seam when the plan has
more than one block, else the slab at mid z.  The JAX runner's "more than
one block" gate was written for a card with half the volume's memory and
is not carried over: the plan is recorded instead.

The projection count defaults to 360 (the 3600-frame scan at --quality
10); ``--n-proj`` or ``PARIS_BENCH_CFG5_NPROJ`` sets it.  Needs the scan
(16.8 MB a float32 frame, 8.4 MB a uint16 one) and the 34.5 GB volume on
disk; the work directory is removed afterwards unless ``--workdir`` pins
it.  The JSON goes to ``results/full_scale_2048.json`` unless ``--out``
says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from ..app import ReconstructionJob, _job_source, extent_for, plan_job
from ..geometry import DetectorGeometry, derive_volume_geometry
from ..io import ddbvf
from ..pipeline import resolve_backend
from .config3_stream import warm_up
from .full_scale_2048_3600 import (GATE_RMSE, RESULTS_DIR, card_record,
                                   gate_slabs, record_result)
from .golden_slab import finish_shards, start_shards
from .plan_sweep import measure_job
from .synth_c5_3600 import NUMBER_TYPES, config5, synthesize

__all__ = ["digest_slices", "slice_digests", "run", "main"]


def run(workdir: str, *, accuracy: str = "fast", n_proj: int = 360,
        det: Optional[DetectorGeometry] = None, backend: str = "cuda",
        golden_shards: Optional[int] = None,
        number_type: str = "float32",
        block_dz: Optional[int] = None) -> dict:
    """Synthesize ``n_proj`` frames of ``number_type`` into ``workdir/proj``
    (skipping the files already there), plan the job as ``run_job`` does
    (or at ``block_dz``), pin that plan, run the golden of the gate slab to
    its end, then a warm-up job and the timed job alone
    (``plan_sweep.measure_job``), and gate the seam (or mid-z) slab.
    ``det`` defaults to config 5 at ``n_proj`` projections;
    ``golden_shards`` to one process per core.  Returns the result;
    ``pass`` says whether the gate held."""
    det = config5(n_proj) if det is None else det
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    res = {"config": 5, "name": f"full_scale_2048_{n_proj}proj"
           + ("_u16" if number_type == "uint16" else "")
           + ("_auto" if block_dz is None else f"_dz{block_dz}")
           + ("" if accuracy == "fast" else "_exact"),
           "volume": list(vol.shape_zyx), "detector": [det.n_col, det.n_row],
           "n_proj": n_proj, "number_type": number_type,
           "accuracy": accuracy, **card_record(device)}
    synth = synthesize(workdir, det, n_proj, subdir="proj", device=device,
                       number_type=number_type)
    res["synthesize_seconds"] = synth["seconds"]
    res["synthesize_write_seconds"] = synth["write_seconds"]
    res["synthesize_card_seconds"] = synth["card_seconds"]

    pdir = os.path.join(workdir, "proj")
    job = ReconstructionJob(det=det, input_path=pdir, output_path=workdir,
                            prefix="c5auto", chunk_size=8, backend=backend,
                            accuracy=accuracy, block_dz=block_dz)
    plan = plan_job(job, vol, device, _job_source(job))
    info = plan.info
    res["auto_hbm_budget_gb"] = (None if plan.hbm_budget is None
                                 else plan.hbm_budget / 2**30)
    res["planned_blocks"] = info.num
    res["block_dz"] = info.dim_z_padded
    res["block_dz_given"] = block_dz
    res["write_overlap"] = plan.overlap
    res["projection_cache_planned"] = plan.cache
    res["plan"] = [dataclasses.asdict(b) for b in info.blocks]
    print(f"planned {info.num} block(s) of {info.dim_z_padded} slices, "
          f"overlap {plan.overlap}, cache {plan.cache}", flush=True)
    # pin the plan: the free memory the planner reads can change before
    # the job plans again, and the gate's seam must be the job's
    job = dataclasses.replace(job, block_dz=info.dim_z_padded)

    seam = info.blocks[1].z0 if info.num > 1 else vol.dim_z // 2
    slabs = [(max(0, seam - 2), 4)]
    t_golden = time.perf_counter()
    procs = start_shards(workdir, det, slabs, n_proj,
                         golden_shards or os.cpu_count() or 1, subdir="proj")
    goldens = finish_shards(procs, workdir, slabs)
    res["golden_seconds"] = time.perf_counter() - t_golden
    if device.type == "cuda":
        res["warmup_seconds"] = warm_up(pdir, det, n_proj, accuracy,
                                        backend, os.path.join(workdir, "warm"))
    r = measure_job(job)
    out = r.pop("out")
    dt = r["seconds"]
    res["reconstruct_seconds"] = dt
    res["gupd_per_s_end_to_end"] = vol.voxels * n_proj / dt / 1e9
    res["stage_seconds"] = r["stage_seconds"]
    res["band_rows"] = r["band_rows"]
    res["job_plan_log"] = r["plan"]
    res["per_block_ingest"] = r["ingest"]
    res["per_block_drain"] = r["drain"]
    res["projection_cache"] = r["projection_cache"]
    res["cache"] = r["cache"]
    res["k1_launches"] = r["k1_launches"]
    res["dirty_writeback_peak_bytes"] = r["dirty_writeback_peak_bytes"]
    res["sync_seconds"] = r["sync_seconds"]
    res["slice_digests"] = slice_digests(out, digest_slices(vol.dim_z))
    rmse = gate_slabs(out, goldens, slabs)[slabs[0][0]]
    res["gate_slab_z0"] = slabs[0][0]
    res["gate_slab"] = "seam" if info.num > 1 else "mid z"
    res["rel_rmse_vs_golden_gate_slab"] = rmse
    res["gate"] = (f"<= {GATE_RMSE:g} at the first seam (one block: mid "
                   "z), the plan recorded")
    res["pass"] = rmse <= GATE_RMSE
    return res


def digest_slices(dim_z: int, counts: Sequence[int] = range(2, 9)
                  ) -> List[int]:
    """The slices whose bytes the runner records: the first and last, and
    the two either side of every seam of a plan of k blocks, k in
    ``counts``."""
    zs = {0, dim_z - 1}
    for k in counts:
        dz = extent_for(dim_z, k)
        zs.update(z + d for z in range(dz, dim_z, dz) for d in (-1, 0))
    return sorted(zs)


def slice_digests(path: str, zs: Sequence[int]) -> Dict[str, str]:
    """sha256 of each slice ``z`` of ``zs`` inside the ddbvf at ``path``:
    jobs of one scan under two plans, in two runs, wrote the same bytes
    there when their digests agree."""
    dim_z = ddbvf.open_meta(path)[2]
    return {str(z): hashlib.sha256(ddbvf.read_slices(path, z, 1).tobytes()
                                   ).hexdigest()
            for z in zs if 0 <= z < dim_z}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "full_scale_2048.json"))
    ap.add_argument("--accuracy", default="fast", choices=["fast", "exact"])
    ap.add_argument("--n-proj", type=int, default=int(
        os.environ.get("PARIS_BENCH_CFG5_NPROJ", "360")))
    ap.add_argument("--number-type", default="float32",
                    choices=NUMBER_TYPES)
    ap.add_argument("--block-dz", type=int, default=None,
                    help="pin this block extent (default: the job's plan)")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (needs the scan and a 34.5 GB "
                         "volume); default: a new temporary one, removed "
                         "afterwards")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    workdir = args.workdir or tempfile.mkdtemp(prefix="paris2048_")
    try:
        res = run(workdir, accuracy=args.accuracy, n_proj=args.n_proj,
                  number_type=args.number_type, block_dz=args.block_dz)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(res), flush=True)
    record_result(args.out, res)
    if not res["pass"]:
        raise SystemExit(f"{res['name']}: the gate failed")
    return res


if __name__ == "__main__":
    main()
