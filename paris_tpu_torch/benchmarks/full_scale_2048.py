"""BASELINE config 5 at its stated volume on one card, planned by the
job's own memory budget (the counterpart of
``benchmarks/full_scale_2048.py``).

    python -m paris_tpu_torch.benchmarks.full_scale_2048 [--workdir D] [--accuracy exact]

The 2048 x 2048 x 2055 volume (34.5 GB) reconstructed end to end through
``run_job``: a Shepp-Logan scan synthesized on the card and written as HIS
files, the planner choosing the z-blocks from the card's free memory with
no budget given, the detector-row band, the ddbvf output.  The plan is
the job's own (``app.plan_job``), pinned into the job (``block_dz``) so
the seam the gate reads is the seam the job wrote.

Gate: a 4-slice slab read back from the ddbvf at relative RMSE <= 1e-3
against the golden oracle (``golden_slab``, one process per core over the
same stored frames): the slab straddling the first seam when the plan has
more than one block, else the slab at mid z.  On an 80 GB card the plan
may well be one block; the JAX runner's "more than one block" gate was
written for a card with half the volume's memory, and is not carried
over: the plan is recorded instead.

The projection count defaults to 360 (the 3600-frame scan at --quality
10); ``PARIS_BENCH_CFG5_NPROJ`` sets it.  Needs ~41 GB of disk at 360
frames; the work directory is removed afterwards unless ``--workdir``
pins it.  The JSON goes to ``results/full_scale_2048.json`` unless
``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import tempfile
import time
from typing import Optional

from ..app import ReconstructionJob, plan_job, run_job
from ..geometry import DetectorGeometry, derive_volume_geometry
from ..pipeline import resolve_backend
from .full_scale_2048_3600 import (GATE_RMSE, RESULTS_DIR, card_record,
                                   gate_slabs, job_log_tap, record_result,
                                   stage_seconds)
from .golden_slab import finish_shards, start_shards
from .synth_c5_3600 import config5, synthesize

__all__ = ["run", "main"]


def run(workdir: str, *, accuracy: str = "fast", n_proj: int = 360,
        det: Optional[DetectorGeometry] = None, backend: str = "cuda",
        golden_shards: Optional[int] = None) -> dict:
    """Synthesize ``n_proj`` frames into ``workdir/proj`` (skipping the
    files already there), plan the job as ``run_job`` does, pin that plan,
    run the job, and gate the seam (or mid-z) slab.  ``det`` defaults to
    config 5 at ``n_proj`` projections; ``golden_shards`` to one process
    per core.  Returns the result; ``pass`` says whether the gate held."""
    det = config5(n_proj) if det is None else det
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    res = {"config": 5, "name": "full_scale_2048_single_card"
           + ("" if accuracy == "fast" else "_exact"),
           "volume": list(vol.shape_zyx), "detector": [det.n_col, det.n_row],
           "n_proj": n_proj, "accuracy": accuracy, **card_record(device)}
    synth = synthesize(workdir, det, n_proj, subdir="proj", device=device)
    res["synthesize_seconds"] = synth["seconds"]
    res["synthesize_write_seconds"] = synth["write_seconds"]
    res["synthesize_card_seconds"] = synth["card_seconds"]

    job = ReconstructionJob(det=det, input_path=os.path.join(workdir, "proj"),
                            output_path=workdir, prefix="c5auto",
                            chunk_size=8, backend=backend, accuracy=accuracy)
    plan = plan_job(job, vol, device)
    info = plan.info
    res["auto_hbm_budget_gb"] = (None if plan.hbm_budget is None
                                 else plan.hbm_budget / 2**30)
    res["planned_blocks"] = info.num
    res["block_dz"] = info.dim_z_padded
    res["write_overlap"] = plan.overlap
    res["plan"] = [dataclasses.asdict(b) for b in info.blocks]
    print(f"planned {info.num} block(s) of {info.dim_z_padded} slices",
          flush=True)
    # pin the plan: the free memory the planner reads can change before
    # the job plans again, and the gate's seam must be the job's
    job = dataclasses.replace(job, block_dz=info.dim_z_padded)

    seam = info.blocks[1].z0 if info.num > 1 else vol.dim_z // 2
    slabs = [(max(0, seam - 2), 4)]
    t_golden = time.perf_counter()
    procs = start_shards(workdir, det, slabs, n_proj,
                         golden_shards or os.cpu_count() or 1, subdir="proj")
    try:
        with job_log_tap() as tap:
            t0 = time.perf_counter()
            out = run_job(job)
            dt = time.perf_counter() - t0
    except BaseException:
        for p in procs:
            p.terminate()
            p.join()
        raise
    goldens = finish_shards(procs, workdir, slabs)
    res["golden_seconds"] = time.perf_counter() - t_golden
    res["reconstruct_seconds"] = dt
    res["gupd_per_s_end_to_end"] = vol.voxels * n_proj / dt / 1e9
    res["per_block_gupd_per_s"] = [g for _, g in tap.block_rates]
    res["stage_seconds"] = stage_seconds(tap.timings[-1]) \
        if tap.timings else {}
    res["band_rows"] = tap.band_rows
    rmse = gate_slabs(out, goldens, slabs)[slabs[0][0]]
    res["gate_slab_z0"] = slabs[0][0]
    res["gate_slab"] = "seam" if info.num > 1 else "mid z"
    res["rel_rmse_vs_golden_gate_slab"] = rmse
    res["gate"] = (f"<= {GATE_RMSE:g} at the first seam (one block: mid "
                   "z), auto plan recorded")
    res["pass"] = rmse <= GATE_RMSE
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "full_scale_2048.json"))
    ap.add_argument("--accuracy", default="fast", choices=["fast", "exact"])
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (needs ~41 GB at 360 frames); "
                         "default: a new temporary one, removed afterwards")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    n_proj = int(os.environ.get("PARIS_BENCH_CFG5_NPROJ", "360"))
    workdir = args.workdir or tempfile.mkdtemp(prefix="paris2048_")
    try:
        res = run(workdir, accuracy=args.accuracy, n_proj=n_proj)
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
