"""Driver parity with the write overlap on: ``run_job`` against
``run_job_distributed`` at world size 1 over a forced 3-block split (the
counterpart of ``benchmarks/dist_overlap_ab.py``).

    python -m paris_tpu_torch.benchmarks.dist_overlap_ab [--size N] [--n-proj N] [--pairs 3]

Both drivers drain block k to disk on a writer thread while block k+1
reconstructs.  A phantom scan of ``--n-proj`` frames (default
``PARIS_BENCH_CFG3_NPROJ`` or 360) over a size² detector of 1 mm
pixels (d_so 8 x size, d_od 4 x size) is synthesized on the card
(``phantom.cone_beam_project_torch``) as HIS files, or reused from
``PARIS_BENCH_CFG3_SCANDIR`` when that holds this exact scan
(``config3_stream.cached_scan``); both jobs run it in fast mode, chunk 24,
``block_dz`` 384 x size / 1024 (three blocks at 1024 and at 512: what the
overlap does depends on the block count, not the size, so ``--size 512``
tests the same mechanism on an eighth of the disk).  The distributed job runs in
a group of one made by ``multihost.initialize`` (NCCL on the card, gloo
with ``--backend torch``); its set-up is outside the timed wall.

Reported, with the JAX driver's keys: both walls and their ratio, gate
distributed <= 1.2 x single; and the outputs compared.  The JAX gate was
1e-5 relative; here it is byte equality (``main`` exits non-zero without
it).  ``--pairs N`` runs N pairs in turns and reports medians.  The record
goes to ``results/dist_overlap_ab.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import Optional

from ..app import ReconstructionJob, plan_job
from ..geometry import derive_volume_geometry
from ..pipeline import resolve_backend
from .config3_stream import SCAN_SUBDIR, cached_scan, geometry, workdir_or_temp
from .dist_parity_ab import alternate
from .full_scale_2048_3600 import RESULTS_DIR, card_record, record_result

__all__ = ["run", "main"]


def run(size: int = 1024, n_proj: int = 360, backend: str = "cuda",
        pairs: int = 1, scandir: Optional[str] = None,
        workdir: Optional[str] = None) -> dict:
    det = geometry(size, n_proj)
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    block_dz = 384 * size // 1024
    with workdir_or_temp(workdir) as work:
        scan = scandir or os.path.join(work, "scan")
        os.makedirs(scan, exist_ok=True)
        cached_scan(scan, det, n_proj, device)

        def job_for(mode):
            return ReconstructionJob(
                det=det, input_path=os.path.join(scan, SCAN_SUBDIR),
                output_path=os.path.join(work, mode), prefix="ab",
                chunk_size=24, accuracy="fast", block_dz=block_dz,
                backend=backend)

        plan = plan_job(job_for("single"), vol, device)
        runs, identical, max_rel_diff = alternate(
            job_for, pairs, backend, os.path.join(work, "reference.ddbvf"))
    wall = {m: statistics.median(w for w, _ in r) for m, r in runs.items()}
    ratio = wall["distributed"] / wall["single"]
    return {"name": f"dist_overlap_ab_mesh1_{size}", "n_proj": n_proj,
            "block_dz": block_dz, "blocks": plan.info.num,
            "write_overlap": plan.overlap,
            "pairs": pairs,
            "wall_single_s": round(wall["single"], 2),
            "wall_dist_s": round(wall["distributed"], 2),
            "wall_s_all": {m: [w for w, _ in r] for m, r in runs.items()},
            "stage_seconds_all": {m: [s for _, s in r]
                                  for m, r in runs.items()},
            "ratio_dist_over_single": round(ratio, 3),
            "outputs_identical": identical, "max_rel_diff": max_rel_diff,
            "gate": "dist wall <= 1.2x single; outputs byte-identical",
            "pass": ratio <= 1.2 and identical, **card_record(device)}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--n-proj", type=int, default=int(
        os.environ.get("PARIS_BENCH_CFG3_NPROJ", "360")))
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "dist_overlap_ab.json"))
    args = ap.parse_args(argv)
    res = run(args.size, args.n_proj, args.backend, args.pairs,
              scandir=os.environ.get("PARIS_BENCH_CFG3_SCANDIR"))
    print(json.dumps(res), flush=True)
    record_result(args.out, res)
    if not res["outputs_identical"]:
        raise SystemExit("dist_overlap_ab: the drivers' outputs differ")
    return res


if __name__ == "__main__":
    main()
