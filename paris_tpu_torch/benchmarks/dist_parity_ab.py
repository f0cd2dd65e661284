"""Driver parity on the card: the same job through ``run_job`` and through
``run_job_distributed`` at world size 1 (the counterpart of
``benchmarks/dist_parity_ab.py``).

    PARIS_BENCH_CFG3_SCANDIR=D python -m paris_tpu_torch.benchmarks.dist_parity_ab [--quality 10] [--size N] [--n-proj N] [--pairs 3]

Both drivers stage chunks the same way (``pipeline.stage_stream``); the
distributed one adds its all-gathers and barriers.  One fast-mode job runs
through each, over the scan of ``config3_stream`` (``--n-proj`` frames,
default ``PARIS_BENCH_CFG3_NPROJ`` or 360, of a size² detector) kept in
``PARIS_BENCH_CFG3_SCANDIR``:
reused when it matches exactly, else synthesized there on the card (in a
temporary directory without the variable).  ``--quality`` decimates it as
the CLI's flag does (the JAX driver's 10 was meant for the 3600-frame
scan; with 360 frames it leaves 36).  The distributed job runs in a group
of one made by ``multihost.initialize`` (NCCL on the card, gloo with
``--backend torch``) and destroyed after it.

Reported, with the JAX driver's keys: the reconstruct stage's seconds and
proj/s of each driver (``job_log_tap``) and their ratio, gate distributed
>= 0.85 x single.  ``--pairs N`` runs N pairs in turns (single first, then
distributed first, ...) and reports medians.  Added: every output must
equal the first byte for byte (the port is deterministic); ``main`` exits
non-zero when one does not, and reports the ratio gate.  The record goes
to ``results/dist_parity_ab.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import statistics
import time
from typing import Callable, Optional

import numpy as np

from ..app import ReconstructionJob, run_job
from ..io import ddbvf
from ..parallel import multihost
from ..parallel.app import run_job_distributed
from ..pipeline import resolve_backend
from .config3_stream import SCAN_SUBDIR, cached_scan, geometry, workdir_or_temp
from .full_scale_2048_3600 import (RESULTS_DIR, card_record, job_log_tap,
                                   record_result, stage_seconds)

__all__ = ["MODES", "run_driver", "alternate", "run", "main"]

MODES = ("single", "distributed")


def run_driver(mode: str, job: ReconstructionJob, backend: str):
    """Run ``job`` through ``run_job`` ("single") or, in a group of one
    made for it, ``run_job_distributed`` ("distributed"); returns (output
    path, the job's wall seconds, its stage seconds)."""
    if mode == "distributed":
        multihost.initialize(backend=backend)
    try:
        with job_log_tap() as tap:
            t0 = time.perf_counter()
            out = (run_job if mode == "single" else run_job_distributed)(job)
            wall = time.perf_counter() - t0
    finally:
        if mode == "distributed":
            multihost.shutdown()
    return out, wall, stage_seconds(tap.timings[-1])


def alternate(job_for: Callable[[str], ReconstructionJob], pairs: int,
              backend: str, reference: str):
    """Run the job of each driver ``pairs`` times in turns (single first in
    even pairs, distributed first in odd ones).  The first output is moved
    to ``reference``; every later one is compared with it byte for byte,
    then removed.  Returns ({mode: [(wall s, stage seconds), ...]}, all
    identical?, the largest |difference| / max|reference| of one that was
    not)."""
    runs = {mode: [] for mode in MODES}
    identical, max_rel_diff = True, 0.0
    for k in range(pairs):
        for mode in (MODES if k % 2 == 0 else MODES[::-1]):
            out, wall, stages = run_driver(mode, job_for(mode), backend)
            runs[mode].append((wall, stages))
            print(f"{mode}: {wall:.2f} s, stages {stages}", flush=True)
            if not os.path.exists(reference):
                os.replace(out, reference)
                continue
            if not filecmp.cmp(reference, out, shallow=False):
                identical = False
                a, b = ddbvf.read_volume(reference), ddbvf.read_volume(out)
                max_rel_diff = max(max_rel_diff, float(
                    np.abs(a - b).max() / (np.abs(a).max() or 1.0)))
            os.remove(out)
    return runs, identical, max_rel_diff


def run(size: int = 1024, quality: int = 10, backend: str = "cuda",
        n_scan: int = 360, scandir: Optional[str] = None, pairs: int = 1,
        workdir: Optional[str] = None) -> dict:
    det = geometry(size, n_scan)
    _, device = resolve_backend(backend)
    n_proj = -(-n_scan // quality)
    with workdir_or_temp(workdir) as work:
        scan = scandir or os.path.join(work, "scan")
        os.makedirs(scan, exist_ok=True)
        cached_scan(scan, det, n_scan, device)
        runs, identical, max_rel_diff = alternate(
            lambda mode: ReconstructionJob(
                det=det, input_path=os.path.join(scan, SCAN_SUBDIR),
                output_path=os.path.join(work, mode), prefix="v",
                quality=quality, accuracy="fast", backend=backend),
            pairs, backend, os.path.join(work, "reference.ddbvf"))
    rec_s = {m: statistics.median(s["block"] for _, s in runs[m])
             for m in MODES}
    pps = {m: n_proj / rec_s[m] for m in MODES}
    ratio = pps["distributed"] / pps["single"]
    return {"name": "dist_parity_ab_mesh1", "size": size,
            "n_proj": n_proj, "quality": quality, "pairs": pairs,
            "reconstruct_s": rec_s,
            "reconstruct_s_all": {m: [s["block"] for _, s in runs[m]]
                                  for m in MODES},
            "wall_s_all": {m: [w for w, _ in runs[m]] for m in MODES},
            "proj_per_s": {m: round(v, 1) for m, v in pps.items()},
            "ratio_dist_over_single": round(ratio, 3),
            "outputs_identical": identical, "max_rel_diff": max_rel_diff,
            "gate": "distributed reconstruct-phase rate >= 0.85x single; "
                    "outputs byte-identical",
            "pass": ratio >= 0.85, **card_record(device)}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quality", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--n-proj", type=int, default=int(
        os.environ.get("PARIS_BENCH_CFG3_NPROJ", "360")))
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "dist_parity_ab.json"))
    args = ap.parse_args(argv)
    res = run(args.size, args.quality, args.backend,
              n_scan=args.n_proj,
              scandir=os.environ.get("PARIS_BENCH_CFG3_SCANDIR"),
              pairs=args.pairs)
    print(json.dumps(res), flush=True)
    record_result(args.out, res)
    if not res["outputs_identical"]:
        raise SystemExit("dist_parity_ab: the drivers' outputs differ")
    return res


if __name__ == "__main__":
    main()
