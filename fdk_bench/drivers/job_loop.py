"""``job_loop``: whole reconstruction jobs one after another, each
``run_job(ReconstructionJob(...))`` from HIS files on disk to a ddbvf on
disk, as an operator's queue of scans or previews runs them.

Set-up synthesizes the seed's scan on the card as uint16 counts and
writes it as HIS files of ``frames_per_file`` frames (each fsync'd, so
that its writeback is over before the window), then runs one job of the
cell's shapes.  Each job's detector may take a horizontal offset
``delta_s`` drawn from the seed (``delta_s`` in the mix), so that every
job builds a new geometry; its region of interest (``roi``) is centred
in x and y.  The window starts jobs until ``--seconds`` have passed and
waits for the last; each job writes into one output directory, job
after job, except a share drawn from the seed (``compare_share``, at
most ``compare_max``), which keep their own.  After the window those and
the last job's output are read back from disk and held, voxel for voxel,
to the plain reference.  With ``--trace 1`` the window's first
``trace_jobs`` jobs are profiled.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..lib.ddbvf import read_volume
from ..lib.geometry import derive_volume, scan_from
from ..lib.his import write_his_u16
from ..lib.phantom import Projector, as_float
from ..lib.trace import span
from ..reference.compare import rel_rmse
from ..reference.fdk import fdk_at_voxels

TRACE_WINDOWS = {"job": "fdk_bench.job"}
PREFIX = "vol"


def write_scan(ctx, proj: Projector, n_proj: int, per_file: int) -> str:
    """The seed's scan as HIS files in the work directory; their path."""
    d = ctx.path("scan")
    for i0 in range(0, n_proj, per_file):
        counts = proj.counts(np.arange(i0, min(n_proj, i0 + per_file)))
        frames = counts.cpu().numpy().view(np.uint16)
        ctx.wrote("scan", write_his_u16(
            os.path.join(d, f"b{i0:05d}.his"), frames))
    return d


def roi_bounds(vol, roi: dict) -> Tuple[int, int, int, int, int, int]:
    """Inclusive (x1, x2, y1, y2, z1, z2) of the mix's ROI in ``vol``:
    ``xy`` voxels square, centred; ``z`` slices centred, or "all"."""
    n = int(roi["xy"])
    x1 = (vol.dim_x - n) // 2
    y1 = (vol.dim_y - n) // 2
    if roi["z"] == "all":
        z1, z2 = 0, vol.dim_z - 1
    else:
        nz = int(roi["z"])
        z1 = (vol.dim_z - nz) // 2
        z2 = z1 + nz - 1
    return x1, x1 + n - 1, y1, y1 + n - 1, z1, z2


def offsets(seed: int, spec):
    """The jobs' delta_s values: ``true`` plus a draw from ``low`` ..
    ``high`` in steps of ``step`` (pixels); always ``true`` without a
    spec."""
    rng = np.random.default_rng([int(seed), 11])
    while True:
        if not spec:
            yield 0.0
            continue
        n = int(round((spec["high"] - spec["low"]) / spec["step"]))
        yield float(spec["true"] + spec["low"]
                    + spec["step"] * int(rng.integers(0, n + 1)))


def job_split(records) -> Dict[str, float]:
    """The program's own seconds of one job, from its log records (their
    arguments, at full precision): "reconstruct" and "stage_wait" summed
    over the blocks' ingest lines; "drain", the pwrites and the waits on
    their copies summed over the blocks' drain lines."""
    out = {"reconstruct": 0.0, "stage_wait": 0.0, "drain": 0.0,
           "blocks": 0}
    for rec in records:
        msg = rec.msg if isinstance(rec.msg, str) else ""
        if msg.startswith("block %d ingest from the %s"):
            out["reconstruct"] += float(rec.args[2])
            out["stage_wait"] += float(rec.args[5])
            out["blocks"] += 1
        elif msg.startswith("block %d drain: d2h"):
            out["drain"] += float(rec.args[2]) + float(rec.args[3])
    return out


def run(ctx) -> None:
    from paris_tpu_torch.app import ReconstructionJob, run_job
    from paris_tpu_torch.geometry import DetectorGeometry, RegionOfInterest

    mix, cfg = ctx.mix, ctx.config
    scan = scan_from(cfg)
    n_proj = int(cfg["scan"]["n_proj"])
    quality = int(mix["quality"])
    proj = Projector(scan, derive_volume(scan), ctx.seed, ctx.device)
    scan_dir = write_scan(ctx, proj, n_proj,
                          int(cfg["scan"]["frames_per_file"]))
    ctx.note(f"scan written: {ctx.written['scan']} bytes")
    shared = ctx.path("out")
    draws = offsets(ctx.seed, mix.get("delta_s"))
    keep_rng = np.random.default_rng([ctx.seed, 13])

    def job(delta_s: float, out_dir: str):
        s = dataclasses.replace(scan, delta_s=delta_s)
        x1, x2, y1, y2, z1, z2 = roi_bounds(derive_volume(s), mix["roi"])
        det = DetectorGeometry(s.n_row, s.n_col, s.l_px_row, s.l_px_col,
                               s.delta_s, s.delta_t, s.d_so, s.d_od,
                               s.delta_phi)
        return s, ReconstructionJob(
            det=det, input_path=scan_dir, output_path=out_dir,
            prefix=PREFIX, quality=quality,
            roi=RegionOfInterest(x1, x2, y1, y2, z1, z2),
            chunk_size=int(mix["chunk_size"]), backend=ctx.backend,
            accuracy=mix["accuracy"])

    def outputs(out_dir: str) -> int:
        return sum(os.path.getsize(os.path.join(out_dir, n))
                   for n in os.listdir(out_dir))

    # one job of the cell's own shapes
    run_job(job(float(mix.get("delta_s", {}).get("true", 0.0)),
                shared)[1])
    ctx.wrote("outputs", outputs(shared))
    ctx.warm_profiler()

    jobs, compare = [], []
    n_trace = int(mix["trace_jobs"]) if ctx.trace else 0
    last_shared = None
    with contextlib.ExitStack() as tracing:
        t0 = ctx.start_window()
        end = t0
        while time.perf_counter() - t0 < ctx.seconds:
            k = len(jobs)
            if k == 0 and n_trace:
                tracing.enter_context(ctx.profiler())
            delta_s = next(draws)
            keep = (len(compare) < int(mix["compare_max"])
                    and keep_rng.random() < float(mix["compare_share"]))
            out_dir = ctx.path(f"out{k}") if keep else shared
            s, j = job(delta_s, out_dir)
            first = len(ctx.log.records)
            failed = False
            start = time.perf_counter()
            with span("fdk_bench.job", k < n_trace):
                try:
                    run_job(j)
                except Exception as e:     # a job that fails is counted
                    failed = True
                    print(f"fdk_bench: job {k} failed: {e!r}", flush=True)
            end = time.perf_counter()
            ctx.attempted += 1
            ctx.failed += failed
            split = job_split(ctx.log.records[first:])
            del ctx.log.records[first:]
            jobs.append(dict(split, wall_s=end - start,
                             updates=_updates(j, n_proj)))
            ctx.wrote("outputs", outputs(out_dir))
            if keep:
                compare.append((s, j, out_dir))
            else:
                last_shared = (s, j, shared)
            if k + 1 == n_trace:
                tracing.close()
        tracing.close()
    ctx.close_window()
    ctx.record["jobs"] = jobs
    ctx.record["job_window_s"] = end - t0
    if last_shared is not None:
        compare.append(last_shared)
    ctx.note(f"window {end - t0:.3f} s, {len(jobs)} jobs")
    if len(jobs) >= 20:
        walls = [j["wall_s"] for j in jobs]
        q = np.quantile(walls, [0.1, 0.5, 0.9])
        means = {k: np.mean([j[k] for j in jobs])
                 for k in ("reconstruct", "stage_wait", "drain")}
        ctx.note("job wall p10 %.4f p50 %.4f p90 %.4f s; first ten %.4f, "
                 "last ten %.4f s; mean reconstruct %.4f, stage_wait %.4f, "
                 "drain %.4f s" % (*q, np.mean(walls[:10]),
                                   np.mean(walls[-10:]), *means.values()))
    gc.collect()
    judge(ctx, proj, n_proj, quality, compare)
    ctx.note(f"reference done, {len(compare)} outputs compared")


def _updates(j, n_proj: int) -> int:
    """ROI voxels x projections of a job."""
    r = j.roi
    frames = -(-n_proj // j.quality)
    return ((r.x2 - r.x1 + 1) * (r.y2 - r.y1 + 1) * (r.z2 - r.z1 + 1)
            * frames)


def judge(ctx, proj: Projector, n_proj: int, quality: int, compare) -> None:
    """Each compared job's ddbvf, read back from disk, against the plain
    reference at every voxel of its ROI; the worst relative RMSE.  With
    ``ctx.control``, the reference in that lower precision stands in for
    the program."""
    idx = np.arange(0, n_proj, quality)
    refs: Dict[float, torch.Tensor] = {}
    worst = 0.0 if compare else float("inf")

    def frames(part):
        return as_float(proj.counts(part))

    for s, j, out_dir in compare:
        r = j.roi
        zz, yy, xx = torch.meshgrid(
            torch.arange(r.z1, r.z2 + 1), torch.arange(r.y1, r.y2 + 1),
            torch.arange(r.x1, r.x2 + 1), indexing="ij")
        vox = torch.stack([zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)],
                          dim=1)
        vol = derive_volume(s)
        key = (s.delta_s, r.x1, r.y1, r.z1, r.z2)
        if key not in refs:
            refs[key] = fdk_at_voxels(frames, idx, s, vol, vox,
                                      device=ctx.device)
        ref = refs[key]
        if ctx.control is not None:
            got = fdk_at_voxels(frames, idx, s, vol, vox, device=ctx.device,
                                lowp=ctx.control)
        else:
            try:
                got = torch.from_numpy(read_volume(os.path.join(
                    out_dir, PREFIX + ".ddbvf")).reshape(-1).astype(
                        np.float64))
            except (OSError, ValueError) as e:
                print(f"fdk_bench: output {out_dir}: {e}", flush=True)
                got = torch.full_like(ref, float("nan"))
        worst = max(worst, rel_rmse(got.to(ref.device), ref))
    ctx.record["compared_jobs"] = len(compare)
    ctx.numbers["rel_rmse"] = worst
