"""The job's z-block plan swept on the card: one scan through ``run_job``
at several block counts, in the order given.

    python -m paris_tpu_torch.benchmarks.plan_sweep [--size 1024] [--n-proj 360] [--blocks 1 2 4 8] [--accuracy fast exact] --out F

  * scan: config 3's streaming geometry (``config3_stream.geometry``: a
    size² detector of 1 mm pixels, float32 HIS frames synthesized on the
    card), ``--n-proj`` frames (default ``PARIS_BENCH_CFG3_NPROJ``, else
    360), written once into ``--workdir`` (or a temporary directory);
  * per accuracy, a warm-up job (``config3_stream.warm_up``), then one job
    per entry of ``--blocks``, in that order (turns such as 1 4 4 1 are
    written out): a block count k pins ``block_dz`` to the extent that
    gives k blocks (``app.extent_for``), ``auto`` runs the job's own plan;
  * before each job the page cache's dirty pages are flushed (``os.sync``,
    timed apart), so that a job does not pay for the one before;
  * recorded per job (``measure_job``): seconds end to end, the plan's
    log lines, the ingest and drain splits per block, the projection
    cache's place, K1's launches, and the peak of ``Dirty`` +
    ``Writeback`` in ``/proc/meminfo`` sampled every 100 ms, over the job
    and per block (from the end of its reconstruct stage to the end of its
    drain);
  * each job's ddbvf is held against the accuracy's first job's, and the
    largest |difference| recorded (0.0: byte for byte the same volume
    whatever the plan); then removed, the first kept until the accuracy
    is done.

Each job writes a whole volume (4 GiB at 1024), so keep the list within
the disk the run may write.  The JSON goes to ``results/plan_sweep.json``
unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from ..app import ReconstructionJob, extent_for, run_job
from ..geometry import derive_volume_geometry
from ..io import ddbvf
from ..ops.backprojection_cuda import backproject_chunk_cuda
from ..pipeline import resolve_backend
from .config3_stream import SCAN_SUBDIR, cached_scan, geometry, warm_up
from .config3_stream import workdir_or_temp
from .full_scale_2048_3600 import (RESULTS_DIR, card_record, job_log_tap,
                                   record_result, stage_seconds)

__all__ = ["DirtySampler", "cache_place", "max_abs_diff", "measure_job",
           "run", "main"]

MEMINFO = "/proc/meminfo"


def _dirty_bytes() -> Optional[int]:
    """``Dirty`` + ``Writeback`` of ``/proc/meminfo`` in bytes; None where
    the file or either field is missing."""
    try:
        with open(MEMINFO) as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
        return 1024 * sum(int(fields[k].split()[0])
                          for k in ("Dirty", "Writeback"))
    except (OSError, KeyError, ValueError, IndexError):
        return None


class DirtySampler:
    """A thread that reads ``Dirty`` + ``Writeback`` every ``period``
    seconds while the ``with`` body runs; ``samples`` holds (host time,
    bytes) pairs, none where the host does not report the fields."""

    def __init__(self, period: float = 0.1):
        self.period = period
        self.samples: List[tuple] = []
        self._stop = threading.Event()

    def _loop(self):
        while True:
            b = _dirty_bytes()
            if b is not None:
                self.samples.append((time.time(), b))
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paris-dirty-sampler")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        b = _dirty_bytes()
        if b is not None:
            self.samples.append((time.time(), b))

    def peak(self, t0: float = float("-inf"), t1: float = float("inf")
             ) -> Optional[int]:
        """The largest sample taken between host times ``t0`` and ``t1``;
        None without one."""
        inside = [b for t, b in self.samples if t0 <= t <= t1]
        return max(inside) if inside else None


def cache_place(lines: Sequence[str]) -> str:
    """Where the job's projection cache lived, from its "projection
    cache" log lines: "card", "host" or "off"."""
    text = " ".join(lines)
    if "on the card" in text:
        return "card"
    if "on the host" in text:
        return "host"
    return "off"


def max_abs_diff(a: str, b: str, slices: int = 16) -> float:
    """The largest |a - b| over the voxels of two ddbvf files of one shape,
    read ``slices`` slices at a time; inf for files of other shapes."""
    meta = ddbvf.open_meta(a)
    if ddbvf.open_meta(b) != meta:
        return float("inf")
    worst = 0.0
    for z0 in range(0, meta[2], slices):
        n = min(slices, meta[2] - z0)
        d = np.abs(ddbvf.read_slices(a, z0, n) - ddbvf.read_slices(b, z0, n))
        worst = max(worst, float(d.max()))
    return worst


def measure_job(job: ReconstructionJob) -> dict:
    """Run ``job`` once: flush the dirty pages first (``sync_seconds``),
    then time it with the dirty-page sampler on.  Returns its record (the
    ddbvf's path under ``out``)."""
    t0 = time.perf_counter()
    os.sync()
    sync_s = time.perf_counter() - t0
    launches = backproject_chunk_cuda.launches
    with DirtySampler() as dirty, job_log_tap() as tap:
        t_start = time.time()
        t0 = time.perf_counter()
        out = run_job(job)
        seconds = time.perf_counter() - t0
    ends = {d["block"]: d["at"] for d in tap.drain}
    for b in tap.ingest:
        b["dirty_writeback_peak_bytes"] = dirty.peak(b["at"],
                                                     ends.get(b["block"]))
    return {
        "block_dz": job.block_dz, "out": out, "seconds": seconds,
        "sync_seconds": sync_s, "plan": tap.plan,
        "blocks": len(tap.ingest),
        "stage_seconds": stage_seconds(tap.timings[-1])
        if tap.timings else {},
        "ingest": tap.ingest, "drain": tap.drain,
        "projection_cache": tap.cache, "cache": cache_place(tap.cache),
        "band_rows": tap.band_rows,
        "k1_launches": backproject_chunk_cuda.launches - launches,
        "dirty_writeback_peak_bytes": dirty.peak(t_start),
        "dirty_samples": len(dirty.samples)}


def run(size: int = 1024, n_proj: int = 360,
        blocks: Sequence[str] = ("1", "2", "4", "8"),
        accuracies: Sequence[str] = ("fast", "exact"),
        backend: str = "cuda", workdir: Optional[str] = None) -> dict:
    """The sweep: the scan, then per accuracy the warm-up and one job per
    entry of ``blocks`` ("auto" or a block count).  Returns the record."""
    det = geometry(size, n_proj)
    vol = derive_volume_geometry(det)
    _, device = resolve_backend(backend)
    res = {"name": f"plan_sweep_{size}_{n_proj}proj", "config": 3,
           "volume": list(vol.shape_zyx), "n_proj": n_proj,
           "blocks_order": list(blocks), "runs": [], **card_record(device)}
    with workdir_or_temp(workdir) as work:
        scan = os.path.join(work, "scan")
        os.makedirs(scan, exist_ok=True)
        synth_s, _ = cached_scan(scan, det, n_proj, device)
        res["synthesize_seconds"] = synth_s
        pdir = os.path.join(scan, SCAN_SUBDIR)
        for accuracy in accuracies:
            warm = warm_up(pdir, det, n_proj, accuracy, backend,
                           os.path.join(work, "warm"))
            base = ReconstructionJob(det=det, input_path=pdir,
                                     output_path=work, accuracy=accuracy,
                                     backend=backend)
            first = None
            for i, k in enumerate(blocks):
                dz = None if k == "auto" else extent_for(vol.dim_z, int(k))
                r = measure_job(dataclasses.replace(
                    base, block_dz=dz, prefix=f"sweep{i}_{accuracy}"))
                out = r.pop("out")
                r.update(accuracy=accuracy, k=k, warmup_seconds=warm)
                r["max_abs_diff_vs_first"] = (0.0 if first is None else
                                              max_abs_diff(first, out))
                if first is None:
                    first = out
                else:
                    os.remove(out)
                print(f"[plan_sweep] {accuracy} k={k}: {r['blocks']} "
                      f"block(s), {r['seconds']:.2f} s, cache {r['cache']}, "
                      f"K1 {r['k1_launches']}, dirty+writeback peak "
                      f"{r['dirty_writeback_peak_bytes']}, max|diff| "
                      f"{r['max_abs_diff_vs_first']}", flush=True)
                res["runs"].append(r)
            os.remove(first)
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--n-proj", type=int, default=int(
        os.environ.get("PARIS_BENCH_CFG3_NPROJ", "360")))
    ap.add_argument("--blocks", nargs="+", default=["1", "2", "4", "8"],
                    help='block counts, or "auto", in the order to run')
    ap.add_argument("--accuracy", nargs="+", default=["fast", "exact"],
                    choices=["fast", "exact"])
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "plan_sweep.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    for k in args.blocks:
        if k != "auto" and not (k.isdigit() and int(k) > 0):
            ap.error(f"--blocks takes block counts or auto, not {k!r}")
    res = run(args.size, args.n_proj, args.blocks, args.accuracy,
              args.backend, args.workdir)
    print(json.dumps(res), flush=True)
    record_result(args.out, res)
    return res


if __name__ == "__main__":
    main()
