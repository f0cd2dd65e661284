"""BASELINE config 5 at its stated size on one card: the 2048 x 2048 x
2055 volume (34.5 GB) from the full 3600-projection scan (the counterpart
of ``benchmarks/full_scale_2048_3600.py``).

    python -m paris_tpu_torch.benchmarks.synth_c5_3600 --workdir D
    python -m paris_tpu_torch.benchmarks.golden_slab --workdir D --slabs 342:4,858:4 --shard 0/2 &
    python -m paris_tpu_torch.benchmarks.golden_slab --workdir D --slabs 342:4,858:4 --shard 1/2 &
    python -m paris_tpu_torch.benchmarks.full_scale_2048_3600 --workdir D [--accuracy exact]

  * scan: the synthesizer's HIS files (60.4 GB at 3600 frames);
  * plan: ``block_dz`` pinned to 344, which gives 6 blocks with the first
    seam at z 344, so the seam slab's place does not depend on the card's
    free memory; the job streams the scan from disk for every block
    (``cache_projections=False``), 8 projections per step;
  * gates: the seam slab z 342..345 and an interior slab z 858..861 read
    back from the ddbvf, each at relative RMSE <= 1e-3 against the golden
    oracle's partial sums (``golden_slab``: merged ``golden_z{z0}.npy``,
    else the sum of ``PARIS_GOLDEN_SHARDS`` partials, default 2);
  * recorded: end-to-end seconds and Gupd/s, per-block proj/s and Gupd/s,
    the stage timers, the plan, the card.

The JAX runner ran one child process per block to bound a leak of its
TPU transport; the port runs every block in one process (the CLI's
``--max-blocks`` and ``--resume`` still split a job across processes).
``--n-proj`` runs the same steps on a shorter scan, recorded under its
own name.  The JSON goes to ``results/full_scale_2048_3600.json``
unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..app import ReconstructionJob, plan_job, run_job
from ..geometry import DetectorGeometry, derive_volume_geometry
from ..io import ddbvf
from ..pipeline import resolve_backend
from .golden_slab import final_path, partial_path
from .synth_c5_3600 import DONE_MARKER, N_PROJ, PROJ_SUBDIR, config5

__all__ = ["BLOCK_DZ", "SLABS", "GATE_RMSE", "RESULTS_DIR", "job_log_tap",
           "stage_seconds", "rel_rmse", "gate_slabs", "card_record",
           "record_result", "run", "main"]

BLOCK_DZ = 344           # 6 blocks of config 5's 2055 slices, seam at 344
SLABS = ((342, 4), (858, 4))     # the first seam, and inside block 2
GATE_RMSE = 1e-3
RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results")


class _JobLogTap(logging.Handler):
    """The job's per-block rates and stage timers, from its log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.block_rates = []          # (proj/s, Gupd/s) per block
        self.timings = []              # "stage timings" texts
        self.band_rows = None          # (band rows, detector rows)

    def emit(self, record):
        if record.msg.startswith("block %d done"):
            _index, _n, pps, gups = record.args
            self.block_rates.append((pps, gups))
        elif record.msg.startswith("stage timings"):
            self.timings.append(record.args[0])
        elif record.msg.startswith("detector row band"):
            self.band_rows = tuple(record.args)


@contextlib.contextmanager
def job_log_tap():
    """Collect what ``run_job`` or ``run_job_distributed`` logs about its
    blocks while the body runs (the distributed driver logs its stage
    timings under its own logger, its blocks under the app's)."""
    logs = [logging.getLogger(name) for name in
            ("paris_tpu_torch.app", "paris_tpu_torch.parallel.app")]
    tap = _JobLogTap()
    levels = [log.level for log in logs]
    for log in logs:
        log.setLevel(logging.INFO)
        log.addHandler(tap)
    try:
        yield tap
    finally:
        for log, level in zip(logs, levels):
            log.removeHandler(tap)
            log.setLevel(level)


def stage_seconds(timings: str) -> Dict[str, float]:
    """"reconstruct: 1m05s (6 calls); finalize+write: 58.20s (6 calls)" ->
    {"reconstruct": 65.0, "finalize+write": 58.2}."""
    out = {}
    for name, m, s in re.findall(r"([\w+]+): (?:(\d+)m)?([\d.]+)s", timings):
        out[name] = 60 * int(m or 0) + float(s)
    return out


def rel_rmse(got: np.ndarray, ref: np.ndarray) -> float:
    """RMSE / max|ref|, the repository's relative RMSE."""
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2))
                 / np.abs(ref).max())


def gate_slabs(out_path: str, goldens: Dict[int, np.ndarray],
               slabs: Sequence[Tuple[int, int]]) -> Dict[int, float]:
    """Relative RMSE of each slab of the ddbvf against its golden slab;
    raises if a slab is not finite or has the wrong shape."""
    rmse = {}
    for z0, dz in slabs:
        got = ddbvf.read_slices(out_path, z0, dz)
        ref = goldens[z0]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{out_path}: bad slab at z {z0}")
        rmse[z0] = rel_rmse(got, ref)
    return rmse


def card_record(device: torch.device) -> dict:
    """The device a result was taken on: its name and, on a card, the name
    and power limit as ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return {"device": str(device), "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader",
                          f"--id={torch.cuda.current_device()}"],
                         capture_output=True, text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip() or None}


def record_result(path: str, res: dict) -> None:
    """Put ``res`` into the JSON list at ``path``, replacing an entry of
    the same name."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing = [r for r in existing if r.get("name") != res["name"]]
    existing.append(res)
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)


def _wait_goldens(workdir: str, slabs, shards: int, timeout_s: float,
                  poll_s: float = 30.0) -> Dict[int, np.ndarray]:
    """Golden slab per z0: the merged ``golden_z{z0}.npy`` if present,
    else the sum of the ``shards`` partials; waits for them up to
    ``timeout_s`` (the oracle may still be running)."""
    t0 = time.monotonic()
    out = {}
    for z0, _dz in slabs:
        merged = final_path(workdir, z0)
        parts = [partial_path(workdir, z0, w) for w in range(shards)]
        while not (os.path.exists(merged)
                   or all(os.path.exists(p) for p in parts)):
            if time.monotonic() - t0 > timeout_s:
                raise RuntimeError(f"golden partials missing: {parts}")
            print(f"[gate] waiting for golden partials z0={z0} ...",
                  flush=True)
            time.sleep(poll_s)
        out[z0] = (np.load(merged) if os.path.exists(merged)
                   else sum(np.load(p) for p in parts))
    return out


def run(workdir: str, *, accuracy: str = "fast", n_proj: int = N_PROJ,
        det: Optional[DetectorGeometry] = None, block_dz: int = BLOCK_DZ,
        slabs: Sequence[Tuple[int, int]] = SLABS, backend: str = "cuda",
        golden_shards: int = 2, golden_timeout_s: float = 7200.0) -> dict:
    """Reconstruct the synthesized scan in ``workdir`` with ``block_dz``
    pinned, and gate ``slabs`` (the first straddling the first seam)
    against the golden partials.  ``det`` defaults to config 5 at
    ``n_proj`` projections.  Returns the result; ``pass`` says whether
    every gate held."""
    det = config5(n_proj) if det is None else det
    vol = derive_volume_geometry(det)
    pdir = os.path.join(workdir, PROJ_SUBDIR)
    if not os.path.exists(os.path.join(pdir, DONE_MARKER)):
        raise RuntimeError(f"scan not synthesized: no {DONE_MARKER} in "
                           f"{pdir}")
    prefix = "c5" if accuracy == "fast" else "c5x"
    job = ReconstructionJob(
        det=det, input_path=pdir, output_path=workdir, prefix=prefix,
        chunk_size=8, backend=backend, accuracy=accuracy, block_dz=block_dz,
        cache_projections=False)
    _, device = resolve_backend(backend)
    plan = plan_job(job, vol, device)
    info = plan.info
    if info.num < 2 or info.blocks[1].z0 != slabs[0][0] + 2:
        raise ValueError(f"the seam slab {slabs[0]} does not straddle the "
                         f"first seam of {info.num} blocks of "
                         f"{info.dim_z_padded}")
    name = f"full_scale_2048_{n_proj}proj_single_card" + (
        "" if accuracy == "fast" else "_exact")
    res = {"config": 5, "name": name, "volume": list(vol.shape_zyx),
           "detector": [det.n_col, det.n_row], "n_proj": n_proj,
           "accuracy": accuracy, "chunk_size": job.chunk_size,
           "block_dz": block_dz, "planned_blocks": info.num,
           "plan": [dataclasses.asdict(b) for b in info.blocks],
           "write_overlap": plan.overlap, **card_record(device)}
    with job_log_tap() as tap:
        t0 = time.perf_counter()
        out = run_job(job)
        wall = time.perf_counter() - t0
    res["end_to_end_seconds"] = wall
    res["gupd_per_s_end_to_end"] = vol.voxels * n_proj / wall / 1e9
    res["per_block_proj_per_s"] = [p for p, _ in tap.block_rates]
    res["per_block_gupd_per_s"] = [g for _, g in tap.block_rates]
    res["stage_timings"] = tap.timings
    res["stage_seconds"] = stage_seconds(tap.timings[-1]) \
        if tap.timings else {}
    res["band_rows"] = tap.band_rows

    goldens = _wait_goldens(workdir, slabs, golden_shards, golden_timeout_s)
    rmse = gate_slabs(out, goldens, slabs)
    for (z0, dz), key in zip(slabs, ("seam", "interior")):
        res[f"rel_rmse_vs_golden_{key}_slab_z{z0}"] = rmse[z0]
    res["gate"] = f"seam + interior slab relative RMSE <= {GATE_RMSE:g}"
    res["pass"] = all(v <= GATE_RMSE for v in rmse.values())
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--accuracy", default="fast", choices=["fast", "exact"])
    ap.add_argument("--n-proj", type=int, default=N_PROJ)
    ap.add_argument("--out", default=os.path.join(
        RESULTS_DIR, "full_scale_2048_3600.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    res = run(args.workdir, accuracy=args.accuracy, n_proj=args.n_proj,
              golden_shards=int(os.environ.get("PARIS_GOLDEN_SHARDS", "2")))
    print(json.dumps(res), flush=True)
    record_result(args.out, res)
    if not res["pass"]:
        raise SystemExit(f"{res['name']}: a gate failed")
    return res


if __name__ == "__main__":
    main()
