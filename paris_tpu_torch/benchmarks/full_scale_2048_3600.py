"""BASELINE config 5 at its stated size on one card: the 2048 x 2048 x
2055 volume (34.5 GB) from the full 3600-projection scan (the counterpart
of ``benchmarks/full_scale_2048_3600.py``).

    python -m paris_tpu_torch.benchmarks.full_scale_2048_3600 --workdir D --synthesize uint16 --accuracy fast exact

  * scan: the synthesizer's HIS files (``synth_c5_3600``; 30.2 GB of
    uint16 or 60.4 GB of float32 at 3600 frames), made first when
    ``--synthesize`` names a number type, else already in ``D``; its
    ``scan_map.json`` goes into the result;
  * plan: ``block_dz`` pinned to 344, which gives 6 blocks with seams at
    z 344, 688, 1032, 1376 and 1720, so the gated slabs do not depend on
    the card's free memory; 8 projections per step; the job's projection
    cache as its plan decides (a run of more than one block keeps the
    staged scan on the card where it fits, so later blocks read nothing);
  * gates, derived from the plan: for every block k >= 1 at z0_k the seam
    slab (z0_k - 2, 4), and the interior slab z 858..861, each read back
    from the ddbvf at relative RMSE <= 1e-3 against the golden oracle
    over the same stored frames (``golden_slab``, one process per core,
    run to its end before the first timed job; one golden serves every
    accuracy of the run);
  * recorded: end-to-end seconds and Gupd/s, per-block proj/s and Gupd/s,
    the ingest split per block (where the block's frames came from, its
    reconstruct seconds, the host's seconds reading into the staging
    ring, waiting on staged chunks, enqueuing steps and waiting on the
    card, and on the card the reconstruct seconds over K1's: chunks x K1
    alone at a block of the plan, ``k1_ms_at_block``), the projection
    cache's lines, the stage timers, K1's launches (blocks x chunks on the
    card), the plan, the scan's map, the card.

A job too large for one run (the disk, or a time limit) is split by
block: ``--first-block K --max-blocks N`` runs blocks K..K+N-1 through
``run_job`` with ``resume`` and ``max_blocks``, over a fresh ddbvf whose
manifest lists blocks 0..K-1 as written by the earlier runs (their slices
are not on this disk).  Such a run gates the parts of the slabs its
blocks wrote, records each part's squared-error sum, and writes its
record under ``<job name>_blocks<K>-<K+N-1>``; ``--combine FILE...``
joins the records of every block into the job's result (the parts'
sums give each slab's RMSE exactly).  ``--n-proj`` runs the same steps
on a shorter scan, recorded under its own name.  The JSON goes to
``results/full_scale_2048_3600.json`` unless ``--out`` says otherwise;
the run exits non-zero when a gate fails.

The JAX runner ran one child process per block to bound a leak of its
TPU transport; the port runs every block of a run in one process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..app import ReconstructionJob, plan_job, run_job
from ..geometry import DetectorGeometry, SubvolumeInfo, derive_volume_geometry
from ..io import ddbvf
from ..io.sink import VolumeSink
from ..ops.backprojection_cuda import backproject_chunk_cuda
from ..pipeline import resolve_backend
from .golden_slab import finish_shards, start_shards, stop_shards
from .synth_c5_3600 import (DONE_MARKER, N_PROJ, NUMBER_TYPES, PROJ_SUBDIR,
                            config5, read_scan_map, synthesize)

__all__ = ["BLOCK_DZ", "INTERIOR", "GATE_RMSE", "RESULTS_DIR", "job_log_tap",
           "stage_seconds", "rel_rmse", "gate_slabs", "card_record",
           "record_result", "result_name", "plan_slabs", "slab_parts",
           "run_call", "combine", "run", "main"]

BLOCK_DZ = 344           # 6 blocks of config 5's 2055 slices, seams at 344 k
CHUNK = 8                # projections per step
SEAM_HALF = 2            # a seam slab: 2 slices on either side of the seam
INTERIOR = ((858, 4),)   # inside block 2, away from every seam
GATE_RMSE = 1e-3
RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results")


class _JobLogTap(logging.Handler):
    """The job's per-block rates, ingest and drain splits (each with
    ``at``, the host time it was logged) and stage timers, the plan it
    took and where its projection cache lives, from its log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.block_rates = []          # (proj/s, Gupd/s) per block
        self.ingest = []               # the ingest split per block
        self.drain = []                # the drain split per block
        self.cache = []                # "projection cache: ..." lines
        self.plan = []                 # "z-split ..." and "block plan ..."
        self.timings = []              # "stage timings" texts
        self.band_rows = None          # (band rows, detector rows)

    def emit(self, record):
        if record.msg.startswith("block %d done"):
            _index, _n, pps, gups = record.args
            self.block_rates.append((pps, gups))
        elif record.msg.startswith("block %d ingest"):
            (index, origin, rec_s, read_s, chunks, wait_s, enqueue_s,
             steps, card_s) = record.args
            self.ingest.append({
                "block": index, "from": origin, "reconstruct_s": rec_s,
                "read_s": read_s, "read_chunks": chunks,
                "stage_wait_s": wait_s, "step_enqueue_s": enqueue_s,
                "steps": steps, "card_wait_s": card_s,
                "at": record.created})
        elif record.msg.startswith("block %d drain"):
            index, d2h, write, wait, slabs, slices, pinned = record.args
            self.drain.append({
                "block": index, "d2h_s": d2h, "write_s": write,
                "wait_s": wait, "slabs": slabs, "slab_slices": slices,
                "pinned_bytes": pinned, "at": record.created})
        elif record.msg.startswith(("z-split", "block plan")):
            self.plan.append(record.getMessage())
        elif record.msg.startswith("projection cache"):
            self.cache.append(record.getMessage())
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


def result_name(n_proj: int, number_type: str, accuracy: str) -> str:
    """``full_scale_2048_<n>proj[_u16]_single_card[_exact]``."""
    return (f"full_scale_2048_{n_proj}proj"
            + ("_u16" if number_type == "uint16" else "") + "_single_card"
            + ("" if accuracy == "fast" else "_exact"))


def plan_slabs(info: SubvolumeInfo, dim_z: int,
               interior: Sequence[Tuple[int, int]] = INTERIOR
               ) -> List[Tuple[str, int, int]]:
    """The slabs a job on the plan ``info`` is gated at, as (kind, z0, dz):
    ("seam", z0_k - 2, 4) for every block k >= 1, then ("interior", z0,
    dz) for each of ``interior``.  Raises ValueError for a plan of one
    block, a slab outside the ``dim_z`` slices, a seam slab that does not
    straddle its seam alone, an interior slab that straddles a seam, or
    two slabs that overlap."""
    seams = [b.z0 for b in info.blocks[1:]]
    if not seams:
        raise ValueError(f"the plan has {info.num} block: no seam to gate")
    slabs = ([("seam", z - SEAM_HALF, 2 * SEAM_HALF) for z in seams]
             + [("interior", z0, dz) for z0, dz in interior])
    for kind, z0, dz in slabs:
        if z0 < 0 or z0 + dz > dim_z:
            raise ValueError(f"the {kind} slab ({z0}, {dz}) lies outside "
                             f"the volume's {dim_z} slices")
        inside = [z for z in seams if z0 < z < z0 + dz]
        if len(inside) != (kind == "seam"):
            raise ValueError(f"the {kind} slab ({z0}, {dz}) straddles the "
                             f"seams {inside} of {info.num} blocks at "
                             f"{seams}")
    ordered = sorted((z0, z0 + dz) for _, z0, dz in slabs)
    if any(a[1] > b[0] for a, b in zip(ordered, ordered[1:])):
        raise ValueError(f"gated slabs overlap: {ordered}")
    return slabs


def slab_parts(slabs: Sequence[Tuple[str, int, int]], blocks) -> List[dict]:
    """The part of each slab that each of ``blocks`` writes: dicts with
    the slab's kind and (z0, dz), and the part's own z0 and dz."""
    parts = []
    for kind, z0, dz in slabs:
        for b in blocks:
            lo, hi = max(z0, b.z0), min(z0 + dz, b.z0 + b.dim_z)
            if lo < hi:
                parts.append({"kind": kind, "slab": [z0, dz], "z0": lo,
                              "dz": hi - lo})
    return parts


def _gate_part(out_path: str, part: dict, golden: np.ndarray) -> dict:
    """``part`` with its squared-error sum against ``golden``, its voxels,
    max|golden| and its own relative RMSE; raises if the slices read back
    are not finite or have the wrong shape."""
    got = ddbvf.read_slices(out_path, part["z0"], part["dz"])
    if got.shape != golden.shape or not np.isfinite(got).all():
        raise AssertionError(f"{out_path}: bad slices at z {part['z0']}")
    err = got.astype(np.float64) - golden
    return {**part, "sse": float(np.sum(err * err)), "voxels": int(err.size),
            "max_abs_golden": float(np.abs(golden).max()),
            "rel_rmse": rel_rmse(got, golden)}


def _golden(workdir: str, det: DetectorGeometry, n_proj: int, parts,
            shards: int, synthesize_as: Optional[str], device) -> tuple:
    """The golden slab of every part, from ``shards`` processes that tail
    the scan while this process synthesizes it (``synthesize_as``, a
    number type; None: the scan is there).  Returns (z0 -> slab, the
    synthesis's record or None, seconds)."""
    t0 = time.perf_counter()
    slabs = [(p["z0"], p["dz"]) for p in parts]
    procs = start_shards(workdir, det, slabs, n_proj, shards,
                         subdir=PROJ_SUBDIR) if slabs else []
    try:
        synth = None if synthesize_as is None else synthesize(
            workdir, det, n_proj, device=device, number_type=synthesize_as)
    except BaseException:
        stop_shards(procs)
        raise
    goldens = finish_shards(procs, workdir, slabs) if procs else {}
    return goldens, synth, time.perf_counter() - t0


def run_call(workdir: str, *, accuracies: Sequence[str] = ("fast",),
             n_proj: int = N_PROJ, det: Optional[DetectorGeometry] = None,
             block_dz: int = BLOCK_DZ,
             interior: Sequence[Tuple[int, int]] = INTERIOR,
             backend: str = "cuda", first_block: int = 0,
             max_blocks: Optional[int] = None,
             golden_shards: Optional[int] = None,
             synthesize_as: Optional[str] = None,
             keep_output: bool = True) -> List[dict]:
    """Run blocks ``first_block`` .. ``first_block + max_blocks - 1`` (all
    by default) of the job on the scan in ``workdir`` once per accuracy of
    ``accuracies``, with ``block_dz`` pinned, and gate the parts of the
    slabs of ``plan_slabs`` that they write.  The golden (and the
    synthesis, if ``synthesize_as`` asks for it) runs to its end before
    the first job.  ``det`` defaults to config 5 at ``n_proj``
    projections.  Returns one record per accuracy (``combine`` makes the
    job's result of them); ``keep_output=False`` deletes each ddbvf once
    it is gated."""
    det = config5(n_proj) if det is None else det
    vol = derive_volume_geometry(det)
    pdir = os.path.join(workdir, PROJ_SUBDIR)
    _, device = resolve_backend(backend)
    on_card = device.type == "cuda"
    job = ReconstructionJob(
        det=det, input_path=pdir, output_path=workdir, chunk_size=CHUNK,
        backend=backend, block_dz=block_dz, cache_projections=False)
    # this plan only names the seams (the scan may not exist yet, and the
    # cache needs its headers); the runs below plan their own cache
    plan = plan_job(job, vol, device)
    job = dataclasses.replace(job, cache_projections=None)
    info = plan.info
    slabs = plan_slabs(info, vol.dim_z, interior)
    last = info.num if max_blocks is None else min(info.num,
                                                   first_block + max_blocks)
    if not 0 <= first_block < last:
        raise ValueError(f"no block to run: blocks {first_block}..{last - 1}"
                         f" of {info.num}")
    blocks = info.blocks[first_block:last]
    parts = slab_parts(slabs, blocks)
    if on_card:
        _build.build()            # the kernels are built before the timing
    shards = golden_shards or os.cpu_count() or 1
    goldens, synth, golden_s = _golden(workdir, det, n_proj, parts, shards,
                                       synthesize_as, device)
    if not os.path.exists(os.path.join(pdir, DONE_MARKER)):
        raise RuntimeError(f"scan not synthesized: no {DONE_MARKER} in "
                           f"{pdir}")
    scan = read_scan_map(pdir)
    if scan["n_proj"] != n_proj:
        raise ValueError(f"the scan in {pdir} has {scan['n_proj']} "
                         f"projections, not {n_proj}")
    chunks = -(-n_proj // CHUNK)
    common = {
        "config": 5, "volume": list(vol.shape_zyx),
        "detector": [det.n_col, det.n_row], "n_proj": n_proj,
        "chunk_size": CHUNK, "block_dz": block_dz,
        "planned_blocks": info.num,
        "plan": [dataclasses.asdict(b) for b in info.blocks],
        "write_overlap": plan.overlap, "scan": scan,
        "blocks": [b.index for b in blocks], "golden_seconds": golden_s,
        "golden_shards": shards if parts else 0, "synthesis": synth,
        **card_record(device)}
    records = []
    for accuracy in accuracies:
        name = result_name(n_proj, scan["number_type"], accuracy)
        prefix = "c5" if accuracy == "fast" else "c5x"
        split = last - first_block < info.num
        run = dataclasses.replace(
            job, prefix=prefix, accuracy=accuracy, resume=first_block > 0,
            max_blocks=last - first_block if split else None)
        if first_block > 0:
            # blocks 0..first_block-1 were written by earlier runs: this
            # disk holds their manifest entries, not their slices
            sink = VolumeSink(workdir, prefix, vol.dim_x, vol.dim_y,
                              vol.dim_z)
            for b in info.blocks[:first_block]:
                sink.mark_done(b.index)
        launches = backproject_chunk_cuda.launches
        with job_log_tap() as tap:
            t0 = time.perf_counter()
            out = run_job(run)
            wall = time.perf_counter() - t0
        launches = backproject_chunk_cuda.launches - launches
        with open(out + ".manifest.json") as f:
            done = json.load(f)["completed_blocks"]
        if done != list(range(last)):
            raise AssertionError(f"{out}: blocks {done} complete, expected "
                                 f"0..{last - 1}")
        gated = [_gate_part(out, p, goldens[p["z0"]]) for p in parts]
        if not keep_output:
            os.remove(out)
        k1_ms = None
        if on_card:
            # K1 alone at a block of the plan, in this accuracy: what a
            # block's reconstruct stage is held against
            from .weak_scaling_projection import kernel_gups_on_card
            k1_ms = kernel_gups_on_card(accuracy)["ms"]
            for b in tap.ingest:
                b["over_k1"] = b["reconstruct_s"] / (chunks * k1_ms / 1e3)
        voxels = sum(b.dim_z for b in blocks) * vol.dim_y * vol.dim_x
        rec = {
            "name": name if not split else
            f"{name}_blocks{first_block}-{last - 1}", "job": name,
            "accuracy": accuracy, **common,
            "end_to_end_seconds": wall,
            "gupd_per_s_end_to_end": voxels * n_proj / wall / 1e9,
            "per_block_proj_per_s": [p for p, _ in tap.block_rates],
            "per_block_gupd_per_s": [g for _, g in tap.block_rates],
            "per_block_ingest": tap.ingest,
            "per_block_drain": tap.drain,
            "projection_cache": tap.cache,
            "stage_timings": tap.timings,
            "stage_seconds": stage_seconds(tap.timings[-1])
            if tap.timings else {},
            "band_rows": tap.band_rows,
            "k1_launches": launches if on_card else None,
            "k1_launches_expected": len(blocks) * chunks if on_card else None,
            "k1_ms_at_block": k1_ms,
            "slab_parts": gated}
        print(f"[full-scale] {rec['name']}: blocks {rec['blocks']} in "
              f"{wall:.1f} s, K1 launches {rec['k1_launches']}, parts "
              + ", ".join(f"{p['kind']} z{p['z0']}+{p['dz']} "
                          f"{p['rel_rmse']:.3e}" for p in gated), flush=True)
        records.append(rec)
    return records


_SAME = ("config", "volume", "detector", "n_proj", "accuracy", "chunk_size",
         "block_dz", "planned_blocks", "plan", "write_overlap", "scan",
         "device")


def combine(records: Sequence[dict]) -> dict:
    """The job's result from the records of the runs that made its blocks
    (one record for a job run whole): summed seconds, stage seconds and
    launches, per-block rates in block order, and per slab its relative
    RMSE from the parts' squared-error sums.  ``pass`` holds when every
    block was run once, every slab is covered by its parts once and is at
    or under ``GATE_RMSE``, and K1 launched blocks x chunks times on the
    card; ``failures`` says what did not hold."""
    recs = sorted(records, key=lambda r: r["blocks"][0])
    first = recs[0]
    for r in recs[1:]:
        diff = [k for k in _SAME + ("job",) if r[k] != first[k]]
        if diff:
            raise ValueError(f"records of different jobs: {diff} differ")
    res = {"name": first["job"], **{k: first[k] for k in _SAME}}
    failures = []
    blocks = [b for r in recs for b in r["blocks"]]
    if blocks != list(range(first["planned_blocks"])):
        failures.append(f"blocks run {blocks}, the plan has "
                        f"{first['planned_blocks']}")
    smi = sorted({r["nvidia_smi"] for r in recs if r["nvidia_smi"]})
    res["nvidia_smi"] = smi[0] if len(smi) == 1 else smi or None
    res["calls"] = [{k: r[k] for k in ("blocks", "end_to_end_seconds",
                                       "stage_seconds", "golden_seconds",
                                       "golden_shards", "k1_launches",
                                       "nvidia_smi")} for r in recs]
    wall = sum(r["end_to_end_seconds"] for r in recs)
    res["end_to_end_seconds"] = wall
    res["gupd_per_s_end_to_end"] = (math.prod(first["volume"])
                                    * first["n_proj"] / wall / 1e9)
    for key in ("per_block_proj_per_s", "per_block_gupd_per_s",
                "per_block_ingest", "per_block_drain"):
        res[key] = [x for r in recs for x in r.get(key, [])]
    stages: Dict[str, float] = {}
    for r in recs:
        for k, v in r["stage_seconds"].items():
            stages[k] = stages.get(k, 0.0) + v
    res["stage_seconds"] = stages
    res["golden_seconds"] = sum(r["golden_seconds"] for r in recs)
    res["synthesis"] = [r["synthesis"] for r in recs if r["synthesis"]]
    res["band_rows"] = first["band_rows"]
    if first["k1_launches"] is None:
        res["k1_launches"] = res["k1_launches_expected"] = None
    else:
        res["k1_launches"] = sum(r["k1_launches"] for r in recs)
        res["k1_launches_expected"] = (first["planned_blocks"] *
                                       -(-first["n_proj"] // first["chunk_size"]))
        if res["k1_launches"] != res["k1_launches_expected"]:
            failures.append(f"K1 launched {res['k1_launches']} times, "
                            f"expected {res['k1_launches_expected']}")
    slabs: Dict[Tuple[str, int, int], List[dict]] = {}
    for r in recs:
        for p in r["slab_parts"]:
            slabs.setdefault((p["kind"], *p["slab"]), []).append(p)
    for (kind, z0, dz), parts in sorted(slabs.items(), key=lambda kv: kv[0][1]):
        covered = sorted(z for p in parts for z in range(p["z0"],
                                                         p["z0"] + p["dz"]))
        if covered != list(range(z0, z0 + dz)):
            failures.append(f"{kind} slab z {z0}..{z0 + dz - 1}: slices "
                            f"{covered} gated")
        sse = sum(p["sse"] for p in parts)
        n = sum(p["voxels"] for p in parts)
        peak = max(p["max_abs_golden"] for p in parts)
        rmse = math.sqrt(sse / n) / peak
        res[f"rel_rmse_vs_golden_{kind}_z{z0}"] = rmse
        if not rmse <= GATE_RMSE:
            failures.append(f"{kind} slab z {z0}: relative RMSE {rmse:.3e}")
    if not slabs:
        failures.append("no slab gated")
    res["gate"] = (f"every seam slab and the interior slab at relative RMSE "
                   f"<= {GATE_RMSE:g}")
    res["failures"] = failures
    res["pass"] = not failures
    return res


def run(workdir: str, *, accuracy: str = "fast", **kw) -> dict:
    """The whole job in one run (``run_call`` with every block), and its
    result (``combine``)."""
    return combine(run_call(workdir, accuracies=(accuracy,), **kw))


def _load_records(paths: Sequence[str]) -> List[dict]:
    recs = []
    for path in paths:
        with open(path) as f:
            recs.extend(json.load(f))
    return recs


def main(argv: Optional[list] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir")
    ap.add_argument("--accuracy", nargs="+", default=["fast"],
                    choices=["fast", "exact"])
    ap.add_argument("--n-proj", type=int, default=N_PROJ)
    ap.add_argument("--synthesize", choices=NUMBER_TYPES, default=None,
                    help="synthesize the scan of this number type first")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="torch: the plain version on the CPU")
    ap.add_argument("--first-block", type=int, default=0)
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--keep-output", action="store_true",
                    help="keep each ddbvf after its gate")
    ap.add_argument("--combine", nargs="+", metavar="FILE",
                    help="join the block records in FILEs into the jobs' "
                         "results")
    ap.add_argument("--out", default=os.path.join(
        RESULTS_DIR, "full_scale_2048_3600.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if args.combine:
        jobs: Dict[str, List[dict]] = {}
        for r in _load_records(args.combine):
            if "job" in r and r["name"] != r["job"]:
                jobs.setdefault(r["job"], []).append(r)
        results = [combine(recs) for recs in jobs.values()]
    else:
        if args.workdir is None:
            ap.error("--workdir is required unless --combine is given")
        records = run_call(
            args.workdir, accuracies=args.accuracy, n_proj=args.n_proj,
            backend=args.backend, first_block=args.first_block, max_blocks=args.max_blocks,
            synthesize_as=args.synthesize,
            keep_output=args.keep_output)
        results = [r if r["name"] != r["job"] else combine([r])
                   for r in records]
    failed = []
    for res in results:
        print(json.dumps(res), flush=True)
        record_result(args.out, res)
        if "failures" in res:             # a job's result
            failed += [f"{res['name']}: {f}" for f in res["failures"]]
        else:                             # one run's blocks of a job
            failed += [f"{res['name']}: part z {p['z0']} at relative RMSE "
                       f"{p['rel_rmse']:.3e}" for p in res["slab_parts"]
                       if not p["rel_rmse"] <= GATE_RMSE]
            if res["k1_launches"] != res["k1_launches_expected"]:
                failed.append(f"{res['name']}: K1 launched "
                              f"{res['k1_launches']} times, expected "
                              f"{res['k1_launches_expected']}")
    if failed:
        raise SystemExit("gate failed: " + "; ".join(failed))
    return results


if __name__ == "__main__":
    main()
