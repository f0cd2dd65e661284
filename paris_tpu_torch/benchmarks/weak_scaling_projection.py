"""Config-5 weak scaling over NVLink, bounded: the bytes one distributed
step all-gathers, counted, times a stated link model (the counterpart of
``benchmarks/weak_scaling_projection.py``).

    python -m paris_tpu_torch.benchmarks.weak_scaling_projection

No machine here has more than one card, so the >= 80 % weak-scaling gate
of BASELINE config 5 cannot be measured; this bounds it instead.

1. Counted bytes: what ``DistributedReconstructor._gather`` passes through
   ``dist.all_gather_into_tensor`` in one ``step_staged`` (a wrapper
   around the rank's ``_gather`` sums the elements and bytes of each
   gathered tensor), in a gloo group on the CPU at the JAX driver's small
   geometry (a 64 x 256 detector, a 32-slice block, C = 8, fast mode),
   banded and full.  Checked against the model, C x vp x n_row elements
   of the filtered band plus 2C of sines and cosines, within 5 %: the
   port's band is exactly ``detector_row_band``'s width and its rows are
   not padded (the JAX package padded both for the TPU's tiles); the
   element is bf16 in fast mode, f32 in exact mode.
2. Scaled to config 5: a 2048² detector, 3600 frames, C = 8, a 344-slice
   block, on the widest band of the job's 344-slice blocks (what the job
   gathers), bf16.
3. Kernel rate: with a card, K1 at one (344, 2048, 2048) block on that
   band, fast, C = 8 (as ``chip_smoke.py`` phase 6c runs it); without
   one, ``PARIS_BENCH_KERNEL_GUPS``, which has no default: the projection
   fails without a rate.
4. Link model: the H100 SXM's NVLink, 900 GB/s per GPU over both
   directions (NVIDIA's H100 data sheet,
   https://www.nvidia.com/en-us/data-center/h100/), so 450 GB/s one way,
   the direction a ring all-gather uses; each of n cards receives (n-1)/n
   of the gather at that rate, and no overlap of transfer and compute is
   assumed.  Also at 150 GB/s (a 3x de-rating), and the crossover: the
   slowest link at which 32 cards still keep 80 %.

Keys are the JAX driver's, apart from its TPU measures: ``gather_elems_*``
and ``gather_bytes_*`` stand for ``hlo_all_gather_elems_*`` (the port has
no HLO to read), ``nvlink_gbps_*`` for ``ici_gbps_*``.  ``--process-id``
and its companions run one rank of the count alone (``gather_counts_in``,
``weak_scaling.spawn_ranks``).  The record goes to
``results/weak_scaling_projection.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import (DetectorGeometry, derive_volume_geometry,
                        detector_row_band, plan_z_blocks)
from ..parallel import multihost
from ..parallel.dist import DistributedReconstructor
from ..pipeline import Reconstructor
from .full_scale_2048_3600 import RESULTS_DIR, card_record, record_result
from .synth_c5_3600 import N_PROJ, config5

__all__ = ["NVLINK_GBPS", "SMALL_DET", "gather_counts", "gather_counts_in",
           "config5_band", "kernel_gups_on_card", "project", "run", "main"]

NVLINK_GBPS = 450.0            # H100 SXM NVLink, one direction per GPU
NVLINK_SENSITIVITY = (450.0, 150.0)   # the stated figure + a 3x de-rating
NVLINK_SOURCE = ("NVIDIA H100 data sheet, "
                 "https://www.nvidia.com/en-us/data-center/h100/: NVLink "
                 "900 GB/s per GPU over both directions; a ring all-gather "
                 "uses one direction per GPU, 450 GB/s")
SMALL_DET = DetectorGeometry(64, 256, 2.0, 2.0, 0.0, 0.0, 2048.0, 1024.0, 1.0)
SMALL_DZ, SMALL_C = 32, 8
C5_BLOCK_DZ, C5_C = 344, 8
MODULE = "paris_tpu_torch.benchmarks.weak_scaling_projection"


def gather_counts(banded: bool, accuracy: str = "fast") -> dict:
    """The elements and bytes that one ``step_staged`` of a
    ``DistributedReconstructor`` (the default group's ranks, CPU) gathers
    at the small geometry, with the model's count beside them."""
    det = SMALL_DET
    vol = derive_volume_geometry(det)
    band = None
    if banded:
        lo, hi = detector_row_band(det, vol, 0, SMALL_DZ)
        band = hi - lo
    rec = DistributedReconstructor(
        det, vol, chunk_size=SMALL_C, backend="torch", v_band_width=band,
        block_shape=(SMALL_DZ, vol.dim_y, vol.dim_x), accuracy=accuracy)
    seen = []
    gather = rec._gather

    def counting(t: torch.Tensor) -> torch.Tensor:
        out = gather(t)
        seen.append((out.numel(), out.numel() * out.element_size()))
        return out

    rec._gather = counting
    staged = rec.stage_chunk(np.zeros((SMALL_C, det.n_col, det.n_row)),
                             np.zeros(SMALL_C))
    rec.step_staged(rec.init_block(), staged)
    model = SMALL_C * rec._vp * det.n_row + 2 * SMALL_C
    return {"elements": sum(n for n, _ in seen),
            "bytes": sum(b for _, b in seen), "model_elements": model,
            "vp": rec._vp, "gathers": len(seen), "world": rec.world}


def gather_counts_in(coordinator=None, num_processes=None, process_id=None):
    """``gather_counts`` banded and full, in a gloo group made here (one of
    one without arguments) and destroyed afterwards."""
    multihost.initialize(coordinator, num_processes, process_id,
                         backend="torch")
    try:
        return {name: gather_counts(banded)
                for name, banded in (("banded", True), ("full", False))}
    finally:
        multihost.shutdown()


def config5_band():
    """(config 5's detector, its volume, the plan of 344-slice blocks, the
    widest detector-row band over those blocks: what the job gathers)."""
    det = config5(N_PROJ)
    vol = derive_volume_geometry(det)
    info = plan_z_blocks(vol, block_dz=C5_BLOCK_DZ)
    vp = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, b.z0, info.dim_z_padded)
        for b in info.blocks))
    return det, vol, info, vp


def kernel_gups_on_card(accuracy: str = "fast") -> dict:
    """K1's Gupd/s at one config-5 block on the job's band: block 1 of the
    344-slice blocks, fast (bf16; exact: float32), C = 8, CUDA events over
    5 launches; with the card's record."""
    from ..ops.backprojection_cuda import backproject_chunk_cuda
    from ..ops.backprojection_torch import make_bp_grid
    from .k1_compare import time_ms
    det, vol, info, vp = config5_band()
    shape = (info.dim_z_padded, vol.dim_y, vol.dim_x)
    z0 = info.blocks[1].z0
    v_lo = Reconstructor(det, vol, chunk_size=C5_C, backend="cuda",
                         block_shape=shape, v_band_width=vp)._v_band_lo(z0)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(2026)
    band = torch.as_tensor(rng.standard_normal(
        (C5_C, vp, det.n_row)).astype(np.float32), device=dev).to(
        torch.bfloat16 if accuracy == "fast" else torch.float32)
    phi = torch.as_tensor(np.deg2rad(np.arange(C5_C) * det.delta_phi
                                     ).astype(np.float32), device=dev)
    sin, cos = torch.sin(phi), torch.cos(phi)
    acc = torch.zeros(shape, device=dev)
    grid = make_bp_grid(det, vol)
    ms = time_ms(lambda: backproject_chunk_cuda(acc, band, sin, cos, grid,
                                                z0, v_lo=v_lo), n=5)
    return {"gups": shape[0] * shape[1] * shape[2] * C5_C / ms / 1e6,
            "ms": ms, "block": list(shape), "band_rows": vp,
            **card_record(dev)}


def project(gather_bytes: float, block_voxels: int, kernel_gups: float,
            n: int, gbps: float):
    """(t_comm s, t_comp s, efficiency) of one step on n cards: each
    receives (n-1)/n of the gather at ``gbps``; each backprojects its
    1/n of the block at ``kernel_gups``; no overlap."""
    t_comm = gather_bytes * (n - 1) / n / (gbps * 1e9)
    t_comp = block_voxels / n * C5_C / (kernel_gups * 1e9)
    return t_comm, t_comp, t_comp / (t_comp + t_comm)


def run(kernel_gups: Optional[float] = None) -> dict:
    """Count, check, scale and project; ``kernel_gups`` None measures K1 on
    the card, or reads ``PARIS_BENCH_KERNEL_GUPS`` without one."""
    res = {"config": 5, "name": "weak_scaling_projection",
           "method": ("counted all-gather bytes "
                      "(DistributedReconstructor._gather) x stated NVLink "
                      "model"),
           "nvlink_gbps_assumed": NVLINK_GBPS,
           "nvlink_gbps_source": NVLINK_SOURCE, "overlap_assumed": False}
    if kernel_gups is None:
        if torch.cuda.is_available():
            res["kernel"] = kernel_gups_on_card()
            kernel_gups = res["kernel"]["gups"]
            res["kernel_gups_source"] = ("K1 on this card at one "
                                         "config-5 block, fast, C = 8")
        elif os.environ.get("PARIS_BENCH_KERNEL_GUPS"):
            kernel_gups = float(os.environ["PARIS_BENCH_KERNEL_GUPS"])
            res["kernel_gups_source"] = "PARIS_BENCH_KERNEL_GUPS"
        else:
            raise RuntimeError(
                "weak_scaling_projection needs a kernel rate: a CUDA card to "
                "measure K1 on, or PARIS_BENCH_KERNEL_GUPS (no default)")
    else:
        res["kernel_gups_source"] = "given"
    res["kernel_gups_measured"] = kernel_gups

    counts = (gather_counts_in() if not dist.is_initialized() else
              {name: gather_counts(banded)
               for name, banded in (("banded", True), ("full", False))})
    for name, c in counts.items():
        res[f"gather_elems_small_{name}"] = c["elements"]
        res[f"gather_bytes_small_{name}"] = c["bytes"]
        res[f"analytic_elems_small_{name}"] = c["model_elements"]
        res[f"vp_small_{name}"] = c["vp"]
        if abs(c["elements"] - c["model_elements"]) > \
                0.05 * c["model_elements"]:
            raise AssertionError(f"{name}: gathered {c['elements']} "
                                 f"elements, the model says "
                                 f"{c['model_elements']}")

    det, vol, _, vp_band = config5_band()
    # the bf16 band and the f32 sines and cosines
    gather_total = C5_C * det.n_row * vp_band * 2 + 2 * C5_C * 4
    block_voxels = C5_BLOCK_DZ * vol.dim_y * vol.dim_x
    tables = {}
    for gbps in NVLINK_SENSITIVITY:
        table = []
        for n in (2, 4, 8, 16, 32):
            t_comm, t_comp, eff = project(gather_total, block_voxels,
                                          kernel_gups, n, gbps)
            table.append({"chips": n,
                          "gather_mb_per_step": round(gather_total / 1e6, 2),
                          "t_comm_ms": round(t_comm * 1e3, 4),
                          "t_comp_ms": round(t_comp * 1e3, 4),
                          "projected_efficiency": round(eff, 4)})
        tables[f"{gbps:g}_gbps"] = table
    # eff >= 0.8  <=>  t_comm <= t_comp / 4  <=>  gbps >= 4 recv / t_comp
    n = 32
    _, t_comp, _ = project(gather_total, block_voxels, kernel_gups, n, 1.0)
    res["crossover_gbps_for_80pct_at_32_chips"] = round(
        4.0 * gather_total * (n - 1) / n / t_comp / 1e9, 2)
    res["vp_band"] = vp_band
    res["projected"] = tables[f"{NVLINK_GBPS:g}_gbps"]
    res["projected_sensitivity"] = tables
    res["gate"] = ">= 0.80 projected efficiency at every mesh size"
    res["pass"] = all(r["projected_efficiency"] >= 0.80
                      for r in res["projected"])
    return res


def main(argv: Optional[list] = None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        RESULTS_DIR, "weak_scaling_projection.json"))
    # one rank of the count alone (weak_scaling.spawn_ranks passes these)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.process_id is not None:
        counts = gather_counts_in(args.coordinator, args.num_processes,
                                  args.process_id)
        if args.process_id == 0:
            print(json.dumps(counts), flush=True)
        return None
    res = run()
    print(json.dumps(res, indent=1), flush=True)
    record_result(args.out, res)
    return res


if __name__ == "__main__":
    main()
