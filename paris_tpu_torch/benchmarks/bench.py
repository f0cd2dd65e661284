"""The one-line throughput metric on the card: Gvoxel updates per second
of one weight + filter + backprojection step at a 1024³ block (the
counterpart of the root ``bench.py``, which measures the JAX package).

    python -m paris_tpu_torch.benchmarks.bench [--accuracy exact] [--size N]

The last line printed is ONE JSON object with the JAX bench's schema:

    {"metric": "backprojection_gvoxel_updates_per_s_1024cube_cuda_fast",
     "value": Gupd/s, "unit": "Gupd/s/chip", "vs_baseline": ...}

What is timed is what the JAX bench times (its ``Reconstructor._step``):
dequantize, weight, ramp filter and backproject one chunk that is already
on the device.  Here that is ``Reconstructor.step_staged`` on a
``Staged`` chunk built directly: a float32 chunk of standard normals from
``np.random.default_rng(0)`` and the sines and cosines of C angles
``delta_phi`` apart.  In fast mode the port's step also takes the chunk
through the per-frame u16 round trip on the card, which the JAX package
ran on its host while staging (outside its bench's step), and hands the
filtered chunk to the kernel as bf16.  CUDA
events around the JAX iteration count, min(100, max(3, ceil(2e10 / (block
voxels x C)))), after one warm-up step, repeated 5 times; ``value`` is the
repeats' median.

Geometry and plan, as the JAX bench's: a size² detector of 1 mm pixels,
d_so 8 x size, d_od 4 x size (the derived volume is size³); for size >=
1024 one whole 1024-slice block on its detector-row band (no band when it
is the whole detector), C = 24.  The JAX bench clamped C to its TPU
memory budget (``max_chunk_size``), which the card does not have: C stays
as asked.

``vs_baseline`` = Gupd/s over the per-projection streaming ceiling, memory
bytes/s over 8 bytes per update (BASELINE.md), at the H100 SXM's 3350 GB/s
(``PARIS_HBM_GBPS`` sets another rate): 418.75 Gupd/s.

Earlier lines: the card (``nvidia-smi`` name and power limit), K1 alone on
the same filtered chunk (ms, Gupd/s; on the card also its share of
``k1_compare.k1_bound_ms``, its registers and resident blocks per SM),
and the repeats' median and min-max.

Env knobs, as the JAX bench's: PARIS_BENCH_SIZE (1024), PARIS_BENCH_CHUNK
(24), PARIS_BENCH_ACCURACY (fast|exact), PARIS_BENCH_BLOCK_DZ (0 = auto,
-1 = one block of the whole volume, N = forced), PARIS_BENCH_BACKEND
(cuda|torch; torch is the plain version on the CPU, one step per
loop).  Options override them.  The record goes to ``results/bench.json`` unless ``--out`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..geometry import DetectorGeometry, derive_volume_geometry, \
    detector_row_band
from ..ops import backprojection_cuda as bc
from ..pipeline import Reconstructor, Staged
from .full_scale_2048_3600 import RESULTS_DIR, card_record, record_result
from .k1_compare import HBM_BYTES_PER_S, k1_bound_ms, ptxas_registers, \
    time_ms

REPEATS = 5        # timed loops; ``value`` is their median

__all__ = ["geometry", "plan", "bench_inputs", "staged_chunk", "setup",
           "jax_iterations", "step_ms", "run", "main"]


def geometry(size: int):
    """(detector, volume) of the bench: the derived volume is size³."""
    det = DetectorGeometry(n_row=size, n_col=size, l_px_row=1.0,
                           l_px_col=1.0, delta_s=0.0, delta_t=0.0,
                           d_so=8.0 * size, d_od=4.0 * size, delta_phi=0.5)
    return det, derive_volume_geometry(det)


def plan(det: DetectorGeometry, vol, size: int, block_dz: int = 0
         ) -> Tuple[Optional[Tuple[int, int, int]], Optional[int]]:
    """(block shape, band rows) of the bench: ``block_dz`` 0 is one
    1024-slice block for size >= 1024 and the whole volume below; -1 the
    whole volume; N a forced extent.  The band is the widest over the
    blocks of that extent, None when it is the whole detector."""
    if block_dz == 0 and size >= 1024:
        block_dz = 1024
    if block_dz <= 0:
        return None, None
    n_blocks = -(-vol.dim_z // block_dz)
    v_band = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, i * block_dz, block_dz)
        for i in range(n_blocks)))
    return ((block_dz, vol.dim_y, vol.dim_x),
            None if v_band >= det.n_col else v_band)


def bench_inputs(det: DetectorGeometry, C: int):
    """(float32 chunk of standard normals from default_rng(0), float32
    angles in radians ``delta_phi`` apart) of one step, as the JAX bench
    makes them."""
    rng = np.random.default_rng(0)
    chunk = rng.standard_normal((C, det.n_col, det.n_row)).astype(np.float32)
    phi = np.deg2rad(np.arange(C) * det.delta_phi).astype(np.float32)
    return chunk, phi


def staged_chunk(rec: Reconstructor, chunk: np.ndarray,
                 phi: np.ndarray) -> Staged:
    """The ``Staged`` chunk ``step_staged`` consumes, on the
    reconstructor's device: the float32 frames, all of them data; a
    ``DistributedReconstructor`` gets its rank's slots of it."""
    lo, hi = getattr(rec, "_slots", (0, rec.chunk_size))
    chunk, sin, cos = (torch.from_numpy(np.ascontiguousarray(a)).to(
        rec.device) for a in (chunk[lo:hi], np.sin(phi[lo:hi]),
                              np.cos(phi[lo:hi])))
    return Staged(chunk, sin, cos, hi - lo)


def setup(size: int, C: int, accuracy: str, backend: str,
          block_dz: int = 0):
    """(the bench's ``Reconstructor``, its staged step input)."""
    det, vol = geometry(size)
    block_shape, v_band = plan(det, vol, size, block_dz)
    rec = Reconstructor(det, vol, chunk_size=C, backend=backend,
                        block_shape=block_shape, v_band_width=v_band,
                        accuracy=accuracy)
    return rec, staged_chunk(rec, *bench_inputs(det, C))


def jax_iterations(updates: int) -> int:
    """The JAX bench's steps per timing: enough for 2e10 voxel updates,
    at least 3 and at most 100."""
    return min(100, max(3, math.ceil(2.0e10 / updates)))


def step_ms(device: torch.device, fn, n: int, warmup: int = 1) -> float:
    """ms per call of ``fn`` over ``n`` calls: CUDA events on a card, the
    host clock on the CPU (where the plain version runs synchronously)."""
    if device.type == "cuda":
        return time_ms(fn, n, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def run(size: int = 1024, C: int = 24, accuracy: str = "fast",
        backend: str = "cuda", block_dz: int = 0,
        hbm_gbps: float = HBM_BYTES_PER_S / 1e9) -> dict:
    """Time the step (and K1 alone) at ``size``, ``REPEATS`` times; returns
    the record, whose ``metric``, ``value``, ``unit`` and ``vs_baseline``
    are the schema."""
    rec, staged = setup(size, C, accuracy, backend, block_dz)
    det, vol = rec.det, rec.vol
    dz, ny, nx = rec.block_shape
    updates = dz * ny * nx * C
    # the plain version on the CPU takes 0.1-1 s a step at a test's size
    iters = jax_iterations(updates) if rec.device.type == "cuda" else 1
    volume = rec.init_block()
    step = [step_ms(rec.device, lambda: rec.step_staged(volume, staged),
                    iters, warmup=1 if r == 0 else 0)
            for r in range(REPEATS)]

    chunk, sin, cos, n = staged[:4]
    filtered, v_lo = rec._filter_band(chunk, n, 0)
    k1 = [step_ms(rec.device, lambda: bc.backproject_chunk(
        volume, filtered, sin, cos, rec.grid, z_offset=0, v_lo=v_lo), iters)
        for _ in range(REPEATS)]
    bound, bound_by = k1_bound_ms(dz, ny, nx, C, filtered.shape[1],
                                  det.n_row, filtered.element_size())
    ms, k1_ms = statistics.median(step), statistics.median(k1)
    gups = updates / ms / 1e6
    ceiling = hbm_gbps / 8.0
    metric = (f"backprojection_gvoxel_updates_per_s_{vol.dim_x}cube_"
              f"{rec.backend}_{accuracy}")
    res = {"name": metric, "metric": metric, "value": round(gups, 2),
           "unit": "Gupd/s/chip", "vs_baseline": round(gups / ceiling, 4),
           "size": size, "chunk": C, "accuracy": accuracy,
           "backend": rec.backend, "block_shape": list(rec.block_shape),
           "band_rows": filtered.shape[1], "iters": iters,
           "repeats": REPEATS, "step_ms": ms, "step_ms_all": step,
           "gupd_per_s_min": updates / max(step) / 1e6,
           "gupd_per_s_max": updates / min(step) / 1e6,
           "hbm_gbps": hbm_gbps, "ceiling_gupd_per_s": ceiling,
           "k1_ms": k1_ms, "k1_ms_all": k1,
           "k1_gupd_per_s": updates / k1_ms / 1e6, "k1_bound_ms": bound,
           "k1_bound_by": bound_by, **card_record(rec.device)}
    if rec.device.type == "cuda":
        res["k1_bound_share"] = bound / k1_ms
        bf16 = filtered.dtype == torch.bfloat16
        tile = bc.launch_plan(rec.grid, rec.block_shape, filtered, 0)
        log = _build.build(["backproject"])["backproject"][2]
        res["k1_registers"], res["k1_spill_bytes"] = ptxas_registers(
            log, bf16, tile)
        res["k1_blocks_per_sm"] = bc.blocks_per_sm(tile, bf16, rec.device)
    return res


def _env(name: str, default: str) -> str:
    return os.environ.get(f"PARIS_BENCH_{name}", default)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=int(_env("SIZE", "1024")))
    ap.add_argument("--chunk", type=int, default=int(_env("CHUNK", "24")))
    ap.add_argument("--accuracy", default=_env("ACCURACY", "fast"),
                    choices=["fast", "exact"])
    ap.add_argument("--block-dz", type=int,
                    default=int(_env("BLOCK_DZ", "0")))
    ap.add_argument("--backend", default=_env("BACKEND", "cuda"),
                    choices=["cuda", "torch"])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "bench.json"))
    args = ap.parse_args(argv)
    res = run(args.size, args.chunk, args.accuracy, args.backend,
              args.block_dz, float(os.environ.get("PARIS_HBM_GBPS", HBM_BYTES_PER_S / 1e9)))
    print(f"device: {res['device']} ({res['nvidia_smi']})")
    print(f"K1 alone, {tuple(res['block_shape'])} C={res['chunk']} on "
          f"{res['band_rows']} rows ({res['accuracy']}): "
          f"{res['k1_ms']:.3f} ms ({res['k1_gupd_per_s']:.1f} Gupd/s)"
          + (f", {res['k1_bound_share']:.1%} of the {res['k1_bound_ms']:.3f} "
             f"ms bound ({res['k1_bound_by']}); {res['k1_registers']} "
             f"registers ({res['k1_spill_bytes']} B spilled), "
             f"{res['k1_blocks_per_sm']} blocks/SM"
             if "k1_bound_share" in res else ""))
    print(f"step over {res['repeats']} repeats of {res['iters']}: median "
          f"{res['step_ms']:.3f} ms ({res['value']} Gupd/s), "
          f"{res['gupd_per_s_min']:.2f}-{res['gupd_per_s_max']:.2f} Gupd/s")
    record_result(args.out, res)
    print(json.dumps({k: res[k] for k in
                      ("metric", "value", "unit", "vs_baseline")}),
          flush=True)
    return res


if __name__ == "__main__":
    main()
