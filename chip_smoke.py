"""Drives the PyTorch/CUDA port (paris_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure; the script then exits non-zero):
  0. device: needs torch.cuda.is_available(); prints the card's
     nvidia-smi name and power limit, torch and CUDA versions.
  1. build: compiles paris_tpu_torch/csrc/backproject.cu with nvcc.
  2. kernel against its plain PyTorch version on the card, exact (f32)
     and fast (bf16) projections: the cases of tests/test_pallas_kernel.py,
     a (64, 1024, 1024) slab and a (512, 1024, 1024) block of the
     1024-class geometry with C=16.  Gate: max|kernel - plain| <=
     1e-4 * max|plain|.  Times both with CUDA events.
  3. the slice end to end: a 1024^3 Shepp-Logan scan of 64 projections
     written as HIS files, reconstructed by paris_tpu_torch.cli.main
     (--backend cuda, two 512-slice z-blocks) in fast and exact mode;
     the seam slab z 510..513 and the slab z 300..303 of the ddbvf output
     are held against golden_fdk_stream (relative RMSE <= 1e-3).  The
     kernel's launch count must equal blocks x chunks per job.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists the kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

GATE_KERNEL = 1e-4       # max|kernel - plain| / max|plain|
GATE_RMSE = 1e-3         # relative RMSE against the golden oracle
N_PROJ = 64
CHUNK = 16
BLOCK_DZ = 512
SLABS = [(510, 4), (300, 4)]     # (z0, dz): the block seam, an interior slab


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from paris_tpu_torch import _build
    path, seconds, log = _build.build(force=True)
    _build.load_library()
    print(f"build: {seconds:.2f} s -> {os.path.relpath(path)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return seconds


def _kernel_cases():
    """The cases of tests/test_pallas_kernel.py (:40, :53, :66, :80, :254)."""
    import numpy as np
    from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
    base = DetectorGeometry(96, 80, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
    offset = DetectorGeometry(96, 80, 2.0, 2.0, 4.6, -2.0, 500.0, 500.0, 2.0)
    tall = DetectorGeometry(96, 640, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 2.0)
    table = [
        # name, det, seed, angles, dz (None = whole), z_offset, roi, base vol
        ("zero", base, 7, [0.0, 33.0, 261.5], None, 0, (0, 0, 0), False),
        ("accumulate", base, 7, [0.0, 33.0, 261.5], None, 0, (0, 0, 0), True),
        ("z_offset_roi", base, 7, [0.0, 33.0, 261.5], 16, 24, (5, 3, 2),
         False),
        ("offset_detector", offset, 9, [10.0, 190.0], None, 0, (0, 0, 0),
         False),
        ("top_edge", tall, 23, [15.0, 200.0], 16, 536, (0, 0, 0), False),
    ]
    for name, det, seed, ang, dz, z_off, roi, nonzero in table:
        vol = derive_volume_geometry(det)
        rng = np.random.default_rng(seed)
        projs = rng.standard_normal((len(ang), det.n_col, det.n_row)).astype(
            np.float32)
        shape = vol.shape_zyx if dz is None else (dz, vol.dim_y, vol.dim_x)
        vol0 = (np.random.default_rng(8).standard_normal(shape).astype(
            np.float32) if nonzero else np.zeros(shape, np.float32))
        yield name, det, vol, projs, np.asarray(ang, np.float32), vol0, \
            z_off, roi


def _config3():
    from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
    det = DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                           360.0 / N_PROJ)
    return det, derive_volume_geometry(det)


class _Compare:
    """Kernel against plain version on the card, same inputs."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, vol0, projs, ang, det, vol, z_off, roi, dtype):
        import numpy as np
        import torch
        from paris_tpu_torch.ops.backprojection_cuda import \
            backproject_chunk_cuda
        from paris_tpu_torch.ops.backprojection_torch import (
            backproject_chunk_torch, make_bp_grid)
        dev = torch.device("cuda", 0)
        phi = np.deg2rad(ang).astype(np.float32)
        # fast mode: both sides read the same bf16-rounded projections
        p = torch.as_tensor(projs, device=dev).to(dtype).contiguous()
        s = torch.as_tensor(np.sin(phi), device=dev)
        c = torch.as_tensor(np.cos(phi), device=dev)
        grid = make_bp_grid(det, vol)
        v0 = torch.as_tensor(vol0, device=dev) if isinstance(
            vol0, np.ndarray) else vol0
        plain = backproject_chunk_torch(v0.clone(), p, s, c, grid, z_off, roi)
        kern = backproject_chunk_cuda(v0.clone(), p, s, c, grid, z_off, roi)
        torch.cuda.synchronize()
        err = float((kern - plain).abs().max())
        scale = float(plain.abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        ok = math.isfinite(err) and err <= GATE_KERNEL * scale
        print(f"  {label:<34} {str(dtype).split('.')[-1]:<9} "
              f"max|err| {err:.3e}  max|plain| {scale:.3e}  "
              f"rel {err / max(scale, 1e-30):.2e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {label}")
        return p, s, c, grid


def _time_ms(fn, n, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel():
    import numpy as np
    import torch
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    from paris_tpu_torch.ops.backprojection_torch import \
        backproject_chunk_torch
    cmp = _Compare()
    print("kernel against plain version (gate max|err| <= "
          f"{GATE_KERNEL:g} * max|plain|):")
    for dtype in (torch.float32, torch.bfloat16):
        for name, det, vol, projs, ang, vol0, z_off, roi in _kernel_cases():
            cmp.check(name, vol0, projs, ang, det, vol, z_off, roi, dtype)

    det, vol = _config3()
    rng = np.random.default_rng(2024)
    projs = rng.standard_normal((CHUNK, det.n_col, det.n_row)).astype(
        np.float32)
    ang = (np.arange(CHUNK, dtype=np.float32) * 360.0 / N_PROJ
           + np.float32(1.3))
    dev = torch.device("cuda", 0)
    timings = {}
    for dtype, mode in ((torch.float32, "exact"), (torch.bfloat16, "fast")):
        for dz, z0 in ((64, 0), (64, 480), (BLOCK_DZ, BLOCK_DZ)):
            shape = (dz, vol.dim_y, vol.dim_x)
            vol0 = torch.zeros(shape, device=dev)
            p, s, c, grid = cmp.check(
                f"1024-class {shape} C={CHUNK} z0={z0}", vol0, projs, ang,
                det, vol, z0, (0, 0, 0), dtype)
            if z0 == 0:
                continue
            acc = torch.zeros(shape, device=dev)
            ms = _time_ms(lambda: backproject_chunk_cuda(
                acc, p, s, c, grid, z0), n=10 if dz == 64 else 3, warmup=2)
            plain_ms = _time_ms(lambda: backproject_chunk_torch(
                acc, p, s, c, grid, z0), n=3 if dz == 64 else 1)
            upd = dz * vol.dim_y * vol.dim_x * CHUNK
            timings[(mode, dz)] = (ms, plain_ms)
            print(f"  time {mode:<5} {shape} C={CHUNK}: kernel {ms:.3f} ms "
                  f"({upd / ms / 1e6:.1f} Gupd/s), plain {plain_ms:.3f} ms "
                  f"({upd / plain_ms / 1e6:.1f} Gupd/s)")
            del acc
    return cmp.max_abs_err, timings


def _rel_rmse(a, b):
    import numpy as np
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))
                 / np.abs(b).max())


def phase_end_to_end(workdir):
    import numpy as np
    from paris_tpu.geometry import plan_z_blocks
    from paris_tpu.golden import golden_fdk_stream
    from paris_tpu.io import ddbvf
    from paris_tpu.io.geometry_file import dump_geometry_file
    from paris_tpu.io.his import write_his
    from paris_tpu.phantom import cone_beam_project
    from paris_tpu_torch import cli
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda

    det, vol = _config3()
    angles = np.arange(N_PROJ, dtype=np.float32) * det.delta_phi
    t0 = time.perf_counter()
    projs = cone_beam_project(det, angles,
                              scale_mm=vol.dim_x * vol.l_vx_x / 2 * 0.9)
    print(f"end to end: {vol.shape_zyx} volume, {N_PROJ} projections of "
          f"{det.n_col}x{det.n_row} (synthesized on the host in "
          f"{time.perf_counter() - t0:.1f} s)")
    pdir = os.path.join(workdir, "proj")
    os.makedirs(pdir)
    for i in range(0, N_PROJ, 16):
        write_his(os.path.join(pdir, f"b{i:05d}.his"), projs[i:i + 16],
                  number_dtype=np.float32)
    geo = os.path.join(workdir, "scan.geo")
    dump_geometry_file(det, geo)

    t0 = time.perf_counter()
    golden = golden_fdk_stream(zip(projs, angles), det, vol, SLABS,
                               dtype=np.float32)
    print(f"  golden_fdk_stream of {SLABS}: "
          f"{time.perf_counter() - t0:.1f} s on the host")
    del projs

    n_blocks = plan_z_blocks(vol, block_dz=BLOCK_DZ).num
    per_job = n_blocks * -(-N_PROJ // CHUNK)
    results = {}
    backproject_chunk_cuda.launches = 0          # main path starts here
    for mode in ("fast", "exact"):
        before = backproject_chunk_cuda.launches
        t0 = time.perf_counter()
        rc = cli.main(["--geometry", geo, "--input", pdir,
                       "--output", workdir, "--name", f"c3{mode}",
                       "--backend", "cuda", "--block-dz", str(BLOCK_DZ),
                       "--chunk-size", str(CHUNK), "--accuracy", mode])
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.main ({mode}) exited {rc}")
        launched = backproject_chunk_cuda.launches - before
        if launched != per_job:
            raise AssertionError(
                f"{mode}: kernel launched {launched} times, expected "
                f"{n_blocks} blocks x {per_job // n_blocks} chunks")
        out = os.path.join(workdir, f"c3{mode}.ddbvf")
        if ddbvf.open_meta(out) != (vol.dim_x, vol.dim_y, vol.dim_z):
            raise AssertionError(f"{mode}: wrong ddbvf dimensions")
        rmse = {}
        for (z0, dz), ref in zip(SLABS, golden):
            got = ddbvf.read_slices(out, z0, dz)
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise AssertionError(f"{mode}: bad slab at z {z0}")
            rmse[f"z{z0}..{z0 + dz - 1}"] = _rel_rmse(got, ref)
            if z0 == SLABS[0][0]:            # the two slices at the seam
                for k in (1, 2):
                    rmse[f"z{z0 + k}"] = _rel_rmse(got[k], ref[k])
        os.remove(out)
        gups = vol.voxels * N_PROJ / seconds / 1e9
        print(f"  {mode}: {seconds:.2f} s per job ({gups:.2f} Gupd/s end to "
              f"end), {n_blocks} blocks, {launched} launches, relative RMSE "
              + ", ".join(f"{k} {v:.2e}" for k, v in rmse.items()))
        bad = {k: v for k, v in rmse.items()
               if not (math.isfinite(v) and v <= GATE_RMSE)}
        if bad:
            raise AssertionError(f"{mode}: RMSE gate {GATE_RMSE:g} failed "
                                 f"at {bad}")
        results[mode] = seconds
    return backproject_chunk_cuda.launches, results


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    import torch
    phase_build()
    max_abs_err, timings = phase_kernel()
    with tempfile.TemporaryDirectory(prefix="paris_smoke_") as workdir:
        launches, _ = phase_end_to_end(workdir)
    ms, plain_ms = timings[("fast", 64)]
    print(json.dumps({"kernels": [{
        "name": "bp_kernel (fast: bf16 projections, f32 arithmetic)",
        "route": "cuda",
        "source": "paris_tpu_torch/csrc/backproject.cu",
        "replaces": "paris_tpu/ops/backprojection_pallas.py:921",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
