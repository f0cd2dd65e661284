"""Drives the PyTorch/CUDA port (paris_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure; the script then exits non-zero):
  0. device: needs torch.cuda.is_available(); prints the card's
     nvidia-smi name and power limit, torch and CUDA versions.
  1. build: compiles paris_tpu_torch/csrc/backproject.cu and
     gather_micro.cu with nvcc and the host I/O library csrc/paris_io.cpp
     with c++ (one process each, started together), loads all three, and
     prints ptxas's register and spill lines; the port's native I/O must
     be available, and the kernel's block shapes must be the planner's.
  2. kernel against its plain PyTorch version on the card, exact (f32)
     and fast (bf16) projections: the cases of tests/test_pallas_kernel.py,
     a (64, 1024, 1024) slab and a (512, 1024, 1024) block of the
     1024-class geometry with C=16.  Gate: max|kernel - plain| <=
     1e-4 * max|plain|.  Times both with CUDA events, and prints the
     kernel's tile plan, ptxas registers, resident blocks per SM and its
     share of K1's bound (paris_tpu_torch/benchmarks/k1_compare.py).
     The kernel's global-memory taps (its plan where no tile ring fits):
     forced at every case, equal bit for bit to the staged kernel, and
     through the planner at two geometries no ring fits, same gate.
  3. the slice end to end: a 1024^3 Shepp-Logan scan of 64 projections
     written as HIS files, reconstructed by paris_tpu_torch.cli.main
     (--backend cuda, two 512-slice z-blocks) in fast and exact mode;
     the seam slab z 510..513 and the slab z 300..303 of the ddbvf output
     are held against golden_fdk_stream (relative RMSE <= 1e-3).  The
     kernel's launch count must equal blocks x chunks per job.  A third
     job, fast mode with --trace-dir, must write one torch.profiler trace
     per block, each holding the block's kernel launches; from them it
     prints the summed kernel and memcpy time and the device busy share
     of the traced windows.
  4. the gather micro-benchmarks K3a and K3b: every (mode, S) of
     gather_micro.main and every mode of gather_micro2.main, kernel
     against plain version on the card, int32 equality in every block
     slice; then both main()s, the entry points a user runs, with their
     launch counts; ns per gather beside the plain version's.
  5. the distributed path and the detector-row band (K1c):
     a. the kernel at the two (512, 1024, 1024) config-3 blocks, fed only
        the block's band of detector rows (as the job feeds it), in exact
        and fast mode: equal bit for bit to the kernel fed the whole
        detector, and within 1e-4 * max|plain| of the plain version on
        the same band; the band's rows, the kernel's ms banded and
        unbanded (CUDA events), and the banded launch's registers,
        blocks per SM and share of K1's bound;
     b. phase 3's fast job again through cli.main with --distributed: a
        world-1 NCCL group, real all-gathers, all_reduce and barriers.
        Same RMSE and launch gates; its ddbvf must equal phase 3's fast
        job's byte for byte.  Job seconds beside the single-device job's.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists the kernels with their launches (K1: the jobs of phases 3 and 5b,
each counted from 0 just before it), errors, times and bounds (K1: ms per
launch at the fast (64, 1024, 1024) slab; K3a/K3b: ms per (64, 128) tile
of 64 gathers, the kernel's from a launch of 256 tiles).  bound_ms is the
larger of the bytes the function moves over 3.35 TB/s and its operations
over the card's peak rate for their type: K1's over 67 TFLOP/s (f32,
outside the tensor cores), K3's 32-bit integer adds over 16.75 T/s (64
int32 lanes an SM against 128 f32, so a quarter of the f32 FMA rate; the
data sheet gives no int32 rate).
No single PyTorch call computes any of the three functions, so
library_ms is null.
"""

from __future__ import annotations

import glob
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
    from paris_tpu_torch.io import native
    from paris_tpu_torch.ops import backprojection_cuda as bc
    t0 = time.perf_counter()
    built = _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} "
          f"libraries, nvcc and c++ in parallel")
    for name, (path, seconds, log) in built.items():
        _build.load_library(name)
        print(f"  {name}: {seconds:.2f} s -> {os.path.relpath(path)}")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  ptxas: {line.strip()}")
    if not native.available():
        raise RuntimeError("the port's native I/O library did not load")
    if bc.compiled_shapes() != (bc.SHAPES, bc.RING):
        raise AssertionError(f"kernel block shapes {bc.compiled_shapes()} "
                             f"differ from the planner's "
                             f"{(bc.SHAPES, bc.RING)}")
    return {name: log for name, (_, _, log) in built.items()}


_COPY = {0: "element copies", 1: "cp.async", 2: "taps from global memory"}


def _k1_profile(log, p, vol_shape, z0, grid):
    """The K1 launch's tile plan, ptxas registers (and spills), resident
    blocks per SM and bound, for projections ``p`` into a block of
    ``vol_shape`` at global z0; returns (text, bound_ms, bound_by)."""
    import torch
    from paris_tpu_torch.benchmarks.k1_compare import (k1_bound_ms,
                                                       ptxas_registers)
    from paris_tpu_torch.ops import backprojection_cuda as bc
    C, vp, n_row = p.shape
    bf16 = p.dtype == torch.bfloat16
    plan = bc.launch_plan(grid, vol_shape, p, z0)
    regs, spill = ptxas_registers(log, bf16, plan)
    blocks = bc.blocks_per_sm(plan, bf16, p.device)
    bound, bound_by = k1_bound_ms(*vol_shape, C, vp, n_row, p.element_size())
    text = (f"block {bc.SHAPES[plan.shape]}, tile {plan.tile_h} x "
            f"{plan.pitch} ({plan.smem} B of shared memory, "
            f"{_COPY[plan.copy]}), {regs} registers ({spill} B spilled), "
            f"{blocks} blocks/SM")
    return text, bound, bound_by


def _kernel_cases():
    """The cases of tests/test_pallas_kernel.py (:40, :53, :66, :80, :254)."""
    import numpy as np
    from paris_tpu_torch.geometry import DetectorGeometry, derive_volume_geometry
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


def _no_ring_cases():
    """(name, det, vol) whose tiles no block shape's ring fits: a volume
    reaching the source of a large detector, and voxels 12 detector pixels
    wide (as in tests/test_torch_cuda.py)."""
    from paris_tpu_torch.geometry import DetectorGeometry, VolumeGeometry
    return [
        ("near_source",
         DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 60.0, 60.0, 2.0),
         VolumeGeometry(dim_x=40, dim_y=40, dim_z=8,
                        l_vx_x=4.0, l_vx_y=4.0, l_vx_z=4.0)),
        ("coarse_preview",
         DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                          1.0),
         VolumeGeometry(dim_x=96, dim_y=96, dim_z=48,
                        l_vx_x=2.0, l_vx_y=2.0, l_vx_z=2.0)),
    ]


def _config3():
    from paris_tpu_torch.benchmarks.k1_compare import config3
    return config3()


class _Compare:
    """Kernel against plain version on the card, same inputs."""

    def __init__(self):
        self.max_abs_err = 0.0

    def check(self, label, vol0, projs, ang, det, vol, z_off, roi, dtype,
              plan=None):
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
        kern = backproject_chunk_cuda(v0.clone(), p, s, c, grid, z_off, roi,
                                      plan=plan)
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
        return p, s, c, grid, kern


def _time_ms(fn, n, warmup=1):
    from paris_tpu_torch.benchmarks.k1_compare import time_ms
    return time_ms(fn, n, warmup)


def phase_kernel(logs):
    import numpy as np
    import torch
    from paris_tpu_torch.ops.backprojection_cuda import (
        COPY_GLOBAL, TilePlan, backproject_chunk_cuda, launch_plan)
    from paris_tpu_torch.ops.backprojection_torch import (
        backproject_chunk_torch, make_bp_grid)
    cmp = _Compare()
    print("kernel against plain version (gate max|err| <= "
          f"{GATE_KERNEL:g} * max|plain|):")
    for dtype in (torch.float32, torch.bfloat16):
        for name, det, vol, projs, ang, vol0, z_off, roi in _kernel_cases():
            *_, staged = cmp.check(name, vol0, projs, ang, det, vol, z_off,
                                   roi, dtype)
            direct = cmp.check(
                f"{name}, global taps forced", vol0, projs, ang, det, vol,
                z_off, roi, dtype,
                plan=TilePlan(0, COPY_GLOBAL, det.n_row, det.n_col, 0))[-1]
            if not torch.equal(direct, staged):
                raise AssertionError(f"{name}: global taps differ from the "
                                     "staged kernel")
        rng = np.random.default_rng(31)
        for name, det, vol in _no_ring_cases():
            projs = rng.standard_normal((4, det.n_col, det.n_row)).astype(
                np.float32)
            ang = np.asarray([0.0, 47.0, 133.5, 290.0], np.float32)
            p = torch.as_tensor(projs, device="cuda").to(dtype)
            plan = launch_plan(make_bp_grid(det, vol), vol.shape_zyx, p, 0)
            if plan.copy != COPY_GLOBAL:
                raise AssertionError(f"{name}: planned {plan}, expected "
                                     "global taps")
            cmp.check(f"{name} (no ring fits)", np.zeros(
                vol.shape_zyx, np.float32), projs, ang, det, vol, 0,
                (0, 0, 0), dtype)
    print("  global taps forced at every case equal the staged kernel bit "
          "for bit")

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
            p, s, c, grid, _ = cmp.check(
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
            text, bound, bound_by = _k1_profile(logs["backproject"], p,
                                                shape, z0, grid)
            timings[(mode, dz)] = (ms, plain_ms, bound, bound_by)
            print(f"  time {mode:<5} {shape} C={CHUNK}: kernel {ms:.3f} ms "
                  f"({upd / ms / 1e6:.1f} Gupd/s), plain {plain_ms:.3f} ms "
                  f"({upd / plain_ms / 1e6:.1f} Gupd/s); bound "
                  f"{bound:.3f} ms ({bound_by}), {bound / ms:.1%} of it; "
                  f"{text}")
            del acc
    return cmp.max_abs_err, timings


def _rel_rmse(a, b):
    import numpy as np
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))
                 / np.abs(b).max())


def _gate_job(label, out, vol, golden):
    """The job's ddbvf: its dimensions, and the relative RMSE of the gate
    slabs against golden_fdk_stream.  Returns the RMSEs; raises on a
    failed gate."""
    import numpy as np
    from paris_tpu_torch.io import ddbvf
    if ddbvf.open_meta(out) != (vol.dim_x, vol.dim_y, vol.dim_z):
        raise AssertionError(f"{label}: wrong ddbvf dimensions")
    rmse = {}
    for (z0, dz), ref in zip(SLABS, golden):
        got = ddbvf.read_slices(out, z0, dz)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: bad slab at z {z0}")
        rmse[f"z{z0}..{z0 + dz - 1}"] = _rel_rmse(got, ref)
        if z0 == SLABS[0][0]:            # the two slices at the seam
            for k in (1, 2):
                rmse[f"z{z0 + k}"] = _rel_rmse(got[k], ref[k])
    bad = {k: v for k, v in rmse.items()
           if not (math.isfinite(v) and v <= GATE_RMSE)}
    if bad:
        raise AssertionError(f"{label}: RMSE gate {GATE_RMSE:g} failed "
                             f"at {bad}")
    return rmse


def phase_end_to_end(workdir):
    import numpy as np
    from paris_tpu_torch.geometry import plan_z_blocks
    from paris_tpu_torch.golden import golden_fdk_stream
    from paris_tpu_torch.io.geometry_file import dump_geometry_file
    from paris_tpu_torch.io.his import write_his
    from paris_tpu_torch.phantom import cone_beam_project
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
    trace_dir = os.path.join(workdir, "traces")
    backproject_chunk_cuda.launches = 0          # main path starts here
    for label, mode, traced in (("fast", "fast", False),
                                ("exact", "exact", False),
                                ("fast traced", "fast", True)):
        before = backproject_chunk_cuda.launches
        name = "c3" + label.replace(" ", "_")
        t0 = time.perf_counter()
        rc = cli.main(["--geometry", geo, "--input", pdir,
                       "--output", workdir, "--name", name,
                       "--backend", "cuda", "--block-dz", str(BLOCK_DZ),
                       "--chunk-size", str(CHUNK), "--accuracy", mode]
                      + (["--trace-dir", trace_dir] if traced else []))
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.main ({label}) exited {rc}")
        launched = backproject_chunk_cuda.launches - before
        if launched != per_job:
            raise AssertionError(
                f"{label}: kernel launched {launched} times, expected "
                f"{n_blocks} blocks x {per_job // n_blocks} chunks")
        out = os.path.join(workdir, f"{name}.ddbvf")
        rmse = _gate_job(label, out, vol, golden)
        if label != "fast":              # phase 5b compares with "fast"
            os.remove(out)
        gups = vol.voxels * N_PROJ / seconds / 1e9
        print(f"  {label}: {seconds:.2f} s per job ({gups:.2f} Gupd/s end to "
              f"end), {n_blocks} blocks, {launched} launches, relative RMSE "
              + ", ".join(f"{k} {v:.2e}" for k, v in rmse.items()))
        results[label] = seconds
    launches = backproject_chunk_cuda.launches
    _read_traces(trace_dir, n_blocks, per_job // n_blocks)
    job = dict(geo=geo, pdir=pdir, golden=golden, per_job=per_job,
               fast_out=os.path.join(workdir, "c3fast.ddbvf"),
               fast_s=results["fast"])
    return launches, results, job


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _read_traces(trace_dir, n_blocks, chunks):
    """The traced job's Chrome traces: one per block, each with the
    block's kernel launches; prints the device's kernel and memcpy time
    and its busy share of the traced windows."""
    files = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    if len(files) != n_blocks:
        raise AssertionError(f"traced job wrote {len(files)} trace files, "
                             f"expected one per block ({n_blocks})")
    sums = dict.fromkeys(("window", "kernel", "HtoD", "DtoH", "busy"), 0.0)
    for path in files:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        device = [e for e in events if str(e.get("cat", "")).lower()
                  in ("kernel", "gpu_memcpy", "gpu_memset")]
        bp = [e for e in device if "bp_kernel" in e["name"]]
        if len(bp) != chunks:
            raise AssertionError(
                f"{os.path.basename(path)}: {len(bp)} backprojection "
                f"kernels in the trace, expected {chunks}")
        us = {
            "window": (max(e["ts"] + e["dur"] for e in events)
                       - min(e["ts"] for e in events)),
            "kernel": sum(e["dur"] for e in device
                          if str(e["cat"]).lower() == "kernel"),
            "HtoD": sum(e["dur"] for e in device if "HtoD" in e["name"]),
            "DtoH": sum(e["dur"] for e in device if "DtoH" in e["name"]),
            "busy": _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device]),
        }
        print(f"  trace {os.path.basename(path)}: "
              + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in us.items())
              + f", device busy {us['busy'] / us['window']:.1%}")
        for k in sums:
            sums[k] += us[k]
    share = sums["busy"] / sums["window"]
    print(f"  traced job, {n_blocks} reconstruct windows of "
          f"{sums['window'] / 1e6:.3f} s: kernels {sums['kernel'] / 1e3:.1f} "
          f"ms, memcpy HtoD {sums['HtoD'] / 1e3:.1f} ms, DtoH "
          f"{sums['DtoH'] / 1e3:.1f} ms; device busy share {share:.1%} "
          f"(idle {1 - share:.1%})")


def phase_micro():
    import functools
    import torch
    from paris_tpu_torch.benchmarks import gather_micro as gm
    from paris_tpu_torch.benchmarks import gather_micro2 as gm2
    dev = torch.device("cuda", 0)
    tab, idx = gm.inputs(dev)
    k0, tab2, idx2 = gm2.inputs(dev)
    cases = {}              # (id, main() key) -> (kernel call, plain call)
    for mode, S in [("empty", 32)] + list(gm.CASES):
        key = "empty_ns" if mode == "empty" else f"{mode}_{S}_ns"
        cases[("K3a", key)] = (
            functools.partial(gm.gather_micro_cuda, mode, S, tab, idx),
            functools.partial(gm.gather_micro_torch, mode, S, tab, idx))
    for mode in gm2.MODES:
        cases[("K3b", f"{mode}_ns")] = (
            functools.partial(gm2.gather_micro2_cuda, mode, k0, tab2, idx2),
            functools.partial(gm2.gather_micro2_torch, mode, k0, tab2, idx2))
    print(f"gather micro-benchmarks: kernel ({gm.BLOCKS} block slices) "
          "against plain version, gate int32 equality in every slice:")
    max_err = {"K3a": 0, "K3b": 0}
    plain_ns = {}
    for (kid, key), (kern, plain) in cases.items():
        want = plain()
        got = kern()
        torch.cuda.synchronize()
        if got.shape != (gm.BLOCKS, 64, 128):
            raise AssertionError(f"{kid} {key}: output {tuple(got.shape)}")
        diff = (got.long() - want.long()).abs()
        bad = int(diff.flatten(1).amax(1).gt(0).sum())
        max_err[kid] = max(max_err[kid], int(diff.max()))
        print(f"  {kid} {key[:-3]:<12} {bad} of {got.shape[0]} slices "
              f"differ  {'ok' if bad == 0 else 'FAIL'}")
        if bad:
            raise AssertionError(f"{kid} {key}: kernel differs from plain "
                                 f"in {bad} block slices")
        plain_ns[(kid, key)] = gm.time_launches(plain, n=3) * 1e6 / gm.REPS
    # ms per (64, 128) tile of REPS gathers, for the kernels line
    tile_ms = {}
    for kid, key in (("K3a", "lane_128_ns"), ("K3b", "dyn_take2_ns")):
        kern, plain = cases[(kid, key)]
        tile_ms[kid] = (gm.time_launches(kern) / gm.BLOCKS,
                        gm.time_launches(plain, n=3))

    gm.gather_micro_cuda.launches = 0        # main path starts here
    gm2.gather_micro2_cuda.launches = 0
    ns = {"K3a": gm.main(), "K3b": gm2.main()}
    launches = {"K3a": gm.gather_micro_cuda.launches,
                "K3b": gm2.gather_micro2_cuda.launches}
    expect = {"K3a": (1 + len(gm.CASES)) * (1 + gm.TIMED),
              "K3b": len(gm2.MODES) * (1 + gm.TIMED)}
    if launches != expect:
        raise AssertionError(f"main(): {launches} launches, expected {expect}")
    print("  ns per (64, 128) gather: kernel from main(), the empty loop "
          "subtracted; plain, 3 calls between CUDA events, not subtracted "
          "(its time is the host's launch rate):")
    for (kid, key), p_ns in plain_ns.items():
        k_ns = ns[kid][key]
        if kid == "K3b" and key != "empty_ns":   # gather_micro2 reports raw
            k_ns -= ns[kid]["empty_ns"]
        print(f"  {kid} {key[:-3]:<12} kernel {k_ns:9.3f}   plain "
              f"{p_ns:11.1f}" + ("   (the empty loop itself)"
                                 if key == "empty_ns" else ""))
    return launches, max_err, tile_ms


def phase_band(logs):
    """5a: K1c at the config-3 blocks; returns max|banded - plain|."""
    import numpy as np
    import torch
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    from paris_tpu_torch.ops.backprojection_torch import (
        backproject_chunk_torch, make_bp_grid)
    from paris_tpu_torch.pipeline import Reconstructor
    from paris_tpu_torch.geometry import detector_row_band
    det, vol = _config3()
    z0s = (0, BLOCK_DZ)
    # the job's band: the widest over the blocks, placed per block by the
    # Reconstructor the job builds
    vp = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, z0, BLOCK_DZ) for z0 in z0s))
    rec = Reconstructor(det, vol, chunk_size=CHUNK, backend="cuda",
                        block_shape=(BLOCK_DZ, vol.dim_y, vol.dim_x),
                        v_band_width=vp)
    rng = np.random.default_rng(2025)
    projs = rng.standard_normal((CHUNK, det.n_col, det.n_row)).astype(
        np.float32)
    phi = np.deg2rad(np.arange(CHUNK, dtype=np.float32) * 360.0 / N_PROJ
                     + np.float32(0.7)).astype(np.float32)
    dev = torch.device("cuda", 0)
    s = torch.as_tensor(np.sin(phi), device=dev)
    c = torch.as_tensor(np.cos(phi), device=dev)
    grid = make_bp_grid(det, vol)
    shape = (BLOCK_DZ, vol.dim_y, vol.dim_x)
    max_err = 0.0
    print(f"detector-row band (K1c): {vp} of {det.n_col} rows "
          f"({vp / det.n_col:.1%}); gates: banded == unbanded bit for bit, "
          f"max|banded - plain| <= {GATE_KERNEL:g} * max|plain|")
    for dtype, mode in ((torch.float32, "exact"), (torch.bfloat16, "fast")):
        p = torch.as_tensor(projs, device=dev).to(dtype).contiguous()
        for z0 in z0s:
            v_lo = rec._v_band_lo(z0)
            band = p[:, v_lo:v_lo + vp].contiguous()
            zero = torch.zeros(shape, device=dev)
            whole = backproject_chunk_cuda(zero.clone(), p, s, c, grid, z0)
            banded = backproject_chunk_cuda(zero.clone(), band, s, c, grid,
                                            z0, v_lo=v_lo)
            plain = backproject_chunk_torch(zero.clone(), band, s, c, grid,
                                            z0, v_lo=v_lo)
            torch.cuda.synchronize()
            same = bool(torch.equal(banded, whole))
            err = float((banded - plain).abs().max())
            scale = float(plain.abs().max())
            max_err = max(max_err, err)
            ok = same and math.isfinite(err) and err <= GATE_KERNEL * scale
            del whole, plain
            acc = zero
            ms_band = _time_ms(lambda: backproject_chunk_cuda(
                acc, band, s, c, grid, z0, v_lo=v_lo), n=5, warmup=1)
            ms_whole = _time_ms(lambda: backproject_chunk_cuda(
                acc, p, s, c, grid, z0), n=5, warmup=1)
            text, bound, bound_by = _k1_profile(logs["backproject"], band,
                                                shape, z0, grid)
            print(f"  {mode:<5} block z0={z0:<4} rows {v_lo}..{v_lo + vp - 1}"
                  f": banded == unbanded {same}, max|err| {err:.3e} "
                  f"max|plain| {scale:.3e}; kernel {ms_band:.3f} ms banded "
                  f"({bound / ms_band:.1%} of the {bound:.3f} ms bound, "
                  f"{bound_by}), {ms_whole:.3f} ms unbanded; {text}  "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1c check failed at {mode} z0={z0}")
            del acc, banded, zero
    return max_err


def phase_distributed(workdir, job):
    """5b: phase 3's fast job over a world-1 NCCL group; returns the
    kernel's launches in that job."""
    from paris_tpu_torch import cli
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    det, vol = _config3()
    backproject_chunk_cuda.launches = 0          # this path starts here
    t0 = time.perf_counter()
    rc = cli.main(["--geometry", job["geo"], "--input", job["pdir"],
                   "--output", workdir, "--name", "c3dist", "--backend",
                   "cuda", "--block-dz", str(BLOCK_DZ), "--chunk-size",
                   str(CHUNK), "--accuracy", "fast", "--distributed"])
    seconds = time.perf_counter() - t0
    launched = backproject_chunk_cuda.launches
    if rc != 0:
        raise RuntimeError(f"cli.main (--distributed) exited {rc}")
    if launched != job["per_job"]:
        raise AssertionError(f"--distributed: kernel launched {launched} "
                             f"times, expected {job['per_job']}")
    out = os.path.join(workdir, "c3dist.ddbvf")
    rmse = _gate_job("--distributed", out, vol, job["golden"])
    same = _same_bytes(out, job["fast_out"])
    print(f"distributed (world 1, NCCL), fast: {seconds:.2f} s per job "
          f"(single-device fast job {job['fast_s']:.2f} s), {launched} "
          f"launches, relative RMSE "
          + ", ".join(f"{k} {v:.2e}" for k, v in rmse.items())
          + f"; ddbvf byte-identical to the single-device job: {same}")
    if not same:
        raise AssertionError("--distributed ddbvf differs from the "
                             "single-device fast job's")
    return launched


def _gather_tile_bound_ms(table_bytes):
    """Least ms per (64, 128) tile of a 256-tile gather micro-benchmark
    launch: its output tile written once (32 KiB) and its share of the
    table and index reads, over 3.35 TB/s, against one 32-bit integer add
    per element per rep (64 x 8192) over the int32 rate."""
    from paris_tpu_torch.benchmarks.k1_compare import (HBM_BYTES_PER_S,
                                                       PEAK_INT32_OPS)
    nbytes = 64 * 128 * 4 + (table_bytes + 64 * 128 * 4) / 256
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 64 * 64 * 128 / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _same_bytes(a, b, block=64 << 20):
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(block), fb.read(block)
            if x != y:
                return False
            if not x:
                return True


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    import torch
    logs = phase_build()
    max_abs_err, timings = phase_kernel(logs)
    with tempfile.TemporaryDirectory(prefix="paris_smoke_") as workdir:
        launches, _, job = phase_end_to_end(workdir)
        micro_launches, micro_err, tile_ms = phase_micro()
        max_abs_err = max(max_abs_err, phase_band(logs))
        launches += phase_distributed(workdir, job)
    ms, plain_ms, bound, bound_by = timings[("fast", 64)]
    kernels = [{
        "name": "bp_kernel (fast: bf16 projections, f32 arithmetic)",
        "route": "cuda",
        "source": "paris_tpu_torch/csrc/backproject.cu",
        "replaces": "paris_tpu/ops/backprojection_pallas.py:921",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    for kid, name, replaces, table_bytes in (
            ("K3a", "gather_micro_kernel (K3a; ms per tile, lane mode)",
             "benchmarks/gather_micro.py:86", 8 * 128 * 128 * 4),
            ("K3b", "gather_micro2_kernel (K3b; ms per tile, dyn_take2 mode)",
             "benchmarks/gather_micro2.py:82", 8 * 16 * 64 * 128 * 4)):
        bound, bound_by = _gather_tile_bound_ms(table_bytes)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "paris_tpu_torch/csrc/gather_micro.cu",
            "replaces": replaces,
            "launches": micro_launches[kid],
            "max_abs_err": micro_err[kid],
            "ms": tile_ms[kid][0],
            "plain_ms": tile_ms[kid][1],
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
