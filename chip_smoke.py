"""Drives the PyTorch/CUDA port (paris_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure; the script then exits non-zero):
  0. device: needs torch.cuda.is_available(); prints the card's
     nvidia-smi name and power limit, torch and CUDA versions.
  1. build: compiles paris_tpu_torch/csrc/backproject.cu and
     gather_micro.cu with nvcc (one process each, started together) and
     prints ptxas's register and spill lines.
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

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists the kernels with their launches, errors and times (K1: ms per
launch at the (64, 1024, 1024) slab; K3a/K3b: ms per (64, 128) tile of 64
gathers, the kernel's from a launch of 256 tiles).
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
    t0 = time.perf_counter()
    built = _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} "
          f"libraries, nvcc in parallel")
    for name, (path, seconds, log) in built.items():
        _build.load_library(name)
        print(f"  {name}: {seconds:.2f} s -> {os.path.relpath(path)}")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  ptxas: {line.strip()}")


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
        os.remove(out)
        gups = vol.voxels * N_PROJ / seconds / 1e9
        print(f"  {label}: {seconds:.2f} s per job ({gups:.2f} Gupd/s end to "
              f"end), {n_blocks} blocks, {launched} launches, relative RMSE "
              + ", ".join(f"{k} {v:.2e}" for k, v in rmse.items()))
        bad = {k: v for k, v in rmse.items()
               if not (math.isfinite(v) and v <= GATE_RMSE)}
        if bad:
            raise AssertionError(f"{label}: RMSE gate {GATE_RMSE:g} failed "
                                 f"at {bad}")
        results[label] = seconds
    launches = backproject_chunk_cuda.launches
    _read_traces(trace_dir, n_blocks, per_job // n_blocks)
    return launches, results


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


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    import torch
    phase_build()
    max_abs_err, timings = phase_kernel()
    with tempfile.TemporaryDirectory(prefix="paris_smoke_") as workdir:
        launches, _ = phase_end_to_end(workdir)
    micro_launches, micro_err, tile_ms = phase_micro()
    ms, plain_ms = timings[("fast", 64)]
    kernels = [{
        "name": "bp_kernel (fast: bf16 projections, f32 arithmetic)",
        "route": "cuda",
        "source": "paris_tpu_torch/csrc/backproject.cu",
        "replaces": "paris_tpu/ops/backprojection_pallas.py:921",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    for kid, name, replaces in (
            ("K3a", "gather_micro_kernel (K3a; ms per tile, lane mode)",
             "benchmarks/gather_micro.py:86"),
            ("K3b", "gather_micro2_kernel (K3b; ms per tile, dyn_take2 mode)",
             "benchmarks/gather_micro2.py:82")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "paris_tpu_torch/csrc/gather_micro.cu",
            "replaces": replaces,
            "launches": micro_launches[kid],
            "max_abs_err": micro_err[kid],
            "ms": tile_ms[kid][0],
            "plain_ms": tile_ms[kid][1],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
