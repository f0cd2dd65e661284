"""K1 on the card: its bound, and the kernel against other builds of it.

    python -m paris_tpu_torch.benchmarks.k1_compare [--parent-source OLD.cu]
        [--source LABEL=OTHER.cu]... [--cases NAME...] [--sass DIR]
        [--out FILE.json]

Times, beside each other, backprojection kernels of this revision's C
interface (``paris_bp_launch`` with its block shape, copy mode and tile
arguments, ``paris_bp_blocks_per_sm``):

  staged   this revision's kernel as the planner launches it: footprint
           tiles staged into shared memory;
  global   this revision's kernel forced to its global-memory taps, the
           instantiation the planner takes where no tile ring fits;
  parent   ``--parent-source``: the kernel of an earlier revision;
  LABEL    each ``--source``: another build, e.g. a scratch copy of
           ``csrc/backproject.cu`` with one thing changed (no compile
           switches go into the shipped source).
Every build is launched with this revision's plan (``launch_plan``).

At the shapes K1 runs at (``CASES``: config 3's slab and 512-slice block,
``bench``'s 1024³ block at C = 24, a config-5 block at C = 8 and 16, the
offset detector's block on its band, a block of RabbitCT's whole derived
volume, and voxels 6 and 8.4 detector pixels wide, whose footprints take
the smaller block shape or global taps), each in exact (f32) and fast (bf16)
mode, it checks every kernel against the plain version (gate 1e-4
max|plain|) and against ``staged`` (bit for bit or not), then times them
in alternating order with CUDA events.  It prints, per kernel and case,
ms, Gupd/s, ptxas registers and spills, resident blocks per SM and the
share of K1's bound, and writes them as JSON to ``--out``.  With
``--sass DIR`` it writes ``cuobjdump -sass`` of each build to
``DIR/<label>.sass`` and adds ``sass_counts`` of each to the JSON.  It
exits non-zero if a kernel misses the gate.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..geometry import (DetectorGeometry, VolumeGeometry,
                        derive_volume_geometry, detector_row_band,
                        plan_z_blocks)
from ..ops import backprojection_cuda as bc
from ..ops.backprojection_torch import (backproject_chunk_torch,
                                        kernel_constants, make_bp_grid)

__all__ = ["PEAK_F32_FLOPS", "PEAK_INT32_OPS", "HBM_BYTES_PER_S", "CASES",
           "k1_bound_ms", "ptxas_registers", "sass_counts", "config3",
           "time_ms", "main"]

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: f32 outside
# the tensor cores, HBM3.  The sheet gives no int32 rate: an SM issues 64
# int32 operations a clock against 128 f32 FMAs, so at the clock that
# gives 67 TFLOP/s (132 SMs x 128 x 2 x 1.98 GHz) it is a quarter of it.
PEAK_F32_FLOPS = 67e12
PEAK_INT32_OPS = PEAK_F32_FLOPS / 4
HBM_BYTES_PER_S = 3.35e12
# f32 operations of the backprojection (an FMA counts as 2), from its
# formula: per voxel update the v coordinate (2), the two row lerps (6),
# the column lerp (4), the weight and the add (2), and 1 - fv (1); per
# (x, y) column and angle s, t, the source clamp's sum, the reciprocal,
# f, u, the weight, h, its fraction and the row scale (19).
FLOP_PER_UPDATE = 15
FLOP_PER_COLUMN_ANGLE = 19

N_PROJ, CHUNK, BLOCK_DZ = 64, 16, 512

# The cases, by name: what they are is in ``case()``
CASES = ("slab", "c3-block", "cube-c24", "c5-block-c8", "c5-block-c16",
         "offset-block", "rabbit-block", "coarse-voxels", "wide-footprint")
# opcodes that end a straight run of SASS, and the conversions
_BRANCHES = ("BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BAR", "BSYNC",
             "BSSY", "WARPSYNC")
_CONVERSIONS = ("F2I", "I2F", "FRND", "F2F", "I2I", "F2FP")


def k1_bound_ms(dz: int, ny: int, nx: int, C: int, vp: int, n_row: int,
                elem_bytes: int) -> Tuple[float, str]:
    """(least ms, what bounds it) for one launch of K1 on an H100: the
    larger of its f32 operations over the peak f32 rate and its bytes
    (volume read and written once, the projections and angles read once)
    over the HBM rate."""
    updates = dz * ny * nx * C
    flops = updates * FLOP_PER_UPDATE + ny * nx * C * FLOP_PER_COLUMN_ANGLE
    nbytes = 2 * 4 * dz * ny * nx + C * vp * n_row * elem_bytes + 2 * 4 * C
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_registers(log: str, bf16: bool, plan: Optional[bc.TilePlan] = None
                    ) -> Tuple[Optional[int], int]:
    """(registers a thread uses, bytes it spills) of the bp_kernel
    instantiation that ``plan`` launches (None: the first of the
    projection type), from ptxas's -v report (``Compiling entry
    function``, then ``N bytes spill stores``, then ``Used N
    registers``).  An instantiation's template arguments are (type, BY,
    ZR, tile pitch, copy): the pitch ``FAST_PITCH`` where the plan's is
    that on the largest shape with cp.async, else 0; a build from before
    PR 20 has no pitch argument."""
    want_t = "13__nv_bfloat16" if bf16 else "If"
    shape = None
    if plan is not None:
        _, by, zr = bc.SHAPES[plan.shape]
        fast = (plan.shape, plan.copy, plan.pitch) == (
            0, bc.COPY_ASYNC, bc.FAST_PITCH)
        shape = re.compile(rf"Li{by}ELi{zr}E(Li{bc.FAST_PITCH if fast else 0}"
                           rf"E)?Li{plan.copy}E")
    entry, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "bp_kernel" in entry:
            name = entry
            entry = None
            if want_t not in name or (shape and not shape.search(name)):
                continue
            return int(m.group(1)), spill
    return None, 0


def sass_counts(sass: str) -> Dict[str, dict]:
    """Per bp_kernel function of a ``cuobjdump -sass`` listing: its
    instructions, conversions and shared-memory loads, and its straight
    runs (no branch or barrier) that hold loads, each as (instructions,
    loads, conversions, first address): the z steps are such runs, ZR
    updates each, with four taps an update."""
    out: Dict[str, dict] = {}
    fn = None
    run: List[str] = []
    runs: List[Tuple[int, int, int, str]] = []

    def close():
        loads = sum(op.startswith(("LDS", "LDG", "LD.")) for op in run)
        if loads:
            conv = sum(op.split(".")[0] in _CONVERSIONS for op in run)
            runs.append((len(run), loads, conv, first[0]))
        run.clear()

    first = [""]
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if fn:
                close()
            fn = m.group(1) if "bp_kernel" in m.group(1) else None
            if fn:
                out[fn] = {"instructions": 0, "conversions": 0, "lds": 0,
                           "opcodes": collections.Counter()}
                runs = out[fn]["runs"] = []
            continue
        m = re.match(
            r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", line)
        if not fn or not m or m.group(2) == "NOP":
            continue
        op = m.group(2)
        base = op.split(".")[0]
        info = out[fn]
        info["instructions"] += 1
        info["opcodes"][base] += 1
        info["conversions"] += base in _CONVERSIONS
        info["lds"] += base == "LDS"
        if base in _BRANCHES:
            close()
            continue
        if not run:
            first[0] = m.group(1)
        run.append(op)
    if fn:
        close()
    for info in out.values():
        info["opcodes"] = dict(info["opcodes"])
        info["runs"].sort(key=lambda r: -r[1])
    return out


def config3():
    det = DetectorGeometry(1024, 1024, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                           360.0 / N_PROJ)
    return det, derive_volume_geometry(det)


def time_ms(fn, n, warmup=1):
    """ms per call of ``fn`` over ``n`` calls between CUDA events."""
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


def _band(det, vol, extent, z0):
    """(v_lo, vp) of the block at z0 in a plan of ``extent``-slice blocks:
    the widest band over the plan's blocks, placed as the Reconstructor
    places it."""
    starts = range(0, vol.dim_z, extent)
    vp = max(hi - lo for lo, hi in (detector_row_band(det, vol, z, extent)
                                    for z in starts))
    if vp >= det.n_col:
        return 0, det.n_col
    lo, _ = detector_row_band(det, vol, z0, extent)
    return max(0, min(lo, det.n_col - vp)), vp


def case(name: str):
    """(det, vol, (dz, ny, nx), global z0, v_lo, vp, C) of a case: config
    3's 64-slice slab on the whole detector and first 512-slice block on
    its band; ``bench``'s 1024³ block at C = 24; config 5's second
    344-slice block (chip_smoke.py phase 6) at C = 8 and 16; the offset
    detector's second 136-slice block (phase 9) at v_lo > 0; the second
    256-slice block of RabbitCT's whole derived volume (1248 x 960
    detector); previews of a 2048² detector of 0.25-mm pixels at
    magnification 1.5 with voxels 1 mm (6 pixels) and 1.4 mm (8.4 pixels)
    wide, whose footprints take the smaller block shape in float32 and the
    larger in bf16, and global taps in float32 and the smaller shape in
    bf16."""
    if name in ("slab", "c3-block"):
        det, vol = config3()
        if name == "slab":
            return det, vol, (64, vol.dim_y, vol.dim_x), 480, 0, det.n_col, \
                CHUNK
        return (det, vol, (BLOCK_DZ, vol.dim_y, vol.dim_x), 0,
                *_band(det, vol, BLOCK_DZ, 0), CHUNK)
    if name in ("coarse-voxels", "wide-footprint"):
        det = DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0, 2048.0,
                               1024.0, 360.0 / N_PROJ)
        n, l_vx = (256, 1.0) if name == "coarse-voxels" else (128, 1.4)
        vol = VolumeGeometry(dim_x=n, dim_y=n, dim_z=n, l_vx_x=l_vx,
                             l_vx_y=l_vx, l_vx_z=l_vx)
        return det, vol, (n, n, n), 0, 0, det.n_col, CHUNK
    if name == "cube-c24":
        from .bench import geometry
        det, vol = geometry(1024)
        return (det, vol, (1024, vol.dim_y, vol.dim_x), 0,
                *_band(det, vol, 1024, 0), 24)
    if name in ("c5-block-c8", "c5-block-c16"):
        from .synth_c5_3600 import config5
        det = config5(64)
        extent, C = 344, (8 if name.endswith("c8") else 16)
    elif name == "rabbit-block":
        det = DetectorGeometry(1248, 960, 0.308, 0.308, 0.0, 0.0, 785.0,
                               415.0, 360.0 / 496)
        extent, C = 256, CHUNK
    elif name == "offset-block":
        from .offset_detector import CHUNK as C, geometry
        det, extent = geometry(512, 384, 256), 136
    else:
        raise ValueError(f"unknown case {name!r}; known: {CASES}")
    vol = derive_volume_geometry(det)
    info = plan_z_blocks(vol, block_dz=extent)
    z0 = info.blocks[1].z0
    return (det, vol, (info.dim_z_padded, vol.dim_y, vol.dim_x), z0,
            *_band(det, vol, info.dim_z_padded, z0), C)


class _Build:
    """One build of the kernel's library: launched with this revision's
    plan, or forced to its global taps."""

    def __init__(self, label: str, lib, log: str, rule: str, path: str):
        self.label, self.lib, self.log, self.rule = label, lib, log, rule
        self.path = path

    def plan(self, grid, band, shape, z0):
        if self.rule == "global":
            return bc.TilePlan(0, bc.COPY_GLOBAL, grid.det.n_row,
                               band.shape[1], 0)
        return bc.launch_plan(grid, shape, band, z0)

    def launch(self, vol, proj, sin, cos, grid, z0, v_lo, plan):
        dz, ny, nx = vol.shape
        C, vp, n_row = proj.shape
        k = kernel_constants(grid)
        rc = self.lib.paris_bp_launch(
            vol.device.index, torch.cuda.current_stream().cuda_stream,
            vol.data_ptr(), proj.data_ptr(), int(proj.dtype == torch.bfloat16),
            sin.data_ptr(), cos.data_ptr(), C, grid.det.n_col, n_row, vp,
            v_lo, dz, ny, nx, 0, 0, z0,
            *[k[n] for n in ("off_x", "off_y", "off_z", "l_vx_x", "l_vx_y",
                             "l_vx_z", "d_so", "d_sd", "safe_min", "h_min",
                             "inv_lpr", "inv_lpc", "vb")],
            plan.shape, plan.copy, plan.pitch, plan.tile_h, plan.smem)
        if rc != 0:
            raise RuntimeError(f"{self.label}: launch at {plan} failed, "
                               f"CUDA error {rc}")

    def blocks_per_sm(self, bf16, plan):
        return self.lib.paris_bp_blocks_per_sm(
            torch.cuda.current_device(), plan.shape, int(bf16), plan.copy,
            plan.smem)


def _load(path: str):
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in _build.LIBRARIES["backproject"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _start_build(label: str, source: str):
    out_dir = os.path.join(_build.BUILD_DIR, "k1_compare")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"lib{label}.so")
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", path, source],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, path


def _sass(path: str) -> str:
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", default=None,
                    help="backproject.cu of the revision to compare with")
    ap.add_argument("--source", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="another backproject.cu to build and time")
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--rounds", type=int, default=5,
                    help="alternating timing rounds per case")
    ap.add_argument("--sass", default=None,
                    help="write each build's cuobjdump -sass here")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    specs = [("parent", args.parent_source)] if args.parent_source else []
    specs += [tuple(s.split("=", 1)) for s in args.source]
    started = [(label, *_start_build(label, path)) for label, path in specs]
    path, _, log = _build.build(["backproject"])["backproject"]
    lib = _build.load_library("backproject")
    builds = [_Build("staged", lib, log, "plan", path),
              _Build("global", lib, log, "global", path)]
    failed = []
    for label, proc, path in started:
        out, err = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {label}:\n{out}{err}")
            failed.append(label)
            continue
        builds.append(_Build(label, _load(path), out + err, "plan", path))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi}; built {len(builds)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    sass = {}
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        for b in builds:
            if b.label == "global":
                continue
            text = _sass(b.path)
            with open(os.path.join(args.sass, f"{b.label}.sass"), "w") as f:
                f.write(text)
            sass[b.label] = sass_counts(text)

    rng = np.random.default_rng(2024)
    rows = []
    for name in args.cases:
        det, vol, shape, z0, v_lo, vp, C = case(name)
        grid = make_bp_grid(det, vol)
        projs = rng.standard_normal((C, vp, det.n_row)).astype(np.float32)
        phi = np.deg2rad(np.arange(C, dtype=np.float32) * det.delta_phi
                         + np.float32(1.3)).astype(np.float32)
        sin = torch.as_tensor(np.sin(phi), device=dev)
        cos = torch.as_tensor(np.cos(phi), device=dev)
        for dtype, mode in ((torch.float32, "exact"),
                            (torch.bfloat16, "fast")):
            label = f"{name} {mode}"
            band = torch.as_tensor(projs, device=dev).to(dtype)
            plans = {b.label: b.plan(grid, band, shape, z0) for b in builds}
            plain = backproject_chunk_torch(
                torch.zeros(shape, device=dev), band, sin, cos, grid, z0,
                v_lo=v_lo)
            scale = float(plain.abs().max())
            first, checks = None, {}
            for b in builds:
                out = torch.zeros(shape, device=dev)
                b.launch(out, band, sin, cos, grid, z0, v_lo, plans[b.label])
                torch.cuda.synchronize()
                err = float((out - plain).abs().max())
                if first is None:
                    first = out
                checks[b.label] = (err, bool(torch.equal(out, first)))
                del out
            del plain, first
            acc = torch.zeros(shape, device=dev)
            one = time_ms(lambda: builds[0].launch(
                acc, band, sin, cos, grid, z0, v_lo, plans["staged"]), 1)
            n = max(1, min(20, round(100.0 / one)))
            times = {b.label: [] for b in builds}
            for r in range(args.rounds):
                for b in (builds if r % 2 == 0 else builds[::-1]):
                    plan = plans[b.label]
                    times[b.label].append(time_ms(lambda: b.launch(
                        acc, band, sin, cos, grid, z0, v_lo, plan), n))
            del acc
            bf16 = dtype == torch.bfloat16
            bound, bound_by = k1_bound_ms(*shape, C, vp, det.n_row,
                                          band.element_size())
            updates = shape[0] * shape[1] * shape[2] * C
            print(f"{label} {shape} C={C}, band {v_lo}..{v_lo + vp - 1}; "
                  f"bound {bound:.3f} ms ({bound_by}), max|plain| "
                  f"{scale:.3e}")
            for b in builds:
                plan = plans[b.label]
                ms = statistics.median(times[b.label])
                regs, spill = ptxas_registers(b.log, bf16, plan)
                err, same = checks[b.label]
                row = dict(case=label, kernel=b.label, ms=ms,
                           ms_all=times[b.label], gupd_s=updates / ms / 1e6,
                           registers=regs, spill_bytes=spill,
                           blocks_per_sm=b.blocks_per_sm(bf16, plan),
                           bound_ms=bound, bound_by=bound_by,
                           bound_share=bound / ms, max_abs_err=err,
                           rel_err=err / scale, equals_staged=same,
                           tile=[plan.shape, plan.copy, plan.tile_h,
                                 plan.pitch, plan.smem])
                rows.append(row)
                print(f"  {b.label:<10} {ms:8.3f} ms  {row['gupd_s']:7.1f} "
                      f"Gupd/s  regs {regs} (spill {spill} B)  blocks/SM "
                      f"{row['blocks_per_sm']}  bound share "
                      f"{row['bound_share']:.1%}  rel err "
                      f"{row['rel_err']:.1e}  == staged {same}  tile "
                      f"{row['tile']}")
    result = {"device": smi, "rows": rows, "sass": sass,
              "failed_builds": failed}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    bad = [f"{r['kernel']} at {r['case']}" for r in rows
           if not r["rel_err"] <= 1e-4]
    if bad or failed:
        raise SystemExit(f"k1_compare: over the 1e-4 gate: {bad}; builds "
                         f"that failed: {failed}")
    return result


if __name__ == "__main__":
    main()
