"""K1 on the card: its bound, and the kernel against an earlier revision's.

    python -m paris_tpu_torch.benchmarks.k1_compare [--parent-source OLD.cu]

Times, beside each other, three backprojection kernels:

  parent   the kernel of an earlier revision (``--parent-source``: a
           ``csrc/backproject.cu`` of the untiled form, one thread per
           column and 16 slices, ``template <typename T> bp_kernel``, taps
           through L1), built with an occupancy query appended;
  staged   this revision's kernel as the planner launches it: footprint
           tiles staged into shared memory;
  global   this revision's kernel forced to its global-memory taps, the
           instantiation the planner takes where no tile ring fits.

At BASELINE config 3's shapes (C = 16): a (512, 1024, 1024) block on its
516-row detector band and a (64, 1024, 1024) slab on the whole detector,
each in exact (f32) and fast (bf16) mode, it checks every kernel against
the plain version (gate 1e-4 max|plain|) and against the first one (bit
for bit or not), then times them in alternating order with CUDA events.
It prints, per kernel and case, ms, Gupd/s, ptxas registers, resident
blocks per SM and the share of K1's bound, and writes them as JSON to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..geometry import DetectorGeometry, derive_volume_geometry, \
    detector_row_band
from ..ops import backprojection_cuda as bc
from ..ops.backprojection_torch import (backproject_chunk_torch,
                                        kernel_constants, make_bp_grid)

__all__ = ["PEAK_F32_FLOPS", "PEAK_INT32_OPS", "HBM_BYTES_PER_S",
           "k1_bound_ms", "ptxas_registers", "config3", "time_ms", "main"]

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

# the untiled launcher's arguments (device, stream, buffers, 11 ints, 13
# floats), and the occupancy query appended to its source
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PARENT_ARGTYPES = [_i, _p, _p, _p, _i, _p, _p] + [_i] * 11 + [_f] * 13
_PARENT_OCCUPANCY = r"""
extern "C" int k1_parent_blocks_per_sm(int bf16) {
  int n = 0;
  const void* fn = bf16 ? (const void*)bp_kernel<__nv_bfloat16>
                        : (const void*)bp_kernel<float>;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, BX * BY, 0)
      == cudaSuccess ? n : -1;
}
"""


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
    instantiation that ``plan`` launches (None: the untiled kernel, which
    has no shape or copy parameters), from ptxas's -v report (``Compiling
    entry function``, then ``N bytes spill stores``, then ``Used N
    registers``)."""
    want_t = "13__nv_bfloat16" if bf16 else "If"
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
            if want_t not in name:
                continue
            if plan is not None:
                _, by, zr = bc.SHAPES[plan.shape]
                if f"Li{by}ELi{zr}ELi{plan.copy}E" not in name:
                    continue
            return int(m.group(1)), spill
    return None, 0


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


def cases():
    """(label, dtype, (dz, ny, nx), global z0, v_lo, vp) at config 3: the
    first 512-slice block on the job's band (the widest over both blocks),
    and a 64-slice slab on the whole detector."""
    det, vol = config3()
    bands = [detector_row_band(det, vol, z0, BLOCK_DZ)
             for z0 in (0, BLOCK_DZ)]
    vp = max(hi - lo for lo, hi in bands)
    v_lo = max(0, min(bands[0][0], det.n_col - vp))
    out = []
    for dtype, mode in ((torch.float32, "exact"), (torch.bfloat16, "fast")):
        out.append((f"block {mode}", dtype, (BLOCK_DZ, vol.dim_y, vol.dim_x),
                    0, v_lo, vp))
        out.append((f"slab {mode}", dtype, (64, vol.dim_y, vol.dim_x), 480, 0,
                    det.n_col))
    return out


class _Parent:
    """The earlier revision's untiled kernel, built from its source."""
    name = "parent"

    def __init__(self, source: str):
        out_dir = os.path.join(_build.BUILD_DIR, "k1_compare")
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "parent.cu")
        with open(source) as f, open(src, "w") as g:
            g.write(f.read() + _PARENT_OCCUPANCY)
        self.path = os.path.join(out_dir, "libparent.so")
        self.proc = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", self.path, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait(self):
        out, err = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent:\n{out}{err}")
        self.log = out + err
        self.lib = ctypes.CDLL(self.path)
        self.lib.paris_bp_launch.argtypes = _PARENT_ARGTYPES
        self.lib.paris_bp_launch.restype = _i

    def plan(self, grid, band, shape, z0):
        return None

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
                             "inv_lpr", "inv_lpc", "vb")])
        if rc != 0:
            raise RuntimeError(f"parent: launch failed, CUDA error {rc}")

    def blocks_per_sm(self, bf16, plan):
        return self.lib.k1_parent_blocks_per_sm(int(bf16))


class _Current:
    """This revision's kernel, as planned (``staged``) or forced to its
    global-memory taps (``global``)."""

    def __init__(self, name: str, log: str):
        self.name, self.log = name, log

    def plan(self, grid, band, shape, z0):
        if self.name == "global":
            return bc.TilePlan(0, bc.COPY_GLOBAL, grid.det.n_row,
                               band.shape[1], 0)
        return bc.launch_plan(grid, shape, band, z0)

    def launch(self, vol, proj, sin, cos, grid, z0, v_lo, plan):
        bc.backproject_chunk_cuda(vol, proj, sin, cos, grid, z0, v_lo=v_lo,
                                  plan=plan)

    def blocks_per_sm(self, bf16, plan):
        return bc.blocks_per_sm(plan, bf16)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", default=None,
                    help="backproject.cu of the revision to compare with")
    ap.add_argument("--rounds", type=int, default=5,
                    help="alternating timing rounds per case")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    parent = _Parent(args.parent_source) if args.parent_source else None
    log = _build.build(["backproject"])["backproject"][2]
    kernels = [_Current("staged", log), _Current("global", log)]
    if parent is not None:
        parent.wait()
        kernels.insert(0, parent)
    print(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s")

    det, vol = config3()
    grid = make_bp_grid(det, vol)
    rng = np.random.default_rng(2024)
    projs = rng.standard_normal((CHUNK, det.n_col, det.n_row)).astype(
        np.float32)
    phi = np.deg2rad(np.arange(CHUNK, dtype=np.float32) * 360.0 / N_PROJ
                     + np.float32(1.3)).astype(np.float32)
    sin = torch.as_tensor(np.sin(phi), device=dev)
    cos = torch.as_tensor(np.cos(phi), device=dev)
    rows = []
    for label, dtype, shape, z0, v_lo, vp in cases():
        full = torch.as_tensor(projs, device=dev).to(dtype)
        band = full[:, v_lo:v_lo + vp].contiguous()
        del full
        plans = {kern.name: kern.plan(grid, band, shape, z0)
                 for kern in kernels}
        plain = backproject_chunk_torch(torch.zeros(shape, device=dev), band,
                                        sin, cos, grid, z0, v_lo=v_lo)
        scale = float(plain.abs().max())
        first, checks = None, {}
        for kern in kernels:
            out = torch.zeros(shape, device=dev)
            kern.launch(out, band, sin, cos, grid, z0, v_lo, plans[kern.name])
            torch.cuda.synchronize()
            err = float((out - plain).abs().max())
            if first is None:
                first = out
            checks[kern.name] = (err, bool(torch.equal(out, first)))
            del out
        del plain, first
        acc = torch.zeros(shape, device=dev)
        n = 3 if shape[0] == BLOCK_DZ else 10
        times = {kern.name: [] for kern in kernels}
        for r in range(args.rounds):
            for kern in (kernels if r % 2 == 0 else kernels[::-1]):
                plan = plans[kern.name]
                times[kern.name].append(time_ms(lambda: kern.launch(
                    acc, band, sin, cos, grid, z0, v_lo, plan), n))
        del acc
        bf16 = dtype == torch.bfloat16
        bound, bound_by = k1_bound_ms(*shape, CHUNK, vp, det.n_row,
                                      band.element_size())
        updates = shape[0] * shape[1] * shape[2] * CHUNK
        print(f"{label} {shape} C={CHUNK}, band {v_lo}..{v_lo + vp - 1}; "
              f"bound {bound:.3f} ms ({bound_by}), max|plain| {scale:.3e}")
        for kern in kernels:
            plan = plans[kern.name]
            ms = statistics.median(times[kern.name])
            regs, spill = ptxas_registers(kern.log, bf16, plan)
            err, same = checks[kern.name]
            row = dict(case=label, kernel=kern.name, ms=ms,
                       ms_all=times[kern.name], gupd_s=updates / ms / 1e6,
                       registers=regs, spill_bytes=spill,
                       blocks_per_sm=kern.blocks_per_sm(bf16, plan),
                       bound_ms=bound, bound_by=bound_by,
                       bound_share=bound / ms, max_abs_err=err,
                       rel_err=err / scale, equals_first=same,
                       tile=None if plan is None else
                       [plan.shape, plan.copy, plan.tile_h, plan.pitch,
                        plan.smem])
            rows.append(row)
            print(f"  {kern.name:<7} {ms:8.3f} ms  {row['gupd_s']:7.1f} "
                  f"Gupd/s  regs {regs} (spill {spill} B)  blocks/SM "
                  f"{row['blocks_per_sm']}  bound share "
                  f"{row['bound_share']:.1%}  rel err {row['rel_err']:.1e}  "
                  f"== {kernels[0].name} {same}  tile {row['tile']}")
            if not row["rel_err"] <= 1e-4:
                raise AssertionError(f"{kern.name} disagrees with plain at "
                                     f"{label}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return {"rows": rows}


if __name__ == "__main__":
    main()
