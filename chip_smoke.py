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
  2b. the fast mode's u16 round trip on the card (pipeline's
     quantize_u16_torch and u16_round_trip, PyTorch ops) against the
     native quantizer (paris_quantize_u16) and quantize_chunk_u16, bit
     for bit, codes and both qparams: 1024^2 frames at C=16 and 2048^2 at
     C=8, u16 and f32 values, a constant and a zero frame, a full chunk
     and a padded tail; the round trip against dequantize_chunk of the
     native codes, bit for bit.  Its card ms per config-5 chunk (CUDA
     events) beside its bound (bytes over 3.35 TB/s) and the host
     quantizer's ms on the same chunk.
  3. the slice end to end: a 1024^3 Shepp-Logan scan of 64 projections
     written as HIS files, reconstructed by paris_tpu_torch.cli.main
     (--backend cuda, two 512-slice z-blocks) in fast and exact mode;
     the seam slab z 510..513 and the slab z 300..303 of the ddbvf output
     are held against golden_fdk_stream (relative RMSE <= 1e-3).  The
     kernel's launch count must equal blocks x chunks per job.  A third
     job, fast mode with --trace-dir, must write one torch.profiler trace
     per block, each holding the block's kernel launches; from them it
     prints the summed kernel and memcpy time and the device busy share
     of the traced windows (each block's reconstruct stage, then its
     wait for the previous block's drain).  Each job prints its
     projection cache's lines and its ingest split per block
     (reconstruct, read, stage_wait, step_enqueue, card_wait seconds;
     block 1 comes from the card cache), and the u16 round trip must run once per chunk in fast mode, never
     in exact mode.  Each job prints its drain split per block (d2h on
     the card in a traced block, write, wait seconds, slabs, the ring's
     pinned bytes: every block drains slab by slab through a ring of
     pinned slots on a copy stream, paris_tpu_torch/io/drain.py) and
     block 1's enqueue seconds while block 0 drains; the traced job's traces must show the drain's
     DtoH copies, on a stream other than K1's.  Then one config-3
     accumulator (512 slices, 500 of them valid) of seeded values is
     drained into a new ddbvf, which must equal volume.cpu() of those
     slices byte for byte; the drain's seconds, split and pinned bytes.
  4. the gather micro-benchmarks K3a and K3b: every (mode, S) of
     gather_micro.main and every mode of gather_micro2.main, kernel
     against plain version on the card at the benchmark's inputs and at
     two seeded ones (negative and large idx, k0 outside the table),
     int32 equality in every tile; no kernel may spill, and the planners'
     band plans must be the library's.  Prints per case the plan (rows,
     threads, shared-memory bytes), resident blocks per SM and ptxas
     registers; then drives both main()s, the entry points a user runs,
     with their launch counts, and prints ns per gather beside the
     earlier kernel's, the shared-memory floor and the plain version's.
     A launch the card refuses raises: nothing else runs in its place.
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
        job's byte for byte.  Job seconds beside the single-device job's,
        and its ingest split.
  6. BASELINE config 5 at full width: a 2048 x 2048 detector and the
     2048 x 2048 x 2055 volume (34.5 GB):
     a. the analytic projector on the card (phantom.cone_beam_project_torch)
        against the float64 NumPy projector on 2 frames of the 2048^2
        detector; gates relative RMSE < 1e-3 and max|err| < 0.05 * max
        (tests/test_golden_fdk_e2e.py:91-103); ms per 8-frame batch;
     b. the scan synthesized on the card as HIS files of uint16 counts
        (benchmarks.synth_c5_3600 --number-type uint16: one scale for the
        whole scan, rounded on the card; number type 4 on disk is
        checked, the scale printed), then the job through cli.main with
        --backend cuda --accuracy fast --chunk-size 8 --block-dz 344
        --max-blocks 2: blocks 0 and 1 of the six, 11.5 GB written into
        the sparse 34.5 GB ddbvf.  The seam slab z 342..345 is held
        against the golden oracle over the same stored frames, computed
        by benchmarks.golden_slab in one process per core while the job
        runs (relative RMSE <= 1e-3); K1's launches, and the u16 round
        trip's, must equal 2 blocks x 8 chunks; the job must keep its
        projection cache on the card and serve block 1 from it.  Prints
        the job's seconds, stage timers, band rows and ingest split;
     c. K1 at one (344, 2048, 2048) block (block 1, on the job's band) in
        exact and fast mode with C = 8, the job's chunk: kernel against
        plain version (1e-4 * max|plain|), ms (CUDA events), registers,
        blocks per SM and share of the bound; and fast at C = 16.
     Cut, for the time limit and the disk: 64 projections, not 3600;
     2 of the 6 blocks; fast mode only.  Needs ~12 GB of free disk in the
     temporary directory and fails, naming the bytes, without it.
  7. the benchmark layer: the main() of each module a user runs from
     paris_tpu_torch/benchmarks, on the card, each with K1's launches
     counted from 0 just before it (every one must launch K1):
     a. bench, fast and exact, at full width (a 1024^3 block, C = 24): the
        JSON line, K1 alone with its share of the bound, the repeats'
        spread; then K1 at bench's own launch (bench.setup's geometry,
        block and filtered chunk) against its plain version, same gate as
        phase 2 (these two launches are not counted);
     b. run_configs, configs 1, 2, 4 and 5 (config 5: a world-1 NCCL
        group); every RMSE gate is fatal;
     c. config3_stream at 1024 over 360 frames, fast, its kernel-only
        rate the bench fast value of 7a (PARIS_BENCH_KERNEL_GUPS): the RMSE
        gate is fatal, the 2x rate gate is printed with its verdict, and
        its plan and drain split (one per block, or the phase fails); the
        job's own plan, which on the card is two 512-slice blocks, so its
        K1 launches are 2 x 23;
     d. dist_parity_ab (--quality 1) and dist_overlap_ab at --size 512
        over one 360-frame scan written once: byte equality of the two
        drivers' outputs is fatal, the ratio gates are printed;
     e. weak_scaling_projection, with K1's rate measured on the card.
     Cut, for the disk and the time limit: run_configs' config 3 is not
     run (phase 3 runs its job: the 1024^3 volume in two 512-slice blocks
     over 64 frames, at chunk 16 instead of 8; its two jobs would write
     8 GiB more); the A/Bs run at 512, not 1024 (what they compare depends
     on the block count, three at both sizes, not on the size), one pair
     each; weak_scaling is not run (it measures gloo ranks on the CPU).
     Before each step the phase reserves the bytes the step will write and
     fails if the run's total would pass 42 GiB.

  8. the job's z-block plan (paris_tpu_torch/app.py card_block_dz, used
     by plan_job and the distributed job): the auto plans, on this card
     and with no scan, of config3_stream's job (1024^3 from 360 float32
     frames, chunk 16) and of config 5 from 3600 uint16 frames (chunk 8),
     each with its blocks, write overlap, projection cache and the rule's
     reason; config 5's must split, with the overlap and the card cache.
     Phase 9 runs the split jobs against the one-block job.
  9. a vertically offset detector (delta_s 4.6, delta_t -6.5 px; the
     detector-row band of a multi-block job follows the backprojection's
     -delta_t):
     a. paris_tpu_torch/benchmarks/offset_detector.py at its defaults: a
        512 x 384 detector (config 3's streaming geometry), the 521 x 521 x
        397 volume, 256 frames synthesized on the card, fast mode from
        uint16 counts and exact mode from float32; per mode, through
        cli.main (--backend auto), the job's own plan, a forced split in
        three blocks of 136 slices and the one-block plan (the auto job is
        it when its plan is one block), and in fast mode the split job
        again with --distributed (a world-1 NCCL group).  Every seam of
        every plan and an interior slab within 1e-3 relative RMSE of the
        golden oracle over the stored frames; every multi-block ddbvf
        byte for byte the one-block ddbvf (the distributed one the split
        one); K1 launched blocks x chunks times per job, and the u16 round
        trip so in fast mode.  The golden oracle runs in 4 processes.
        Writes ~2.8 GiB;
     b. K1 at block 1 of that split (v_lo > 0), fed the block's band of
        rows of seeded frames, in exact and fast mode: bit for bit the
        kernel fed the whole detector, and within 1e-4 * max|plain| of the
        plain version on the band.

Disk: after each phase the script prints the bytes that phase wrote and
the run's total: the bytes this process passed to write and pwrite
(/proc/self/io wchar; the chip machine's kernel keeps no write_bytes) plus
the sizes of the files its child processes wrote (the compilers'
libraries, the golden oracle's partial slabs).

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists the kernels with their launches (K1 and the u16 round trip: the
jobs of phases 3, 5b, 6b and 9a and the main()s of phase 7, each counted
from 0 just before it), errors, times and bounds (K1: ms per
launch at the fast (64, 1024, 1024) slab; K3a/K3b: ms per (64, 128) tile
of 64 gathers, the kernel's from a launch of 256 tiles; the u16 round
trip: ms per config-5 chunk, its plain_ms the host's native quantizer,
the JAX package's way; it is PyTorch ops on the card, not a hand
kernel: the JAX package had no Pallas kernel for it).  bound_ms is the
larger of the bytes the function moves over 3.35 TB/s and its operations
over the card's peak rate for their type: K1's over 67 TFLOP/s (f32,
outside the tensor cores), K3's 32-bit integer adds over 16.75 T/s (64
int32 lanes an SM against 128 f32, so a quarter of the f32 FMA rate; the
data sheet gives no int32 rate).
No single PyTorch call computes any of these functions, so library_ms
is null.
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
C5_N_PROJ = 64           # config 5's scan, cut from 3600 for the time limit
C5_CHUNK = 8
C5_BLOCK_DZ = 344
C5_MAX_BLOCKS = 2        # of the 6 blocks: bounds the disk and the time
C5_SLAB = (342, 4)       # straddles the seam between blocks 0 and 1
C5_NUMBER_TYPE = "uint16"        # the scan as a flat-panel detector writes it
DISK_LIMIT = 42 << 30    # bytes the whole run may write
AB_SIZE = 512            # the driver A/Bs' detector (phase 7d)
STREAM_NPROJ = 360       # config3_stream's and the A/Bs' scan
OFFSET_SIZE = 512        # phase 9: the offset detector's columns,
OFFSET_ROWS = 384        # its rows,
OFFSET_NPROJ = 256       # its frames,
OFFSET_SPLIT_DZ = 136    # and its forced split: three blocks
OFFSET_SHARDS = 4        # golden processes: each writes a partial per slab


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
        from paris_tpu_torch.ops.backprojection_torch import make_bp_grid
        dev = torch.device("cuda", 0)
        phi = np.deg2rad(ang).astype(np.float32)
        # fast mode: both sides read the same bf16-rounded projections
        p = torch.as_tensor(projs, device=dev).to(dtype).contiguous()
        s = torch.as_tensor(np.sin(phi), device=dev)
        c = torch.as_tensor(np.cos(phi), device=dev)
        grid = make_bp_grid(det, vol)
        v0 = torch.as_tensor(vol0, device=dev) if isinstance(
            vol0, np.ndarray) else vol0
        kern = self.compare(label, v0, p, s, c, grid, z_off, roi, plan=plan)
        return p, s, c, grid, kern

    def compare(self, label, v0, p, s, c, grid, z_off, roi, v_lo=0,
                plan=None):
        """Kernel and plain version on the same tensors on the card (rows
        [v_lo, v_lo + p.shape[1]) of the detector); returns the kernel's
        volume."""
        import torch
        from paris_tpu_torch.ops.backprojection_cuda import \
            backproject_chunk_cuda
        from paris_tpu_torch.ops.backprojection_torch import \
            backproject_chunk_torch
        plain = backproject_chunk_torch(v0.clone(), p, s, c, grid, z_off, roi,
                                        v_lo)
        kern = backproject_chunk_cuda(v0.clone(), p, s, c, grid, z_off, roi,
                                      v_lo, plan=plan)
        torch.cuda.synchronize()
        err = float((kern - plain).abs().max())
        scale = float(plain.abs().max())
        del plain
        self.max_abs_err = max(self.max_abs_err, err)
        ok = math.isfinite(err) and err <= GATE_KERNEL * scale
        print(f"  {label:<34} {str(p.dtype).split('.')[-1]:<9} "
              f"max|err| {err:.3e}  max|plain| {scale:.3e}  "
              f"rel {err / max(scale, 1e-30):.2e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {label}")
        return kern


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


def phase_quantize():
    """2b: the fast mode's u16 round trip on the card against the native
    quantizer and quantize_chunk_u16; returns (max|card - host| of the
    round trip, its timing at config 5's chunk)."""
    import numpy as np
    import torch
    from paris_tpu_torch.benchmarks.k1_compare import HBM_BYTES_PER_S
    from paris_tpu_torch.geometry import detector_row_band, plan_z_blocks
    from paris_tpu_torch.io import native
    from paris_tpu_torch.pipeline import (_u16_params, dequantize_chunk,
                                          quantize_chunk_u16,
                                          quantize_u16_torch, u16_round_trip)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(77)
    max_err = 0.0
    print("u16 round trip on the card against the native quantizer and "
          "quantize_chunk_u16 (codes and qparams bit for bit):")
    for size, C in ((1024, CHUNK), (2048, C5_CHUNK)):
        for kind in ("u16", "f32"):
            shape = (C, size, size)
            frames = (rng.integers(0, 65536, shape).astype(np.float32)
                      if kind == "u16" else
                      rng.uniform(-300, 9000, shape).astype(np.float32))
            frames[1] = 7.25                     # a constant frame
            frames[2] = 0.0                      # a zero frame
            for n in (C, C - 2):                 # and a padded tail
                frames[n:] = 0
                q = np.zeros(shape, np.uint16)
                qp = np.zeros((C, 2), np.float32)
                native.quantize_u16(np.ascontiguousarray(frames[:n]), q, qp)
                pq, pqp = quantize_chunk_u16(
                    np.ascontiguousarray(frames[:n]), C)
                x = torch.from_numpy(frames).to(dev)
                tq, tqp = quantize_u16_torch(x, n)
                tq = tq.cpu().numpy()
                tqp = tqp.cpu().numpy()
                for rq, rqp, name in ((q, qp, "native"),
                                      (pq, pqp, "quantize_chunk_u16")):
                    if not (np.array_equal(tq.astype(np.uint16), rq)
                            and np.array_equal(tqp.view(np.uint32),
                                               rqp.view(np.uint32))):
                        raise AssertionError(
                            f"u16 quantization on the card differs from "
                            f"{name} at {shape} {kind}, {n} frames")
                got = u16_round_trip(x, torch.from_numpy(tqp).to(dev))
                want = dequantize_chunk(
                    torch.from_numpy(q.astype(np.float32)).to(dev),
                    torch.from_numpy(qp).to(dev))
                err = float((got - want).abs().max())
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"u16 round trip differs at {shape}"
                                         f" {kind}, {n} frames: {err}")
                max_err = max(max_err, err)
                del x, got, want
            print(f"  {shape} {kind} frames (a constant and a zero frame; "
                  f"{C} and {C - 2} of {C} data): codes, qparams and the "
                  "round trip bit for bit")

    # time: the step's round trip on config 5's chunk and band
    from paris_tpu_torch.pipeline import Reconstructor
    det, vol = _config5()
    info = plan_z_blocks(vol, block_dz=C5_BLOCK_DZ)
    vp = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, b.z0, info.dim_z_padded)
        for b in info.blocks))
    v_lo = Reconstructor(det, vol, chunk_size=C5_CHUNK, backend="cuda",
                         block_shape=(info.dim_z_padded, vol.dim_y,
                                      vol.dim_x),
                         v_band_width=vp)._v_band_lo(info.blocks[1].z0)
    frames = rng.integers(0, 65536, (C5_CHUNK, det.n_col, det.n_row)
                          ).astype(np.float32)
    x = torch.from_numpy(frames).to(dev)
    rows = slice(v_lo, v_lo + vp)

    def card():
        return u16_round_trip(x[:, rows], _u16_params(x, C5_CHUNK))
    ms = _time_ms(card, n=20, warmup=2)
    t0 = time.perf_counter()
    for _ in range(3):
        quantize_chunk_u16(frames, C5_CHUNK)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 3
    nbytes = 4 * C5_CHUNK * det.n_col * det.n_row + 4 * C5_CHUNK * vp * \
        det.n_row
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  config 5's chunk ({C5_CHUNK} frames of {det.n_col}x"
          f"{det.n_row}, band {vp} rows): card {ms:.3f} ms per chunk "
          f"(whole-frame qparams, the band's codes and dequantization), "
          f"bound {bound:.3f} ms ({nbytes} bytes over 3.35 TB/s, "
          f"{bound / ms:.1%} of it); the host's native quantizer "
          f"{plain_ms:.1f} ms per chunk")
    del x
    return max_err, (ms, plain_ms, bound, "bytes")


def _log_splits(tap, label):
    """Print the job's cache lines, and its ingest and drain splits per
    block."""
    for line in tap.cache:
        print(f"  {label}: {line}")
    for b in tap.ingest:
        print(f"  {label}: block {b['block']} from the {b['from']}: "
              f"reconstruct {b['reconstruct_s']:.3f} s, read "
              f"{b['read_s']:.3f} s ({b['read_chunks']} chunks), stage_wait "
              f"{b['stage_wait_s']:.3f} s, step_enqueue "
              f"{b['step_enqueue_s']:.3f} s ({b['steps']} steps), card_wait "
              f"{b['card_wait_s']:.3f} s")
    _log_drain(tap.drain, label)


def _log_drain(drains, label):
    """Print a job's drain split per block."""
    for d in drains:
        print(f"  {label}: block {d['block']} drain: d2h {d['d2h_s']:.3f} s "
              f"on the card (traced blocks), write {d['write_s']:.3f} s, "
              f"wait {d['wait_s']:.3f} s ({d['slabs']} slabs of "
              f"{d['slab_slices']} slices; ring {d['pinned_bytes']} pinned "
              "bytes)")


def _reset_counts():
    """Zero the launch counts of the main path's wrappers."""
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    from paris_tpu_torch.pipeline import u16_round_trip
    backproject_chunk_cuda.launches = 0
    u16_round_trip.launches = 0


def _counts():
    """(K1's launches, the u16 round trip's) since ``_reset_counts``."""
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    from paris_tpu_torch.pipeline import u16_round_trip
    return backproject_chunk_cuda.launches, u16_round_trip.launches


def _gate_job(label, out, vol, golden):
    """The job's ddbvf: its dimensions, and the relative RMSE of the gate
    slabs against golden_fdk_stream.  Returns the RMSEs; raises on a
    failed gate."""
    import numpy as np
    from paris_tpu_torch.benchmarks.full_scale_2048_3600 import rel_rmse
    from paris_tpu_torch.io import ddbvf
    if ddbvf.open_meta(out) != (vol.dim_x, vol.dim_y, vol.dim_z):
        raise AssertionError(f"{label}: wrong ddbvf dimensions")
    rmse = {}
    for (z0, dz), ref in zip(SLABS, golden):
        got = ddbvf.read_slices(out, z0, dz)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: bad slab at z {z0}")
        rmse[f"z{z0}..{z0 + dz - 1}"] = rel_rmse(got, ref)
        if z0 == SLABS[0][0]:            # the two slices at the seam
            for k in (1, 2):
                rmse[f"z{z0 + k}"] = rel_rmse(got[k], ref[k])
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
    from paris_tpu_torch.benchmarks.full_scale_2048_3600 import job_log_tap

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
    _reset_counts()                              # main path starts here
    for label, mode, traced in (("fast", "fast", False),
                                ("exact", "exact", False),
                                ("fast traced", "fast", True)):
        before, trips = _counts()
        name = "c3" + label.replace(" ", "_")
        with job_log_tap() as tap:
            t0 = time.perf_counter()
            rc = cli.main(["--geometry", geo, "--input", pdir,
                           "--output", workdir, "--name", name,
                           "--backend", "cuda", "--block-dz", str(BLOCK_DZ),
                           "--chunk-size", str(CHUNK), "--accuracy", mode]
                          + (["--trace-dir", trace_dir] if traced else []))
            seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.main ({label}) exited {rc}")
        launched = _counts()[0] - before
        if launched != per_job:
            raise AssertionError(
                f"{label}: kernel launched {launched} times, expected "
                f"{n_blocks} blocks x {per_job // n_blocks} chunks")
        trips = _counts()[1] - trips
        if trips != (per_job if mode == "fast" else 0):
            raise AssertionError(f"{label}: the u16 round trip ran {trips} "
                                 "times on the card")
        out = os.path.join(workdir, f"{name}.ddbvf")
        rmse = _gate_job(label, out, vol, golden)
        if label != "fast":              # phase 5b compares with "fast"
            os.remove(out)
        gups = vol.voxels * N_PROJ / seconds / 1e9
        print(f"  {label}: {seconds:.2f} s per job ({gups:.2f} Gupd/s end to "
              f"end), {n_blocks} blocks, {launched} launches, relative RMSE "
              + ", ".join(f"{k} {v:.2e}" for k, v in rmse.items()))
        _log_splits(tap, label)
        if len(tap.ingest) < 2 or len(tap.drain) != n_blocks:
            raise AssertionError(f"{label}: {len(tap.ingest)} ingest and "
                                 f"{len(tap.drain)} drain splits in the log")
        b1 = tap.ingest[1]
        print(f"  {label}: block 1 (from the {b1['from']}) enqueued its "
              f"{b1['steps']} steps in {b1['step_enqueue_s']:.3f} s while "
              "block 0 drained (0.81-0.84 s on an H100 at 700 W when "
              "one pageable copy drained a block)")
        results[label] = seconds
    launches = _counts()
    _read_traces(trace_dir, n_blocks, per_job // n_blocks)
    # a tail block's valid slices: not a whole number of slabs
    _drain_equality(workdir, BLOCK_DZ, BLOCK_DZ - 12)
    job = dict(geo=geo, pdir=pdir, golden=golden, per_job=per_job,
               fast_out=os.path.join(workdir, "c3fast.ddbvf"),
               fast_s=results["fast"])
    return launches, results, job


def _drain_equality(workdir, dz, dim_z):
    """One config-3 accumulator (dz, 1024, 1024) of seeded values on the
    card, its first ``dim_z`` slices drained slab by slab through the
    job's ``BlockDrain`` into a new ddbvf: byte for byte ``volume.cpu()``
    of them (the composition before the drain), read back.  Prints the
    drain's seconds, split and pinned bytes."""
    import numpy as np
    import torch
    from paris_tpu_torch.io import ddbvf
    from paris_tpu_torch.io.drain import DRAIN_SLOTS, BlockDrain
    from paris_tpu_torch.utils.logging import StageTimers
    _, vol = _config3()
    shape = (dz, vol.dim_y, vol.dim_x)
    device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(9)
    volume = torch.randn(shape, generator=gen, device=device)
    drain = BlockDrain(device, shape[1:], dz)
    path = ddbvf.create(os.path.join(workdir, "drain.ddbvf"), vol.dim_x,
                        vol.dim_y, dim_z)
    split = StageTimers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ready = torch.cuda.Event()
    ready.record()
    drain.drain(volume, path, 0, dim_z, ready=ready, split=split)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = volume[:dim_z].cpu().numpy()
    cpu_s = time.perf_counter() - t0
    got = np.memmap(path, np.float32, "r", offset=ddbvf.DATA_START,
                    shape=want.shape)
    same = bool(np.array_equal(got.view(np.uint32), want.view(np.uint32)))
    del got
    os.remove(path)
    t, c = split.totals, split.counts
    print(f"  drain of one {shape} block, {dim_z} valid slices: "
          f"{seconds:.3f} s (write {t.get('write', 0.0):.3f} s, wait "
          f"{t.get('copy_wait', 0.0):.3f} s; {c.get('write', 0)} slabs of "
          f"{drain.slices} slices; ring {drain.pinned_bytes} pinned bytes); "
          f"volume.cpu() of them alone {cpu_s:.3f} s; byte-identical to "
          f"volume.cpu(): {same}")
    if not same:
        raise AssertionError("the slab drain's ddbvf differs from "
                             "volume.cpu() of the block")
    if drain.pinned_bytes > DRAIN_SLOTS * (4 * drain.slices * vol.dim_y
                                          * vol.dim_x + 4096):
        raise AssertionError(f"the drain pinned {drain.pinned_bytes} bytes, "
                             "more than its ring")


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
    and its busy share of the reconstruct windows (each trace up to its
    "drain_wait" range) and, apart, of the drain-wait windows (the job
    waiting for the previous block's drain)."""
    files = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    if len(files) != n_blocks:
        raise AssertionError(f"traced job wrote {len(files)} trace files, "
                             f"expected one per block ({n_blocks})")
    sums = dict.fromkeys(("window", "kernel", "HtoD", "DtoH", "busy", "h2d",
                          "d2h", "DtoH copies", "wait window", "wait busy"),
                         0.0)
    streams = {"kernel": set(), "DtoH": set()}
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
        (wait,) = [e for e in events if e["name"] == "drain_wait" and
                   str(e.get("cat", "")).lower() == "user_annotation"]
        start = min(e["ts"] for e in events)
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in device]
        us = {
            "window": wait["ts"] - start,
            "kernel": sum(e["dur"] for e in device
                          if str(e["cat"]).lower() == "kernel"),
            "HtoD": sum(e["dur"] for e in device if "HtoD" in e["name"]),
            "DtoH": sum(e["dur"] for e in device if "DtoH" in e["name"]),
            "busy": _busy_us([(a, min(b, wait["ts"])) for a, b in spans
                              if a < wait["ts"]]),
            "h2d": sum(e["name"] == "h2d" for e in events),
            "d2h": sum(e["name"] == "d2h" for e in events),
            "DtoH copies": sum("DtoH" in e["name"] for e in device),
            "wait window": wait["dur"],
            "wait busy": _busy_us([
                (max(a, wait["ts"]), min(b, wait["ts"] + wait["dur"]))
                for a, b in spans
                if b > wait["ts"] and a < wait["ts"] + wait["dur"]]),
        }
        for e in device:
            stream = e.get("args", {}).get("stream")
            if "bp_kernel" in e["name"]:
                streams["kernel"].add(stream)
            elif "DtoH" in e["name"]:
                streams["DtoH"].add(stream)
        print(f"  trace {os.path.basename(path)}: "
              + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in us.items()
                          if k not in ("h2d", "d2h", "DtoH copies"))
              + f", device busy {us['busy'] / us['window']:.1%} of the "
              f"reconstruct window and {_share(us, 'wait '):.1%} of the "
              "drain wait, "
              f"{us['h2d']} ring copies named h2d, {us['d2h']} drain "
              f"copies named d2h, {us['DtoH copies']} DtoH copies")
        for k in sums:
            sums[k] += us[k]
    if not sums["h2d"]:
        raise AssertionError("no ring copy named h2d in the traces")
    # block k drains while block k+1 is traced: its slabs' copies run on
    # the drain's copy stream, not the kernels'
    print(f"  traced job: {sums['d2h']:.0f} drain copies named d2h, "
          f"{sums['DtoH copies']:.0f} DtoH copies on stream(s) "
          f"{sorted(map(str, streams['DtoH']))}, K1 on stream(s) "
          f"{sorted(map(str, streams['kernel']))}")
    if not sums["DtoH copies"] or streams["DtoH"] & streams["kernel"]:
        raise AssertionError("the traces show no drain copy on a copy "
                             "stream of its own")
    share = sums["busy"] / sums["window"]
    print(f"  traced job, {sums['h2d']:.0f} ring copies named h2d; "
          f"{n_blocks} reconstruct windows of "
          f"{sums['window'] / 1e6:.3f} s: kernels {sums['kernel'] / 1e3:.1f} "
          f"ms, memcpy HtoD {sums['HtoD'] / 1e3:.1f} ms, DtoH "
          f"{sums['DtoH'] / 1e3:.1f} ms (both windows); device busy share "
          f"{share:.1%} of the reconstruct windows (idle {1 - share:.1%}); "
          f"drain-wait windows of {sums['wait window'] / 1e6:.3f} s, busy "
          f"{_share(sums, 'wait '):.1%}")


def _share(us, prefix):
    """Busy share of a window (0 for an empty one)."""
    window = us[prefix + "window"]
    return us[prefix + "busy"] / window if window else 0.0


# ns per (64, 128) gather (the empty loop not subtracted) of the kernels
# before the row-band redesign (one 1024-thread block per tile, tables read
# from global memory through L1; git revision 99c42df), measured from that
# revision's source by paris_tpu_torch/benchmarks/k3_compare.py on an NVIDIA
# H100 80GB HBM3 at 700 W and 1980 MHz.
EARLIER_NS = {
    ("K3a", "empty_ns"): 0.892, ("K3a", "lane_128_ns"): 5.281,
    ("K3a", "lane2_128_ns"): 8.747, ("K3a", "sublane_8_ns"): 4.671,
    ("K3a", "sublane_16_ns"): 4.762, ("K3a", "sublane_32_ns"): 6.826,
    ("K3a", "select_8_ns"): 10.920, ("K3a", "select_16_ns"): 18.696,
    ("K3a", "select_24_ns"): 26.653, ("K3a", "select_32_ns"): 34.424,
    ("K3b", "empty_ns"): 0.891, ("K3b", "static_read_ns"): 4.591,
    ("K3b", "dyn_read_ns"): 4.787, ("K3b", "static_take_ns"): 4.465,
    ("K3b", "dyn_take_ns"): 4.552, ("K3b", "dyn_take2_ns"): 12.837,
    ("K3b", "chain_take2_ns"): 13.465, ("K3b", "chain_only_ns"): 2.142,
}


def phase_micro(logs):
    import torch
    from paris_tpu_torch.benchmarks import gather_micro as gm
    from paris_tpu_torch.benchmarks import gather_micro2 as gm2
    from paris_tpu_torch.benchmarks.k3_compare import (ptxas_report,
                                                       sm_clock_mhz,
                                                       smem_floor_ns)
    dev = torch.device("cuda", 0)
    clock = sm_clock_mhz()
    regs = ptxas_report(logs["gather_micro"])
    spilled = {k: v for k, v in regs.items() if v[1]}
    if len(regs) != 18 or spilled:
        raise AssertionError(f"gather kernels: {len(regs)} in ptxas's "
                             f"report (18 expected), spilling: {spilled}")
    lim, lim2 = gm.compiled_limits(), gm2.compiled_limits()
    want = {(m, S): gm.plan_band(m, S).smem for m, S in lim["smem"]}
    want2 = {m: gm2.plan_ring(m).smem for m in gm2.MODES}
    if (lim["per"] != gm.PER or lim["smem"] != want
            or (lim2["ring"], lim2["per"]) != (gm2.RING, gm2.PER)
            or lim2["smem"] != want2):
        raise AssertionError(f"the gather library's limits {lim}, {lim2} "
                             "differ from the planners'")
    # the benchmark's inputs, then two seeded ones: negative and large idx,
    # random tables, k0 also outside [0, K)
    data = {"K3a": [gm.inputs(dev)] + [gm.seeded_inputs(s, dev)
                                       for s in (1, 2)],
            "K3b": [gm2.inputs(dev)] + [gm2.seeded_inputs(s, dev)
                                        for s in (1, 2)]}
    cases = {}       # (id, main() key) -> (mode, S, plan, kernel, plain)
    for mode, S in [("empty", 32)] + list(gm.CASES):
        key = "empty_ns" if mode == "empty" else f"{mode}_{S}_ns"
        cases[("K3a", key)] = (
            mode, S, gm.plan_band(mode, S),
            lambda t, mode=mode, S=S: gm.gather_micro_cuda(mode, S, *t),
            lambda t, mode=mode, S=S: gm.gather_micro_torch(mode, S, *t))
    for mode in gm2.MODES:
        cases[("K3b", f"{mode}_ns")] = (
            mode, 0, gm2.plan_ring(mode),
            lambda t, mode=mode: gm2.gather_micro2_cuda(mode, *t),
            lambda t, mode=mode: gm2.gather_micro2_torch(mode, *t))
    print(f"gather micro-benchmarks (max SM clock {clock:.0f} MHz): kernel "
          f"({gm.BLOCKS} tiles) against plain version at the benchmark's "
          "inputs and two seeded ones, gate int32 equality in every tile; "
          "the band plan (the planner's, equal to the library's), ptxas "
          "registers and resident blocks per SM:")
    max_err = {"K3a": 0, "K3b": 0}
    plain_ns, profile = {}, {}
    for (kid, key), (mode, S, plan, kern, plain) in cases.items():
        bad = 0
        for tensors in data[kid]:
            want_tile = plain(tensors)
            got = kern(tensors)
            torch.cuda.synchronize()
            if got.shape != (gm.BLOCKS, 64, 128):
                raise AssertionError(f"{kid} {key}: output "
                                     f"{tuple(got.shape)}")
            diff = (got.long() - want_tile.long()).abs()
            bad += int(diff.flatten(1).amax(1).gt(0).sum())
            max_err[kid] = max(max_err[kid], int(diff.max()))
        if kid == "K3a":
            resident = gm.blocks_per_sm(mode, S, plan, dev)
            n_regs = regs[("K3a", gm.MODES.index(mode),
                           S if mode in gm.WINDOWS else 1)]
        else:
            resident = gm2.blocks_per_sm(mode, plan, dev)
            n_regs = regs[("K3b", gm2.MODES.index(mode), 0)]
        profile[(kid, key)] = (
            f"{plan.rows} rows, {plan.threads} threads, {plan.smem} B, "
            f"{resident} blocks/SM, {n_regs[0]} registers")
        print(f"  {kid} {key[:-3]:<12} {bad} of {3 * gm.BLOCKS} tiles "
              f"differ; {profile[(kid, key)]} ({n_regs[1]} B spilled)  "
              f"{'ok' if bad == 0 else 'FAIL'}")
        if bad:
            raise AssertionError(f"{kid} {key}: kernel differs from plain "
                                 f"in {bad} tiles")
        first = data[kid][0]
        plain_ns[(kid, key)] = gm.time_launches(
            lambda: plain(first), n=3) * 1e6 / gm.REPS
    # ms per (64, 128) tile of REPS gathers, for the kernels line
    tile_ms = {}
    for kid, key in (("K3a", "lane_128_ns"), ("K3b", "dyn_take2_ns")):
        kern, plain = cases[(kid, key)][3:]
        first = data[kid][0]
        tile_ms[kid] = (gm.time_launches(lambda: kern(first)) / gm.BLOCKS,
                        gm.time_launches(lambda: plain(first), n=3))

    gm.gather_micro_cuda.launches = 0        # main path starts here
    gm2.gather_micro2_cuda.launches = 0
    ns = {"K3a": gm.main(), "K3b": gm2.main()}
    launches = {"K3a": gm.gather_micro_cuda.launches,
                "K3b": gm2.gather_micro2_cuda.launches}
    expect = {"K3a": (1 + len(gm.CASES)) * (1 + gm.TIMED),
              "K3b": len(gm2.MODES) * (1 + gm.TIMED)}
    if launches != expect:
        raise AssertionError(f"main(): {launches} launches, expected {expect}")
    print("  ns per (64, 128) gather, the empty loop not subtracted: the "
          "kernel (from main()), the kernel before the row-band redesign "
          "(EARLIER_NS), the mode's shared-memory floor at this clock "
          "(k3_compare.smem_floor_ns: conflict-free), and the plain version "
          "(3 calls between CUDA events: the host's launch rate):")
    for (kid, key), p_ns in plain_ns.items():
        mode, S = cases[(kid, key)][:2]
        k_ns = ns[kid][key]
        if kid == "K3a" and key != "empty_ns":   # gather_micro subtracts it
            k_ns += ns[kid]["empty_ns"]
        floor, floor_by = smem_floor_ns(kid, mode, S, clock)
        print(f"  {kid} {key[:-3]:<12} kernel {k_ns:7.3f}   earlier "
              f"{EARLIER_NS[(kid, key)]:7.3f}   floor {floor:6.3f} "
              f"({floor_by})   plain {p_ns:11.1f}")
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
    from paris_tpu_torch.benchmarks.full_scale_2048_3600 import job_log_tap
    det, vol = _config3()
    _reset_counts()                              # this path starts here
    with job_log_tap() as tap:
        t0 = time.perf_counter()
        rc = cli.main(["--geometry", job["geo"], "--input", job["pdir"],
                       "--output", workdir, "--name", "c3dist", "--backend",
                       "cuda", "--block-dz", str(BLOCK_DZ), "--chunk-size",
                       str(CHUNK), "--accuracy", "fast", "--distributed"])
        seconds = time.perf_counter() - t0
    launched, trips = _counts()
    if rc != 0:
        raise RuntimeError(f"cli.main (--distributed) exited {rc}")
    if launched != job["per_job"] or trips != job["per_job"]:
        raise AssertionError(f"--distributed: kernel launched {launched} "
                             f"times, the u16 round trip {trips}, expected "
                             f"{job['per_job']}")
    _log_splits(tap, "--distributed")
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
    return launched, trips


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


def _config5():
    from paris_tpu_torch.benchmarks.synth_c5_3600 import config5
    from paris_tpu_torch.geometry import derive_volume_geometry
    det = config5(C5_N_PROJ)
    return det, derive_volume_geometry(det)


def phase_projector():
    """6a: the card's projector against the NumPy one at config 5."""
    import numpy as np
    import torch
    from paris_tpu_torch.benchmarks.synth_c5_3600 import phantom_scale
    from paris_tpu_torch.phantom import (cone_beam_project,
                                         cone_beam_project_torch)
    det, vol = _config5()
    scale = phantom_scale(vol)
    ang = np.asarray([0.0, 37.5])
    t0 = time.perf_counter()
    ref = cone_beam_project(det, ang, scale)
    numpy_s = time.perf_counter() - t0
    got = cone_beam_project_torch(det, ang, scale).cpu().numpy()
    peak = float(np.abs(ref).max())
    rmse = float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)))
    err = float(np.abs(got - ref).max())
    batch = np.arange(8, dtype=np.float64) * det.delta_phi
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(lambda: cone_beam_project_torch(det, batch, scale), n=10,
                  warmup=2)
    ok = rmse / peak < 1e-3 and err / peak < 0.05
    print(f"config 5 projector (card) against the NumPy projector, 2 frames "
          f"of {det.n_col}x{det.n_row}: relative RMSE {rmse / peak:.2e} "
          f"(gate 1e-3), max|err| {err / peak:.2e} of max (gate 0.05); "
          f"{ms:.3f} ms per 8-frame batch on the card "
          f"({torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak), NumPy "
          f"{numpy_s / 2:.2f} s per frame  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's projector disagrees with NumPy")


def phase_config5(workdir):
    """6b: config 5's first two blocks through cli.main; returns K1's
    launches in that job."""
    import shutil
    import numpy as np
    from paris_tpu_torch import cli
    from paris_tpu_torch.benchmarks import golden_slab
    from paris_tpu_torch.benchmarks.full_scale_2048_3600 import (
        job_log_tap, rel_rmse)
    from paris_tpu_torch.benchmarks.synth_c5_3600 import (
        his_path, scan_bytes, synthesize)
    from paris_tpu_torch.geometry import plan_z_blocks
    from paris_tpu_torch.io import ddbvf
    from paris_tpu_torch.io.geometry_file import dump_geometry_file
    from paris_tpu_torch.io.his import read_his_header
    det, vol = _config5()
    info = plan_z_blocks(vol, block_dz=C5_BLOCK_DZ)
    blocks = info.blocks[:C5_MAX_BLOCKS]
    slice_bytes = 4 * vol.dim_x * vol.dim_y
    need = (scan_bytes(det, C5_N_PROJ, C5_NUMBER_TYPE) + slice_bytes
            * sum(b.dim_z for b in blocks) + (256 << 20))
    free = shutil.disk_usage(workdir).free
    if free < need:
        raise RuntimeError(f"phase 6 needs {need} bytes of disk in {workdir}"
                           f" (the scan and {len(blocks)} blocks), {free} "
                           "are free")
    c5dir = os.path.join(workdir, "c5")
    synth = synthesize(c5dir, det, C5_N_PROJ, subdir="proj",
                       number_type=C5_NUMBER_TYPE)
    number_type = read_his_header(
        his_path(os.path.join(c5dir, "proj"), 0)).number_type
    if number_type != 4:
        raise AssertionError(f"config 5: HIS number type {number_type} on "
                             "disk, expected 4 (uint16)")
    print(f"config 5: {vol.shape_zyx} volume, {C5_N_PROJ} projections of "
          f"{det.n_col}x{det.n_row} synthesized on the card in "
          f"{synth['seconds']:.2f} s ({synth['card_ms_per_batch']:.3f} ms "
          f"per 8-frame batch on the card, {synth['write_seconds']:.2f} s "
          f"of HIS writes), HIS number type {number_type} (uint16 counts, "
          f"{synth['map']['scale']:.6e} per count, offset "
          f"{synth['map']['offset']:g}, {synth['map']['clipped']} clipped)")
    geo = os.path.join(c5dir, "scan.geo")
    dump_geometry_file(det, geo)
    shards = os.cpu_count() or 1
    t_golden = time.perf_counter()
    procs = golden_slab.start_shards(c5dir, det, [C5_SLAB], C5_N_PROJ,
                                     shards, subdir="proj")
    try:
        _reset_counts()                              # this path starts here
        with job_log_tap() as tap:
            t0 = time.perf_counter()
            rc = cli.main(["--geometry", geo, "--input",
                           os.path.join(c5dir, "proj"), "--output", c5dir,
                           "--name", "c5", "--backend", "cuda",
                           "--accuracy", "fast", "--chunk-size",
                           str(C5_CHUNK), "--block-dz", str(C5_BLOCK_DZ),
                           "--max-blocks", str(C5_MAX_BLOCKS)])
            seconds = time.perf_counter() - t0
        launched, trips = _counts()
    except BaseException:
        for p in procs:
            p.terminate()
            p.join()
        raise
    golden = golden_slab.finish_shards(procs, c5dir, [C5_SLAB],
                                       timeout_s=900)[C5_SLAB[0]]
    golden_s = time.perf_counter() - t_golden
    if rc != 0:
        raise RuntimeError(f"cli.main (config 5) exited {rc}")
    per_job = len(blocks) * -(-C5_N_PROJ // C5_CHUNK)
    if launched != per_job or trips != per_job:
        raise AssertionError(
            f"config 5: kernel launched {launched} times, the u16 round "
            f"trip {trips}, expected {len(blocks)} blocks x "
            f"{per_job // len(blocks)} chunks")
    _log_splits(tap, "config 5")
    if not any(line.startswith("projection cache: on the card")
               for line in tap.cache) or [b["from"] for b in tap.ingest] != [
                   "HIS files"] + ["card cache"] * (len(blocks) - 1):
        raise AssertionError("config 5: later blocks were not served from "
                             f"the card cache: {tap.cache}, {tap.ingest}")
    out = os.path.join(c5dir, "c5.ddbvf")
    if ddbvf.open_meta(out) != (vol.dim_x, vol.dim_y, vol.dim_z):
        raise AssertionError("config 5: wrong ddbvf dimensions")
    with open(out + ".manifest.json") as f:
        done = json.load(f)["completed_blocks"]
    if done != [b.index for b in blocks]:
        raise AssertionError(f"config 5: blocks {done} complete, expected "
                             f"{[b.index for b in blocks]}")
    z0, dz = C5_SLAB
    got = ddbvf.read_slices(out, z0, dz)
    if got.shape != golden.shape or not np.isfinite(got).all():
        raise AssertionError("config 5: bad seam slab")
    rmse = {f"z{z0}..{z0 + dz - 1}": rel_rmse(got, golden)}
    for k in (1, 2):
        rmse[f"z{z0 + k}"] = rel_rmse(got[k], golden[k])
    updates = sum(b.dim_z for b in blocks) * vol.dim_y * vol.dim_x * C5_N_PROJ
    print(f"  fast job, blocks {done} of {info.num} ({C5_BLOCK_DZ} slices "
          f"each): {seconds:.2f} s ({updates / seconds / 1e9:.2f} Gupd/s "
          f"end to end), {launched} launches, band {tap.band_rows[0]} of "
          f"{tap.band_rows[1]} rows; stage timings: {tap.timings[-1]}; "
          "per block proj/s, Gupd/s: " + "; ".join(
              f"{p:.1f}, {g:.1f}" for p, g in tap.block_rates)
          + "; relative RMSE "
          + ", ".join(f"{k} {v:.2e}" for k, v in rmse.items())
          + f"; golden over {shards} processes {golden_s:.1f} s (in "
          f"parallel with the job)")
    bad = {k: v for k, v in rmse.items()
           if not (math.isfinite(v) and v <= GATE_RMSE)}
    if bad:
        raise AssertionError(f"config 5: RMSE gate {GATE_RMSE:g} failed at "
                             f"{bad}")
    os.remove(out)
    return launched, trips


def phase_k1_config5(logs):
    """6c: K1 at a (344, 2048, 2048) config-5 block on the job's band;
    returns max|kernel - plain|."""
    import numpy as np
    import torch
    from paris_tpu_torch.geometry import detector_row_band, plan_z_blocks
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    from paris_tpu_torch.ops.backprojection_torch import (
        backproject_chunk_torch, make_bp_grid)
    from paris_tpu_torch.pipeline import Reconstructor
    det, vol = _config5()
    info = plan_z_blocks(vol, block_dz=C5_BLOCK_DZ)
    vp = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, b.z0, info.dim_z_padded)
        for b in info.blocks))
    shape = (info.dim_z_padded, vol.dim_y, vol.dim_x)
    z0 = info.blocks[1].z0
    v_lo = Reconstructor(det, vol, chunk_size=C5_CHUNK, backend="cuda",
                         block_shape=shape, v_band_width=vp)._v_band_lo(z0)
    dev = torch.device("cuda", 0)
    grid = make_bp_grid(det, vol)
    rng = np.random.default_rng(2026)
    max_err = 0.0
    print(f"K1 at a config-5 block {shape}, z0={z0}, band rows "
          f"{v_lo}..{v_lo + vp - 1} ({vp} of {det.n_col}); gate max|err| <= "
          f"{GATE_KERNEL:g} * max|plain| at C={C5_CHUNK}:")
    for dtype, mode, C in ((torch.float32, "exact", C5_CHUNK),
                           (torch.bfloat16, "fast", C5_CHUNK),
                           (torch.bfloat16, "fast", 16)):
        projs = rng.standard_normal((C, vp, det.n_row)).astype(np.float32)
        phi = np.deg2rad(np.arange(C, dtype=np.float32) * det.delta_phi
                         + np.float32(0.9)).astype(np.float32)
        band = torch.as_tensor(projs, device=dev).to(dtype).contiguous()
        s = torch.as_tensor(np.sin(phi), device=dev)
        c = torch.as_tensor(np.cos(phi), device=dev)
        acc = torch.zeros(shape, device=dev)
        check = ""
        if C == C5_CHUNK:
            kern = backproject_chunk_cuda(torch.zeros(shape, device=dev),
                                          band, s, c, grid, z0, v_lo=v_lo)
            plain = backproject_chunk_torch(torch.zeros(shape, device=dev),
                                            band, s, c, grid, z0, v_lo=v_lo)
            torch.cuda.synchronize()
            err = float((kern - plain).abs().max())
            scale = float(plain.abs().max())
            del kern, plain
            max_err = max(max_err, err)
            if not (math.isfinite(err) and err <= GATE_KERNEL * scale):
                raise AssertionError(f"K1 disagrees with plain at config 5 "
                                     f"({mode})")
            check = (f"max|err| {err:.3e} max|plain| {scale:.3e} "
                     f"(rel {err / scale:.2e}) ok; ")
            plain_ms = _time_ms(lambda: backproject_chunk_torch(
                acc, band, s, c, grid, z0, v_lo=v_lo), n=1, warmup=0)
            check += f"plain {plain_ms:.1f} ms; "
        ms = _time_ms(lambda: backproject_chunk_cuda(
            acc, band, s, c, grid, z0, v_lo=v_lo), n=5, warmup=1)
        text, bound, bound_by = _k1_profile(logs["backproject"], band, shape,
                                            z0, grid)
        upd = shape[0] * shape[1] * shape[2] * C
        print(f"  {mode:<5} C={C:<2} {check}kernel {ms:.3f} ms "
              f"({upd / ms / 1e6:.1f} Gupd/s), {bound / ms:.1%} of the "
              f"{bound:.3f} ms bound ({bound_by}); {text}")
        del acc, band
    return max_err


class _Disk:
    """Bytes the run has written: this process's bytes passed to write and
    pwrite (/proc/self/io ``wchar``; the chip machine's kernel keeps no
    ``write_bytes``, and ``wchar`` also counts the script's own output, a
    few MB) plus the sizes of the files child processes wrote (``add``)."""

    def __init__(self):
        self.children = 0
        self.start = self.mark = self._now()

    def _now(self):
        with open("/proc/self/io") as f:
            own = next(int(line.split()[1]) for line in f
                       if line.startswith("wchar:"))
        return own + self.children

    def add(self, nbytes):
        """Count ``nbytes`` written by a child process."""
        self.children += nbytes

    def total(self):
        return self._now() - self.start

    def phase(self, label):
        now = self._now()
        print(f"disk: {label} wrote {(now - self.mark) / 2**30:.2f} GiB; "
              f"{(now - self.start) / 2**30:.2f} GiB in this run")
        self.mark = now

    def reserve(self, nbytes, label):
        if self.total() + nbytes > DISK_LIMIT:
            raise RuntimeError(
                f"{label} would write ~{nbytes / 2**30:.2f} GiB, taking the "
                f"run's {self.total() / 2**30:.2f} GiB past "
                f"{DISK_LIMIT / 2**30:.0f} GiB")


def _file_bytes(pattern):
    return sum(os.path.getsize(p) for p in glob.glob(pattern))


def phase_benchmarks(workdir, disk):
    """7: the benchmark layer's main()s on the card; returns K1's launches
    in them and the largest |kernel - plain| at bench's block."""
    from paris_tpu_torch.benchmarks import (bench, config3_stream,
                                            dist_overlap_ab, dist_parity_ab,
                                            run_configs,
                                            weak_scaling_projection)
    launches = [0, 0]

    def drive(label, main, argv, nbytes, children=0):
        disk.reserve(nbytes, label)
        print(f"{label}:", flush=True)
        _reset_counts()                          # this path starts here
        t0 = time.perf_counter()
        res = main(argv + ["--out", os.path.join(workdir, "results.json")])
        n, trips = _counts()
        if n == 0:
            raise AssertionError(f"{label}: K1 was never launched")
        launches[0] += n
        launches[1] += trips
        print(f"  {label}: {time.perf_counter() - t0:.1f} s, K1 launched "
              f"{n} times, the u16 round trip {trips}", flush=True)
        disk.add(children)
        disk.phase(label)
        return res

    cmp = _Compare()
    gups = {}
    for acc in ("fast", "exact"):
        res = drive(f"bench {acc}", bench.main,
                    ["--size", "1024", "--chunk", "24", "--accuracy", acc], 0)
        if (res["metric"] != "backprojection_gvoxel_updates_per_s_1024cube_"
                f"cuda_{acc}" or not res["value"] > 0
                or not 0 < res["k1_bound_share"] <= 1):
            raise AssertionError(f"bench {acc}: {res}")
        gups[acc] = res["value"]
        # K1 at bench's own launch: its geometry, block and filtered chunk
        rec, staged = bench.setup(1024, 24, acc, "cuda")
        chunk, sin, cos, n = staged[:4]
        filtered, v_lo = rec._filter_band(chunk, n, 0)
        cmp.compare(f"bench {acc} {rec.block_shape} C=24", rec.init_block(),
                    filtered, sin, cos, rec.grid, 0, (0, 0, 0), v_lo)
        del rec, chunk, filtered

    # the golden partials config 2's shards write, one shard per core
    cfg2_golden = (os.cpu_count() or 1) * 4 * 256 ** 3
    res = drive("run_configs 1,2,4,5", run_configs.main,
                ["--configs", "1,2,4,5"], cfg2_golden + (64 << 20),
                children=cfg2_golden)
    for r in res["results"]:
        print(f"  config {r['config']} {r['name']}: "
              + ", ".join(f"{k} {r[k]}" for k in r if k.startswith(
                  ("rel_rmse", "gupd", "pass", "mesh", "seconds"))))

    os.environ["PARIS_BENCH_CFG3_NPROJ"] = str(STREAM_NPROJ)
    os.environ.pop("PARIS_BENCH_CFG3_SCANDIR", None)
    # the rate gate's kernel-only rate: bench fast, measured above
    os.environ["PARIS_BENCH_KERNEL_GUPS"] = str(gups["fast"])
    # the scan, the job's volume, the warm-up's block; the shards' partial
    # 4-slice slabs
    stream_golden = (os.cpu_count() or 1) * 4 * 4 * 1024 ** 2
    res = drive("config3_stream", config3_stream.main,
                ["--size", "1024", "--accuracy", "fast"],
                STREAM_NPROJ * 4 * 1024 ** 2 + 4 * 1024 ** 3 + (256 << 20),
                children=stream_golden)
    os.environ.pop("PARIS_BENCH_KERNEL_GUPS")
    print(f"  {res['n_proj']} frames: reconstruct "
          f"{res['reconstruct_seconds']} s ({res['proj_per_s_stream']} proj/s,"
          f" {res['gupd_per_s_stream_reconstruct']} Gupd/s), finalize+write "
          f"{res['finalize_write_seconds']} s, end to end "
          f"{res['end_to_end_seconds']} s; centre slab relative RMSE "
          f"{res['rel_rmse_vs_golden_center_slab']:.2e} (pass_rmse "
          f"{res['pass_rmse']}); kernel-only {res['kernel_only_gupd_per_s']} "
          f"Gupd/s, rate gate (reconstruct >= kernel / 2) pass_rate "
          f"{res['pass_rate']}")
    print("  config3_stream plan: " + "; ".join(res["plan"]))
    for b in res["ingest_split"]:
        print(f"  config3_stream: block {b['block']} from the {b['from']}: "
              f"reconstruct {b['reconstruct_s']:.3f} s, read "
              f"{b['read_s']:.3f} s, stage_wait {b['stage_wait_s']:.3f} s, "
              f"step_enqueue {b['step_enqueue_s']:.3f} s, card_wait "
              f"{b['card_wait_s']:.3f} s")
    if len(res["drain_split"]) != res["blocks"]:
        raise AssertionError(f"config3_stream: drain_split "
                             f"{res['drain_split']} for {res['blocks']} "
                             "block(s)")
    _log_drain(res["drain_split"], "config3_stream")
    if not res["pass_rmse"]:
        raise AssertionError("config3_stream: the RMSE gate failed")

    os.environ["PARIS_BENCH_CFG3_SCANDIR"] = os.path.join(workdir, "scan512")
    ab_job = 4 * AB_SIZE ** 3
    for label, main, argv in (
            ("dist_parity_ab", dist_parity_ab.main,
             ["--size", str(AB_SIZE), "--n-proj", str(STREAM_NPROJ),
              "--quality", "1"]),
            ("dist_overlap_ab", dist_overlap_ab.main,
             ["--size", str(AB_SIZE), "--n-proj", str(STREAM_NPROJ)])):
        res = drive(label, main, argv,
                    STREAM_NPROJ * 4 * AB_SIZE ** 2 + 2 * ab_job + (64 << 20))
        if not res["outputs_identical"]:
            raise AssertionError(f"{label}: the drivers' outputs differ")
        print(f"  {label}: outputs byte-identical; distributed / single "
              f"{res['ratio_dist_over_single']} (gate {res['gate']}: pass "
              f"{res['pass']})")
    os.environ.pop("PARIS_BENCH_CFG3_SCANDIR")

    res = drive("weak_scaling_projection", weak_scaling_projection.main, [],
                0)
    print(f"  K1 at {res['kernel']['block']} on {res['kernel']['band_rows']} "
          f"rows: {res['kernel_gups_measured']:.1f} Gupd/s; gathered "
          f"{res['gather_bytes_small_banded']} / "
          f"{res['gather_bytes_small_full']} B banded / full at the small "
          f"geometry (the model's count); at 32 cards over "
          f"{res['nvlink_gbps_assumed']:g} GB/s NVLink: projected "
          f"efficiency {res['projected'][-1]['projected_efficiency']}, "
          f"crossover {res['crossover_gbps_for_80pct_at_32_chips']} GB/s "
          f"(pass {res['pass']})")
    return launches, cmp.max_abs_err


class _FileTable:
    """A file table of ``n_proj`` frames of ``dtype`` (what ``plan_job``
    reads of a source: its chunks' frames and raw type), for a plan made
    without a scan."""

    def __init__(self, n_proj, dtype):
        self.n_proj, self.dtype = n_proj, dtype

    def chunk_reads(self, chunk, n_threads=None):
        import types
        import numpy as np
        return [types.SimpleNamespace(dtype=np.dtype(self.dtype),
                                      rows=min(chunk, self.n_proj - i))
                for i in range(0, self.n_proj, chunk)]


def _plan_line(label, det, n_proj, dtype, chunk):
    """The job's auto plan on this card for ``n_proj`` frames of ``dtype``
    (``app.plan_job`` over a file table, with the card's free memory):
    printed, and returned."""
    import torch
    from paris_tpu_torch.app import ReconstructionJob, plan_job
    from paris_tpu_torch.benchmarks.full_scale_2048_3600 import job_log_tap
    from paris_tpu_torch.geometry import derive_volume_geometry
    job = ReconstructionJob(det=det, input_path="(no scan)",
                            output_path="(no output)", chunk_size=chunk,
                            backend="cuda")
    with job_log_tap() as tap:
        plan = plan_job(job, derive_volume_geometry(det),
                        torch.device("cuda", 0), _FileTable(n_proj, dtype))
    print(f"  plan: {label}: {plan.info.num} block(s) of "
          f"{plan.info.dim_z_padded} slices, write overlap {plan.overlap}, "
          f"projection cache {plan.cache} ({plan.cache_bytes} bytes); "
          + "; ".join(line for line in tap.plan
                      if line.startswith("block plan")))
    return plan


def phase_plan():
    """8: the job's z-block plan: the auto plans of config3_stream's job
    and of config 5 from 3600 uint16 frames on this card (no scan)."""
    import numpy as np
    from paris_tpu_torch.benchmarks.config3_stream import geometry
    from paris_tpu_torch.benchmarks.synth_c5_3600 import config5
    print("z-block plan:")
    _plan_line(f"config3_stream (1024^3, {STREAM_NPROJ} float32 frames, "
               "chunk 16)", geometry(1024, STREAM_NPROJ), STREAM_NPROJ,
               np.float32, 16)
    c5 = _plan_line("config 5 (2048 x 2048 x 2055, 3600 uint16 frames, "
                    "chunk 8)", config5(3600), 3600, np.uint16, 8)
    if not (c5.info.num > 1 and c5.overlap and c5.cache == "card"):
        raise AssertionError("config 5's auto plan takes no split with the "
                             "write overlap and the card cache")


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


def phase_offset(workdir, disk):
    """9a: the job at a vertically offset detector on the card
    (paris_tpu_torch/benchmarks/offset_detector.py, its defaults); returns
    K1's and the u16 round trip's launches in its jobs."""
    from paris_tpu_torch.benchmarks import offset_detector as od
    from paris_tpu_torch.geometry import derive_volume_geometry
    det = od.geometry(OFFSET_SIZE, OFFSET_ROWS, OFFSET_NPROJ)
    vol = derive_volume_geometry(det)
    # the u16 and f32 scans and six volumes: fast auto (two blocks on the
    # card), split, one block and split distributed; exact auto and split
    disk.reserve(OFFSET_NPROJ * det.n_row * det.n_col * (2 + 4)
                 + 6 * vol.nbytes_f32, "phase 9")
    print(f"offset detector (delta_s {det.delta_s}, delta_t {det.delta_t} "
          f"px): {det.n_row} x {det.n_col} detector, {vol.shape_zyx} volume, "
          f"{OFFSET_NPROJ} frames, split blocks of {OFFSET_SPLIT_DZ}")
    _reset_counts()                              # this path starts here
    res = od.run(OFFSET_SIZE, OFFSET_ROWS, OFFSET_NPROJ, OFFSET_SPLIT_DZ,
                 backend="auto", workdir=os.path.join(workdir, "offset"),
                 shards=OFFSET_SHARDS)
    launched, trips = _counts()
    want = sum(r["blocks"] for r in res["modes"]["fast"]["jobs"].values())
    for mode, m in res["modes"].items():
        print(f"  {mode} from {m['number_type']} frames (synthesized in "
              f"{m['synthesize_seconds']:.1f} s; golden waited "
              f"{m['golden_wait_seconds']:.1f} s):")
        for label, r in m["jobs"].items():
            same = ("" if "same_bytes" not in r else
                    f"; ddbvf byte-identical to the {r['same_bytes_as']} "
                    f"job's: {r['same_bytes']}")
            print(f"    {label}: {r['blocks']} block(s) of {r['block_dz']}, "
                  f"{r['seconds']:.2f} s, K1 {r.get('k1_launches')}, band "
                  f"{r['band_rows']}, relative RMSE "
                  + ", ".join(f"{k} {v:.2e}" for k, v in r["rel_rmse"].items())
                  + same)
            print(f"      {'; '.join(r['plan'])}")
    if res["failures"]:
        raise AssertionError("phase 9: " + "; ".join(res["failures"]))
    if trips != want * -(-OFFSET_NPROJ // od.CHUNK):
        raise AssertionError(f"phase 9: the u16 round trip ran {trips} times")
    return launched, trips


def phase_k1_offset(logs):
    """9b: K1 at block 1 of the offset detector's split, fed the block's
    band of rows (v_lo > 0) as the job feeds it; returns
    max|kernel - plain|."""
    import numpy as np
    import torch
    from paris_tpu_torch.benchmarks import offset_detector as od
    from paris_tpu_torch.geometry import (derive_volume_geometry,
                                          detector_row_band, plan_z_blocks)
    from paris_tpu_torch.ops.backprojection_cuda import backproject_chunk_cuda
    from paris_tpu_torch.ops.backprojection_torch import (
        backproject_chunk_torch, make_bp_grid)
    from paris_tpu_torch.pipeline import Reconstructor
    det = od.geometry(OFFSET_SIZE, OFFSET_ROWS, OFFSET_NPROJ)
    vol = derive_volume_geometry(det)
    info = plan_z_blocks(vol, block_dz=OFFSET_SPLIT_DZ)
    vp = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, b.z0, info.dim_z_padded)
        for b in info.blocks))
    shape = (info.dim_z_padded, vol.dim_y, vol.dim_x)
    z0 = info.blocks[1].z0
    v_lo = Reconstructor(det, vol, chunk_size=od.CHUNK, backend="cuda",
                         block_shape=shape, v_band_width=vp)._v_band_lo(z0)
    if not 0 < v_lo < det.n_col - vp:
        raise AssertionError(f"phase 9: the band of block 1 starts at row "
                             f"{v_lo}, not inside the detector")
    dev = torch.device("cuda", 0)
    grid = make_bp_grid(det, vol)
    rng = np.random.default_rng(2027)
    projs = rng.standard_normal((od.CHUNK, det.n_col, det.n_row)).astype(
        np.float32)
    phi = np.deg2rad(np.arange(od.CHUNK, dtype=np.float32) * det.delta_phi
                     + np.float32(0.3)).astype(np.float32)
    s = torch.as_tensor(np.sin(phi), device=dev)
    c = torch.as_tensor(np.cos(phi), device=dev)
    max_err = 0.0
    print(f"K1 at the offset detector's block {shape}, z0={z0}, band rows "
          f"{v_lo}..{v_lo + vp - 1} ({vp} of {det.n_col}); gates: banded == "
          f"unbanded bit for bit, max|banded - plain| <= {GATE_KERNEL:g} * "
          "max|plain|")
    for dtype, mode in ((torch.float32, "exact"), (torch.bfloat16, "fast")):
        p = torch.as_tensor(projs, device=dev).to(dtype).contiguous()
        band = p[:, v_lo:v_lo + vp].contiguous()
        banded = backproject_chunk_cuda(torch.zeros(shape, device=dev), band,
                                        s, c, grid, z0, v_lo=v_lo)
        whole = backproject_chunk_cuda(torch.zeros(shape, device=dev), p, s,
                                       c, grid, z0)
        plain = backproject_chunk_torch(torch.zeros(shape, device=dev), band,
                                        s, c, grid, z0, v_lo=v_lo)
        torch.cuda.synchronize()
        same = bool(torch.equal(banded, whole))
        err = float((banded - plain).abs().max())
        scale = float(plain.abs().max())
        del banded, whole, plain
        max_err = max(max_err, err)
        ok = same and math.isfinite(err) and err <= GATE_KERNEL * scale
        acc = torch.zeros(shape, device=dev)
        ms = _time_ms(lambda: backproject_chunk_cuda(
            acc, band, s, c, grid, z0, v_lo=v_lo), n=5, warmup=1)
        text, bound, bound_by = _k1_profile(logs["backproject"], band, shape,
                                            z0, grid)
        print(f"  {mode:<5} banded == unbanded {same}, max|err| {err:.3e} "
              f"max|plain| {scale:.3e}; kernel {ms:.3f} ms ({bound / ms:.1%} "
              f"of the {bound:.3f} ms bound, {bound_by}); {text}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 at the offset block failed ({mode})")
        del acc, band, p
    return max_err


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_device()
    import torch
    disk = _Disk()
    logs = phase_build()
    from paris_tpu_torch import _build
    disk.add(_file_bytes(os.path.join(_build.BUILD_DIR, "*")))   # compilers'
    disk.phase("phase 1")
    max_abs_err, timings = phase_kernel(logs)
    trip_err, trip_ms = phase_quantize()
    with tempfile.TemporaryDirectory(prefix="paris_smoke_") as workdir:
        launches, _, job = phase_end_to_end(workdir)
        launches = list(launches)
        disk.phase("phase 3")
        micro_launches, micro_err, tile_ms = phase_micro(logs)
        max_abs_err = max(max_abs_err, phase_band(logs))
        launches = [a + b for a, b in zip(launches,
                                          phase_distributed(workdir, job))]
        disk.phase("phases 4-5")
        phase_projector()
        launches = [a + b for a, b in zip(launches, phase_config5(workdir))]
        disk.add(_file_bytes(os.path.join(workdir, "c5", "golden_part_*")))
        max_abs_err = max(max_abs_err, phase_k1_config5(logs))
        disk.phase("phase 6")
        bench_launches, bench_err = phase_benchmarks(workdir, disk)
        launches = [a + b for a, b in zip(launches, bench_launches)]
        max_abs_err = max(max_abs_err, bench_err)
        phase_plan()
        launches = [a + b for a, b in zip(launches,
                                          phase_offset(workdir, disk))]
        max_abs_err = max(max_abs_err, phase_k1_offset(logs))
        disk.add(_file_bytes(os.path.join(workdir, "offset", "*",
                                          "golden_*")))
        disk.phase("phase 9")
    ms, plain_ms, bound, bound_by = timings[("fast", 64)]
    kernels = [{
        "name": "bp_kernel (fast: bf16 projections, f32 arithmetic)",
        "route": "cuda",
        "source": "paris_tpu_torch/csrc/backproject.cu",
        "replaces": "paris_tpu/ops/backprojection_pallas.py:921",
        "launches": launches[0],
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
    ms, plain_ms, bound, bound_by = trip_ms
    kernels.append({
        "name": "u16_round_trip (fast mode's per-frame u16 quantization "
                "and dequantization on the card; PyTorch ops, no hand "
                "kernel: the JAX package ran it on its host; ms per config-5 "
                "chunk, plain_ms the host's native quantizer)",
        "route": "cuda",
        "source": "paris_tpu_torch/pipeline.py",
        "replaces": "paris_tpu/pipeline.py:51",
        "launches": launches[1],
        "max_abs_err": trip_err,
        "ms": ms,
        "plain_ms": plain_ms,
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
