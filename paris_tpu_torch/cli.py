"""Command-line interface of the PyTorch port:
``python -m paris_tpu_torch.cli`` (console script ``paris-tpu-torch``).

Reuses ``paris_tpu.cli.build_parser`` so the flags match the JAX CLI and
the reference's; ``--backend`` takes auto/cuda/torch, and ``--trace-dir``
writes one torch.profiler Chrome trace per z-block.  The multi-device
flags exit with code 2: they are not yet ported.
"""

from __future__ import annotations

import argparse
import faulthandler
import io
import logging
import sys
from typing import List, Optional

from paris_tpu.cli import build_parser as _reference_parser
from paris_tpu.exceptions import ParisError
from paris_tpu.geometry import RegionOfInterest, apply_roi, derive_volume_geometry
from paris_tpu.io.geometry_file import geometry_format_help, load_geometry_file
from paris_tpu.utils.logging import setup_logging

from . import __version__

logger = logging.getLogger("paris_tpu_torch.cli")

BANNER = (f"paris_tpu_torch {__version__} — cone-beam CT (FDK) "
          f"reconstruction in PyTorch with a CUDA backprojection kernel")

# argparse dest -> flag of the options that are not yet ported
_UNPORTED = {
    "distributed": "--distributed",
    "coordinator": "--coordinator",
    "num_processes": "--num-processes",
    "process_id": "--process-id",
}


def build_parser() -> argparse.ArgumentParser:
    p = _reference_parser()
    p.prog = "paris-tpu-torch"
    p.description = BANNER
    for action in p._actions:
        if action.dest == "backend":
            action.choices = ["auto", "cuda", "torch"]
            action.default = "auto"
            action.help = ("backprojection backend: cuda (the hand-written "
                           "kernel), torch (plain PyTorch on the CPU), auto "
                           "(cuda when a card is present)")
        elif action.dest == "accuracy":
            action.help = ("fast (default): u16 staging and bf16 "
                           "projections into the kernel, float32 "
                           "arithmetic; exact: float32 throughout")
        elif action.dest == "hbm_budget_gb":
            action.help = "device-memory budget per z-block (GB)"
        elif action.dest == "block_dz":
            action.help = "force the z-block extent (slices)"
        elif action.dest == "trace_dir":
            action.help = ("write one torch.profiler Chrome-trace JSON per "
                           "z-block's reconstruct stage into this directory")
        elif action.dest in _UNPORTED:
            action.help = "not yet ported to paris_tpu_torch"
        elif action.dest == "version":
            action.version = __version__
    return p


def main(argv: Optional[List[str]] = None) -> int:
    # crash backtraces on SIGSEGV/SIGABRT
    try:
        faulthandler.enable()
    except (io.UnsupportedOperation, AttributeError, ValueError):
        pass  # no real stderr (e.g. under test capture)
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    print(BANNER, file=sys.stderr)

    if args.geometry_format:
        print(geometry_format_help())
        return 0

    for dest, flag in _UNPORTED.items():
        if getattr(args, dest) not in (None, False):
            print(f"error: {flag} is not yet ported to paris_tpu_torch",
                  file=sys.stderr)
            return 2

    if not args.geometry:
        print("error: --geometry is required", file=sys.stderr)
        return 2
    try:
        det = load_geometry_file(args.geometry)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    roi = None
    if args.roi:
        coords = {c: getattr(args, f"roi_{c}") for c in
                  ("x1", "x2", "y1", "y2", "z1", "z2")}
        missing = [f"--roi-{c}" for c, v in coords.items() if v is None]
        if missing:
            print(f"error: the option '{missing[0]}' is required but missing",
                  file=sys.stderr)
            return 2
        roi = RegionOfInterest(**coords)

    # I/O conditional-requirement pair (reference program_options.cpp:117-122)
    if bool(args.input) != bool(args.output):
        which = "--output" if args.input else "--input"
        print(f"error: the option '{which}' is required but missing",
              file=sys.stderr)
        return 2

    vol_geo = derive_volume_geometry(det)
    logger.info("volume [vx]: %d x %d x %d, voxel %.4f mm",
                vol_geo.dim_x, vol_geo.dim_y, vol_geo.dim_z, vol_geo.l_vx_x)
    if roi is not None:
        try:
            roi_geo = apply_roi(vol_geo, roi)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        logger.info("ROI volume [vx]: %d x %d x %d",
                    roi_geo.dim_x, roi_geo.dim_y, roi_geo.dim_z)

    if not args.input:
        # geometry dry-run mode (reference main.cpp:132,179)
        logger.info("no --input/--output given: geometry dry run complete")
        return 0

    from .app import ReconstructionJob, run_job

    job = ReconstructionJob(
        det=det,
        input_path=args.input,
        output_path=args.output,
        prefix=args.name,
        angle_path=args.angles,
        quality=args.quality,
        roi=roi,
        chunk_size=args.chunk_size,
        backend=args.backend,
        accuracy=args.accuracy,
        block_dz=args.block_dz,
        hbm_budget_bytes=(int(args.hbm_budget_gb * (1 << 30))
                          if args.hbm_budget_gb else None),
        resume=args.resume,
        max_blocks=args.max_blocks,
        trace_dir=args.trace_dir,
    )
    try:
        run_job(job)
    except ParisError as e:
        logger.critical("%s: %s", type(e).__name__, e)
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
