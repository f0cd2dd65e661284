"""Command-line interface of the PyTorch port:
``python -m paris_tpu_torch.cli`` (console script ``paris-tpu-torch``).

The parser has the flags, defaults and choices of the JAX CLI
(``paris_tpu/cli.py:build_parser``) and the reference's
(src/program_options.cpp:37-153), apart from ``--backend``, which takes
auto/cuda/torch; ``--trace-dir`` writes one torch.profiler Chrome trace
per z-block.  ``--distributed`` runs the job over a ``torch.distributed``
group, one process per card:

    torchrun --nproc-per-node N -m paris_tpu_torch.cli --distributed ...

or, one process each, ``--distributed --coordinator HOST:PORT
--num-processes N --process-id I``; alone, it is a group of one.
"""

from __future__ import annotations

import argparse
import faulthandler
import io
import logging
import sys
from typing import List, Optional

from . import __version__
from .exceptions import ParisError
from .geometry import RegionOfInterest, apply_roi, derive_volume_geometry
from .io.geometry_file import geometry_format_help, load_geometry_file
from .utils.logging import setup_logging

logger = logging.getLogger("paris_tpu_torch.cli")

BANNER = (f"paris_tpu_torch {__version__} — cone-beam CT (FDK) "
          f"reconstruction in PyTorch with a CUDA backprojection kernel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paris-tpu-torch", description=BANNER, add_help=True)
    p.add_argument("--geometry-format", action="store_true",
                   help="display geometry file format and exit")
    p.add_argument("--geometry", help="path to geometry file")
    p.add_argument("--input", help="path to projections (optional)")
    p.add_argument("--output", help="output directory for the volume (optional)")
    p.add_argument("--name", default="vol",
                   help="name of the reconstructed volume (optional)")
    p.add_argument("--angles", help="path to projection angles (optional)")
    p.add_argument("--quality", type=int, default=1,
                   help="quality setting: keep every q-th projection (optional)")
    p.add_argument("--roi", action="store_true",
                   help="region of interest switch (optional)")
    for c in ("x1", "x2", "y1", "y2", "z1", "z2"):
        p.add_argument(f"--roi-{c}", type=int, default=None,
                       help=f"ROI coordinate {c}")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "torch"],
                   help="backprojection backend: cuda (the hand-written "
                        "kernel), torch (plain PyTorch on the CPU), auto "
                        "(cuda when a card is present)")
    p.add_argument("--chunk-size", type=int, default=16,
                   help="projections accumulated per device pass")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="device-memory budget per z-block (GB)")
    p.add_argument("--block-dz", type=int, default=None,
                   help="force the z-block extent (slices)")
    p.add_argument("--max-blocks", type=int, default=None,
                   help="compute at most N new blocks then exit "
                        "(re-run with --resume to continue; bounds "
                        "per-process resource growth on long jobs)")
    p.add_argument("--accuracy", default="fast", choices=["exact", "fast"],
                   help="fast (default): u16 staging and bf16 projections "
                        "into the kernel, float32 arithmetic; exact: "
                        "float32 throughout")
    p.add_argument("--trace-dir", default=None,
                   help="write one torch.profiler Chrome-trace JSON per "
                        "z-block's reconstruct stage into this directory")
    p.add_argument("--resume", action="store_true",
                   help="resume: skip blocks recorded complete in the manifest")
    p.add_argument("--distributed", action="store_true",
                   help="run over a torch.distributed group, one process "
                        "per card (NCCL; gloo for --backend torch): from "
                        "--coordinator/--num-processes/--process-id, else "
                        "torchrun's environment, else a group of one")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of the torch.distributed group "
                        "(with --distributed; every process passes the "
                        "same address)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count of the distributed run")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id in [0, --num-processes)")
    p.add_argument("--verbose", action="store_true", help="debug logging")
    p.add_argument("--version", action="version", version=__version__)
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

    # identity checks, not truthiness: --process-id 0 is the most common
    # process id and must hit the same validation as id 1
    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None) and not args.distributed:
        print("error: --coordinator/--num-processes/--process-id require "
              "--distributed", file=sys.stderr)
        return 2
    if not args.distributed:
        return _main(args)
    # before the first device query, so every rank binds its own card
    from .parallel import multihost
    try:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, args.backend)
    except (RuntimeError, ValueError) as e:
        print(f"error: distributed initialization failed: {e}",
              file=sys.stderr)
        return 2
    try:
        return _main(args)
    finally:
        multihost.shutdown()


def _main(args: argparse.Namespace) -> int:
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
        if args.distributed:
            from .parallel.app import run_job_distributed
            run_job_distributed(job)
        else:
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
