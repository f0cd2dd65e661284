"""The output drain on the card against its floor, at one block.

    python -m paris_tpu_torch.benchmarks.drain_compare --shape DZ NY NX \\
        [--turns 2] [--workdir DIR] [--out FILE]

A (DZ, NY, NX) float32 accumulator of seeded values on the card is
written into a new ddbvf (at slice 0) for every measurement, and the file
is deleted after it, so every write lands in new file pages as a job's
does.  In turns (the floor first in even turns, the drain first in odd
ones: F D D F):

  floor    the block copied into pinned host memory ("d2h_pinned"), then
           ``ddbvf.write_slices`` of it ("pwrite_pinned"): the pwrite
           alone from pinned memory, the time a drain is held to;
  drain    ``BlockDrain.drain`` after an event on the compute stream, as
           the job calls it, host seconds to its return, with its split
           (write, wait; the card's d2h seconds come only from a profiled
           drain's "d2h" spans) and its ring's pinned bytes;
           the drain is made once, so the first turn pays the ring.

Host clocks around work that ends in ``torch.cuda.synchronize()``.
Writes one JSON record with the card's name and power limit to
``--out``.  Every turn writes the block twice: at a (1024, 1024, 1024)
block and ``--turns 2``, 16 GiB.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Optional

import torch

from ..io import ddbvf
from ..io.drain import BlockDrain
from ..utils.logging import StageTimers
from .full_scale_2048_3600 import card_record, record_result

__all__ = ["floor", "drain_split", "run", "main"]


def _new_file(workdir: str, volume: torch.Tensor) -> str:
    dz, ny, nx = volume.shape
    fd, path = tempfile.mkstemp(suffix=".ddbvf", dir=workdir)
    os.close(fd)
    return ddbvf.create(path, nx, ny, dz)


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def floor(volume: torch.Tensor, workdir: str, pinned: torch.Tensor) -> dict:
    """The block's pwrite from pinned memory, after its pinned copy."""
    out = {"d2h_pinned": _timed(lambda: pinned.copy_(volume,
                                                     non_blocking=True))}
    path = _new_file(workdir, volume)
    try:
        out["pwrite_pinned"] = _timed(lambda: ddbvf.write_slices(
            path, pinned.numpy(), 0))
    finally:
        os.remove(path)
    return out


def drain_split(drain: BlockDrain, volume: torch.Tensor,
                workdir: str) -> dict:
    """``drain`` of ``volume`` as the job runs it, timed, with its split."""
    path = _new_file(workdir, volume)
    split = StageTimers()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ready = torch.cuda.Event()
        ready.record()
        drain.drain(volume, path, 0, volume.shape[0], ready=ready,
                    split=split)
        total = time.perf_counter() - t0
    finally:
        os.remove(path)
    return {"total": total, "write": split.totals.get("write", 0.0),
            "wait": split.totals.get("copy_wait", 0.0),
            "slabs": split.counts.get("write", 0),
            "pinned_bytes": drain.pinned_bytes}


def _summary(turns, key):
    values = [t[key] for t in turns]
    return {"min": min(values), "median": statistics.median(values),
            "max": max(values)}


def run(shape, turns: int = 2, workdir: str = ".", seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("drain_compare measures the card: no CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    dz, ny, nx = (int(n) for n in shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    volume = torch.randn((dz, ny, nx), generator=gen, device=device)
    pinned = torch.empty((dz, ny, nx), dtype=torch.float32, pin_memory=True)
    drain = BlockDrain(device, (ny, nx), dz)
    res = {"name": f"drain_compare_{dz}x{ny}x{nx}", "shape": [dz, ny, nx],
           "block_bytes": 4 * dz * ny * nx, **card_record(device),
           "torch": torch.__version__, "slab_slices": drain.slices,
           "floor": [], "drain": [], "order": []}
    for t in range(turns):
        for side in (("floor", "drain") if t % 2 == 0
                     else ("drain", "floor")):
            res[side].append(floor(volume, workdir, pinned)
                             if side == "floor"
                             else drain_split(drain, volume, workdir))
            res["order"].append(side)
            print(f"[drain_compare] {side}: {json.dumps(res[side][-1])}",
                  flush=True)
    res["floor_summary"] = {k: _summary(res["floor"], k)
                            for k in ("d2h_pinned", "pwrite_pinned")}
    res["drain_summary"] = {k: _summary(res["drain"], k)
                            for k in ("total", "write", "wait")}
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, required=True,
                    metavar=("DZ", "NY", "NX"))
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.workdir) as work:
        res = run(args.shape, args.turns, work)
    print(json.dumps(res), flush=True)
    if args.out:
        record_result(args.out, res)
    return res


if __name__ == "__main__":
    main()
