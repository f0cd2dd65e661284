"""Streaming golden-oracle slabs for the config-5 full-scale gates (the
counterpart of ``benchmarks/golden_slab.py``).

Computes NumPy golden FDK slabs (``golden.golden_fdk_stream``) over a HIS
scan directory without holding the scan in memory (3600 frames of 2048 x
2048 are 30.2 GB as uint16, 60.4 GB as float32): files are read in order
(``read_his`` turns any number type into float32; a file is whole when
its own header's frames are all there), weighted and filtered once, and
every requested z-slab accumulates in one pass.  It tails the
directory while the synthesizer is still writing (``SYNTH_DONE`` tells
"not yet written" from "scan complete").

Sharded for the host's cores: ``--shard w/W`` takes the files with index
% W == w and writes partial slab sums (backprojection is linear in the
projections, so the partials sum exactly); ``--merge W`` adds the
partials and writes ``golden_z{z0}.npy`` per slab.  Every file is written
as a temporary and renamed, so a reader never sees half of one.

    python -m paris_tpu_torch.benchmarks.golden_slab --workdir D --slabs 342:4,858:4 --shard 0/2 &
    python -m paris_tpu_torch.benchmarks.golden_slab --workdir D --slabs 342:4,858:4 --shard 1/2 &
    wait; python -m paris_tpu_torch.benchmarks.golden_slab --workdir D --slabs 342:4,858:4 --merge 2
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geometry import DetectorGeometry, derive_volume_geometry
from ..golden import golden_fdk_stream
from ..io.his import read_his
from .synth_c5_3600 import (BATCH, DONE_MARKER, N_PROJ, PROJ_SUBDIR, config5,
                            his_path, whole_his)

__all__ = ["parse_slabs", "partial_path", "final_path", "golden_partials",
           "merge", "start_shards", "stop_shards", "finish_shards", "main"]

Slabs = Sequence[Tuple[int, int]]


def parse_slabs(s: str) -> List[Tuple[int, int]]:
    """"z0:dz,z0:dz,..." -> [(z0, dz), ...]."""
    out = []
    for part in s.split(","):
        z0, dz = part.split(":")
        out.append((int(z0), int(dz)))
    return out


def partial_path(workdir: str, z0: int, w: int) -> str:
    return os.path.join(workdir, f"golden_part_z{z0}_w{w}.npy")


def final_path(workdir: str, z0: int) -> str:
    return os.path.join(workdir, f"golden_z{z0}.npy")


def _save(path: str, a: np.ndarray) -> None:
    tmp = path[:-4] + f".tmp{os.getpid()}.npy"
    np.save(tmp, a)
    os.replace(tmp, path)


def golden_partials(workdir: str, det: DetectorGeometry, slabs: Slabs,
                    n_proj: int, *, shard: Tuple[int, int] = (0, 1),
                    subdir: str = PROJ_SUBDIR, dtype=np.float32,
                    poll_s: float = 5.0) -> List[str]:
    """Shard ``w`` of ``W`` (``shard``): the golden slabs over the files of
    ``workdir/subdir`` with index % W == w, each saved as
    ``golden_part_z{z0}_w{w}.npy``; returns their paths.  Waits for a file
    the synthesizer has not written yet, and raises if ``SYNTH_DONE``
    appears without it."""
    w, W = shard
    vol = derive_volume_geometry(det)
    pdir = os.path.join(workdir, subdir)
    done_marker = os.path.join(pdir, DONE_MARKER)
    files = [(i, his_path(pdir, i)) for i in range(0, n_proj, BATCH)]
    mine = [(i, p) for k, (i, p) in enumerate(files) if k % W == w]

    def wait_for(path: str, n: int) -> bool:
        # the synthesizer writes tmp + rename, so a file that exists is
        # complete; after SYNTH_DONE, one more look (the rename may have
        # raced the poll)
        while not whole_his(path, n):
            if os.path.exists(done_marker):
                return whole_his(path, n)
            time.sleep(poll_s)
        return True

    def pairs():
        t0 = time.perf_counter()
        for k, (i, path) in enumerate(mine):
            n = min(BATCH, n_proj - i)
            if not wait_for(path, n):
                raise RuntimeError(f"missing projection file {path}")
            frames = read_his(path)
            for j in range(n):
                yield frames[j], (i + j) * det.delta_phi
            if k % 25 == 24:
                done = (k + 1) * BATCH
                print(f"[golden w{w}] {done}/{len(mine) * BATCH} frames "
                      f"({done / (time.perf_counter() - t0):.2f} fr/s)",
                      flush=True)

    t0 = time.perf_counter()
    outs = golden_fdk_stream(pairs(), det, vol, slabs, dtype=np.dtype(dtype))
    paths = []
    for (z0, _dz), out in zip(slabs, outs):
        paths.append(partial_path(workdir, z0, w))
        _save(paths[-1], out)
    print(f"[golden w{w}] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


def merge(workdir: str, slabs: Slabs, shards: int) -> Dict[int, np.ndarray]:
    """Add the ``shards`` partials of each slab; saves and returns
    ``{z0: golden slab}``."""
    out = {}
    for z0, _dz in slabs:
        total = None
        for w in range(shards):
            part = np.load(partial_path(workdir, z0, w))
            total = part if total is None else total + part
        out[z0] = total.astype(np.float32)
        _save(final_path(workdir, z0), out[z0])
    return out


def start_shards(workdir: str, det: DetectorGeometry, slabs: Slabs,
                 n_proj: int, shards: int, *, subdir: str = PROJ_SUBDIR
                 ) -> list:
    """Start ``golden_partials`` for every shard of ``shards``, one process
    each (spawned: the caller may hold threads and a card)."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for w in range(shards):
        p = ctx.Process(target=golden_partials,
                        args=(workdir, det, list(slabs), n_proj),
                        kwargs=dict(shard=(w, shards), subdir=subdir),
                        name=f"golden-w{w}")
        p.start()
        procs.append(p)
    return procs


def stop_shards(procs: list) -> None:
    """End the processes of ``start_shards`` (the caller failed)."""
    for p in procs:
        p.terminate()
        p.join()


def finish_shards(procs: list, workdir: str, slabs: Slabs,
                  timeout_s: Optional[float] = None) -> Dict[int, np.ndarray]:
    """Wait for the processes of ``start_shards``, raise if one failed,
    and merge their partials."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                raise RuntimeError(f"{p.name} did not finish in "
                                   f"{timeout_s} s")
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    return merge(workdir, slabs, len(procs))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--proj-subdir", default=PROJ_SUBDIR)
    ap.add_argument("--slabs", required=True, help="z0:dz,z0:dz,...")
    ap.add_argument("--n-proj", type=int, default=N_PROJ)
    ap.add_argument("--shard", default=None, help="w/W")
    ap.add_argument("--merge", type=int, default=None,
                    help="merge W partial shards and exit")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    args = ap.parse_args(argv)
    slabs = parse_slabs(args.slabs)
    if args.merge is not None:
        for z0 in merge(args.workdir, slabs, args.merge):
            print(f"[golden] merged slab z0={z0} -> "
                  f"{final_path(args.workdir, z0)}")
        return
    shard = (0, 1) if args.shard is None else tuple(
        int(x) for x in args.shard.split("/"))
    golden_partials(args.workdir, config5(args.n_proj), slabs, args.n_proj,
                    shard=shard, subdir=args.proj_subdir,
                    dtype=np.dtype(args.dtype))


if __name__ == "__main__":
    main()
