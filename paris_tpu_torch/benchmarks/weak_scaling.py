"""Config-5 scaling harness: the cost of the distribution machinery on the
CPU (the counterpart of ``benchmarks/weak_scaling.py``).

    python -m paris_tpu_torch.benchmarks.weak_scaling --backend torch [N ...] [--total-dz D] [--cores K]

It runs on the CPU only, so it asks for ``--backend torch`` and raises
without it (the default, ``cuda``, names the flag).  The distributed path
shards each z-block over the ranks and adds one all-gather of the (banded)
filtered chunk per step.  Ranks that share one host's cores cannot keep
their per-rank rate as the group grows, so classic weak scaling is not
measurable on one host; what is, is the cost of the machinery itself: the
SAME total problem (a 256² detector, a block of ``--total-dz`` slices,
32 x max N by default, C = 8 projections per step through
``DistributedReconstructor.accumulate``) in a gloo group of N ranks, each
a process of its own with ONE thread (OMP_NUM_THREADS=1), for every N
(default 1 2 4 8, at most the host's cores).  With one thread per rank the
ideal time of N ranks is t_1 / N, and ``overhead_vs_unsharded`` is
t_N x N / t_1 - 1.  The JAX driver measured t_N / t_1 - 1 on a virtual CPU
device mesh whose devices shared one process's threads; its keys and its
gate (<= 0.25 overhead at the largest N) are kept, ``platform`` is
``"cpu-gloo"``.  ``pass`` is null when that overhead is negative: N
single-threaded processes then beat N times one (caches, memory bandwidth
per core), and the run cannot see the machinery's cost.  The ranks meet at
a free local port (``spawn_ranks``); each imports only torch and this
package.  The record goes to ``results/weak_scaling.json`` unless
``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from ..geometry import DetectorGeometry, derive_volume_geometry
from ..parallel import multihost
from ..parallel.dist import DistributedReconstructor
from .full_scale_2048_3600 import RESULTS_DIR, record_result

__all__ = ["free_port", "spawn_ranks", "run", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DET_256 = DetectorGeometry(256, 256, 1.0, 1.0, 0.0, 0.0, 2048.0, 1024.0, 0.5)
C = 8                      # every rank backprojects all 8 projections
REPS = 10                  # timed steps per rank, after one warm-up
RANK_TIMEOUT_S = 900.0
MODULE = "paris_tpu_torch.benchmarks.weak_scaling"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, world: int, args: List[str], threads: int
                ) -> dict:
    """Run ``python -m module --coordinator 127.0.0.1:PORT --num-processes
    world --process-id r *args`` for every rank r, each with
    OMP_NUM_THREADS=``threads``, from the repository's root; returns the
    JSON object rank 0 prints last.  Raises, with the rank's stderr, if a
    rank fails or the ranks take more than ``RANK_TIMEOUT_S``; every rank
    is ended before it returns."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    with tempfile.TemporaryDirectory(prefix="paris_ranks_") as logs:
        procs = []
        try:
            for r in range(world):
                out = open(os.path.join(logs, f"{r}.out"), "w")
                err = open(os.path.join(logs, f"{r}.err"), "w")
                with out, err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", module, "--coordinator",
                         f"127.0.0.1:{port}", "--num-processes", str(world),
                         "--process-id", str(r), *args],
                        stdout=out, stderr=err, env=env, cwd=REPO))
            deadline = time.monotonic() + RANK_TIMEOUT_S
            for p in procs:
                p.wait(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(logs, f"{r}.err")) as f:
                    raise RuntimeError(f"{module} rank {r} of {world} exited "
                                       f"{p.returncode}:\n{f.read()}")
        with open(os.path.join(logs, "0.out")) as f:
            return json.loads(f.read().strip().splitlines()[-1])


def _rank(args) -> None:
    """One rank: time ``accumulate`` of C projections into its slab of the
    total block, after one warm-up call; rank 0 prints the result."""
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id, backend="torch")
    try:
        vol = derive_volume_geometry(DET_256)
        rec = DistributedReconstructor(
            DET_256, vol, chunk_size=C, backend="torch",
            block_shape=(args.total_dz, vol.dim_y, vol.dim_x))
        rng = np.random.default_rng(0)
        projs = rng.standard_normal(
            (C, DET_256.n_col, DET_256.n_row)).astype(np.float32)
        angles = np.arange(C, dtype=np.float32) * DET_256.delta_phi
        v = rec.accumulate(rec.init_block(), projs, angles)
        t0 = time.perf_counter()
        for _ in range(REPS):
            v = rec.accumulate(v, projs, angles)
        dt = (time.perf_counter() - t0) / REPS
        if rec.rank == 0:
            updates = vol.dim_x * vol.dim_y * args.total_dz * C
            print(json.dumps({"n": rec.world, "sec_per_step": dt,
                              "gupd_per_s_total": updates / dt / 1e9}),
                  flush=True)
    finally:
        multihost.shutdown()


def run(sizes=(1, 2, 4, 8), total_dz: Optional[int] = None,
        cores: Optional[int] = None, backend: str = "cuda") -> dict:
    if backend != "torch":
        raise ValueError("weak_scaling measures gloo ranks on the CPU: pass "
                         f"--backend torch (got {backend!r})")
    total_dz = total_dz or 32 * max(sizes)
    cores = cores or os.cpu_count() or 1
    if any(total_dz % n for n in sizes):
        raise ValueError(f"total dz {total_dz} must divide by every world "
                         f"size {list(sizes)}")
    if max(sizes) > cores:
        raise ValueError(f"{max(sizes)} single-threaded ranks need as many "
                         f"cores; {cores} given")
    rows = [spawn_ranks(MODULE, n, ["--total-dz", str(total_dz)], threads=1)
            for n in sizes]
    base = rows[0]["sec_per_step"] * rows[0]["n"]
    for r in rows:
        r["ideal_sec_per_step"] = round(base / r["n"], 4)
        r["overhead_vs_unsharded"] = round(
            r["sec_per_step"] * r["n"] / base - 1.0, 3)
        r["gupd_per_s_total"] = round(r["gupd_per_s_total"], 3)
        r["sec_per_step"] = round(r["sec_per_step"], 4)
        r["threads_per_rank"] = 1
    last = rows[-1]["overhead_vs_unsharded"]
    return {
        "config": 5, "name": "distribution_overhead_virtual_mesh",
        "platform": "cpu-gloo", "total_block_dz": total_dz, "cores": cores,
        "note": ("same TOTAL problem at every world size on one host's "
                 "cores (gloo ranks, one process and one thread each); "
                 "against the ideal t_1 / N, overhead_vs_unsharded isolates "
                 "the cost of the z-sharding, the all-gathers and the "
                 "per-rank dispatch. Weak scaling over cards (BASELINE "
                 "config 5) needs more than one card."),
        "gate": "<= 0.25 overhead at max mesh (null: overhead < 0, the "
                "run cannot see the machinery's cost)",
        "pass": None if last < 0 else last <= 0.25,
        "rows": rows,
    }


def main(argv: Optional[list] = None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--total-dz", type=int, default=None)
    ap.add_argument("--cores", type=int, default=None,
                    help="cores the ranks may take, one each (default: all)")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="torch: the only one this CPU harness runs")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "weak_scaling.json"))
    # one rank of a group (spawn_ranks passes these)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.process_id is not None:
        _rank(args)
        return None
    res = run(args.sizes, args.total_dz, args.cores, args.backend)
    print(json.dumps(res, indent=2), flush=True)
    record_result(args.out, res)
    return res


if __name__ == "__main__":
    main()
