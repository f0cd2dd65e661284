"""K3a and K3b on the card: the shared-memory floor of every mode, and the
kernels against other builds of ``csrc/gather_micro.cu``.

    python -m paris_tpu_torch.benchmarks.k3_compare \\
        [--source LABEL=OTHER.cu[:old]]... [--sweep-rows] [--out FILE.json]

Times, beside each other and in alternating order, this revision's
kernels (``shipped``) and those of every ``--source``: another
``gather_micro.cu`` with the same C interface, or with ``:old`` the
interface of the revisions before the row-band plan (one 1024-thread block
per tile, tables read from global memory; no rows and bytes in the launch).
Every kernel of every build is first held against the plain version at the
benchmark's inputs and at a seeded input, in all 256 tiles (int32
equality).  ``--sweep-rows`` also times the shipped kernels at every band
their launchers take, which is how the planners' bands were chosen.

Per (mode, S) it prints ms per launch of 256 tiles and ns per (64, 128)
gather of each build (the empty loop not subtracted), beside the
shared-memory floor of the mode, and writes the rows as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from .. import _build
from . import gather_micro as gm
from . import gather_micro2 as gm2

__all__ = ["SMS", "SMEM_WORDS_PER_CLOCK", "sm_clock_mhz", "smem_words",
           "smem_floor_ns", "ptxas_report", "main"]

SMS = 132                     # streaming multiprocessors of an H100 SXM
SMEM_WORDS_PER_CLOCK = 32     # 32-bit words an SM's shared memory moves
INT32_LANES_PER_CLOCK = 64    # int32 operations an SM does a clock


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0])


def smem_words(kid: str, mode: str, S: int) -> Tuple[float, float]:
    """32-bit words per element and rep that the kernel of (mode, S) moves
    through shared memory: (loaded by the gathers, stored by the copies
    that stage them).  K3a stages once per block, an eighth of its loads
    at most, counted as what the planner's band gives; K3b stages every
    rep's window bands."""
    if mode == "empty" or mode == "chain_only":
        return 0.0, 0.0
    if kid == "K3b":
        return 1.0, float(gm2.WINDOWS[mode])
    plan = gm.plan_band(mode, S)
    staged = plan.smem / 4 / (plan.rows * gm.COLS * gm.REPS)
    loads = S / gm.PER["select"] if mode == "select" else 1.0
    return loads, staged


def smem_floor_ns(kid: str, mode: str, S: int, clock_mhz: float
                  ) -> Tuple[float, str]:
    """(least ns per (64, 128) gather, what sets it) of (mode, S) on an
    H100 with its tables in shared memory: the words of ``smem_words``
    over 32 words a clock an SM, free of bank conflicts, on 132 SMs; for
    select the larger of that and its S compare-and-select pairs per
    element over 64 int32 lanes a clock an SM."""
    per_ns = SMS * clock_mhz * 1e-3           # SM clocks per ns, all SMs
    elements = gm.ROWS * gm.COLS
    words = sum(smem_words(kid, mode, S))
    t_smem = elements * words / (SMEM_WORDS_PER_CLOCK * per_ns)
    if mode == "select":
        t_ops = elements * 2 * S / (INT32_LANES_PER_CLOCK * per_ns)
        if t_ops > t_smem:
            return t_ops, "compares"
    return t_smem, "shared memory"


def ptxas_report(log: str) -> Dict[Tuple[str, int, int], Tuple[int, int]]:
    """(kernel id, mode number, S) -> (registers, bytes spilled) of every
    gather kernel in ptxas's -v report (S is 0 for K3b and 1 for the K3a
    modes without a window)."""
    out, entry, spill = {}, None, 0
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
        if m and entry:
            k = re.search(r"gm1_kernelILi(\d+)ELi(\d+)E", entry)
            if k:
                out[("K3a", int(k.group(1)), int(k.group(2)))] = (
                    int(m.group(1)), spill)
            k = re.search(r"gm2_kernelILi(\d+)E", entry)
            if k:
                out[("K3b", int(k.group(1)), 0)] = (int(m.group(1)), spill)
            entry = None
    return out


_p, _i = ctypes.c_void_p, ctypes.c_int


class _Build:
    """One build of a gather_micro.cu: ``launch(kid, mode, S, tensors,
    plan)`` returns the (256, 64, 128) output."""

    def __init__(self, label: str, lib, old: bool = False):
        self.label, self.lib, self.old = label, lib, old

    def launch(self, kid, mode, S, tensors, plan):
        dev = tensors[0].device
        out = torch.empty((gm.BLOCKS, 64, 128), dtype=torch.int32, device=dev)
        head = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
        ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr(), gm.BLOCKS]
        tail = [] if self.old else [plan.rows, plan.smem]
        if kid == "K3a":
            rc = self.lib.paris_gm1_launch(*head, gm.MODES.index(mode), S,
                                           *ptrs, *tail)
        else:
            rc = self.lib.paris_gm2_launch(*head, gm2.MODES.index(mode),
                                           *ptrs, *tail)
        if rc != 0:
            raise RuntimeError(f"{self.label}: {kid} {mode} S={S} launch at "
                               f"{plan} failed, CUDA error {rc}")
        return out


def _start_build(label: str, source: str):
    out_dir = os.path.join(_build.BUILD_DIR, "k3_compare")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"lib{label}.so")
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", path, source],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, path


def _finish_build(label: str, proc, path: str, old: bool) -> _Build:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{out}{err}")
    lib = ctypes.CDLL(path)
    tail = [] if old else [_i, _i]
    lib.paris_gm1_launch.argtypes = [_i, _p, _i, _i, _p, _p, _p, _i] + tail
    lib.paris_gm2_launch.argtypes = [_i, _p, _i, _p, _p, _p, _p, _i] + tail
    lib.paris_gm1_launch.restype = lib.paris_gm2_launch.restype = _i
    build = _Build(label, lib, old)
    build.log = out + err
    return build


def _cases() -> List[Tuple[str, str, int]]:
    return ([("K3a", m, S) for m, S in (("empty", 32),) + gm.CASES]
            + [("K3b", m, 0) for m in gm2.MODES])


def _bands(kid: str, mode: str, S: int) -> List[gm.BandPlan]:
    """Every band the shipped launcher takes for the case."""
    plans = []
    for rows in (4, 8, 16, 32, 64):
        try:
            plans.append(gm.plan_band(mode, S, rows=rows) if kid == "K3a"
                         else gm2.plan_ring(mode, rows=rows))
        except ValueError:
            pass
    return plans


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="LABEL=PATH[:old]",
                    help="another gather_micro.cu to build and time")
    ap.add_argument("--sweep-rows", action="store_true",
                    help="time the shipped kernels at every band")
    ap.add_argument("--rounds", type=int, default=5,
                    help="alternating timing rounds per case")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    dev = gm.card()
    started = []
    for spec in args.source:
        label, _, path = spec.partition("=")
        old = path.endswith(":old")
        started.append((label, *_start_build(label, path.removesuffix(":old")),
                        old))
    shipped = _Build("shipped", _build.load_library("gather_micro"))
    shipped.log = _build.build(["gather_micro"])["gather_micro"][2]
    builds = [shipped] + [_finish_build(*s) for s in started]
    regs = {b.label: ptxas_report(b.log) for b in builds}
    clock = sm_clock_mhz()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}, max SM clock {clock:.0f} MHz; builds: "
          + ", ".join(b.label for b in builds))

    data = {"K3a": [gm.inputs(dev), gm.seeded_inputs(1, dev)],
            "K3b": [gm2.inputs(dev), gm2.seeded_inputs(1, dev)]}
    rows = []
    for kid, mode, S in _cases():
        plan = gm.plan_band(mode, S) if kid == "K3a" else gm2.plan_ring(mode)
        for tensors in data[kid]:
            plain = (gm.gather_micro_torch(mode, S, *tensors) if kid == "K3a"
                     else gm2.gather_micro2_torch(mode, *tensors))
            for b in builds:
                got = b.launch(kid, mode, S, tensors, plan)
                torch.cuda.synchronize()
                if not torch.equal(got, plain.expand_as(got)):
                    raise AssertionError(f"{b.label}: {kid} {mode} S={S} "
                                         "differs from the plain version")
        tensors = data[kid][0]
        runs: List[Tuple[str, _Build, Optional[gm.BandPlan]]] = [
            (b.label, b, plan) for b in builds]
        if args.sweep_rows:
            runs += [(f"shipped rows={p.rows}", shipped, p)
                     for p in _bands(kid, mode, S) if p != plan]
        times: Dict[str, List[float]] = {name: [] for name, _, _ in runs}
        for r in range(args.rounds):
            for name, b, p in (runs if r % 2 == 0 else runs[::-1]):
                times[name].append(gm.time_launches(
                    lambda: b.launch(kid, mode, S, tensors, p)))
        floor, floor_by = smem_floor_ns(kid, mode, S, clock)
        key = (kid, (gm.MODES if kid == "K3a" else gm2.MODES).index(mode),
               (S if mode in gm.WINDOWS else 1) if kid == "K3a" else 0)
        print(f"{kid} {mode} S={S}: plan {tuple(plan)}; shared-memory floor "
              f"{floor:.3f} ns per gather ({floor_by})")
        for name, b, p in runs:
            ms = statistics.median(times[name])
            r_s = regs[b.label].get(key, (None, 0))
            ns = ms * 1e6 / (gm.BLOCKS * gm.REPS)
            rows.append(dict(kernel=kid, mode=mode, S=S, build=name,
                             rows=None if b.old else p.rows,
                             smem=None if b.old else p.smem,
                             ms_per_launch=ms, ms_all=times[name],
                             ns_per_gather=ns, registers=r_s[0],
                             spill_bytes=r_s[1], floor_ns=floor,
                             floor_by=floor_by, sm_clock_mhz=clock,
                             card=smi))
            print(f"  {name:<16} {ms * 1e3:9.2f} us per launch  {ns:8.3f} ns "
                  f"per gather  regs {r_s[0]} (spill {r_s[1]} B)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return {"rows": rows}


if __name__ == "__main__":
    main()
