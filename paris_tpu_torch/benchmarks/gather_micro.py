"""Gather micro-benchmark K3a on the card (port of
``benchmarks/gather_micro.py``).

    python -m paris_tpu_torch.benchmarks.gather_micro      # needs a card

Times the idioms with which a backprojection kernel can sample a
projection row, each in isolation inside a hand-written CUDA kernel
(``csrc/gather_micro.cu``).  For r in 0..63, with c = r % 8 and
x = idx ^ r, each mode adds to a (64, 128) int32 accumulator, per element
[i, j]:

  empty     x                                  (the loop's own cost)
  lane      tab[c, i, x & 127]                 a gather along a row
  lane2     tab[c, 64 + i, w] if bit 7 of x is set, else tab[c, i, w],
            w = x & 127                        (two gathers and a select)
  sublane   tab[c, x % S, j]                   a gather across S rows
  select    the value of sublane, reached by an S-step ladder of
            where(x % S == s, tab[c, s, j], g)   (no gather)

``main`` prints ns per (64, 128) gather with the empty baseline
subtracted, under the JSON keys of ``benchmarks/gather_micro.py``.

The kernel reads its tables from shared memory, as the TPU kernel reads
them from VMEM: a thread block owns a band of rows of one tile and first
stages the table rows that band reads (``plan_band``, ``staged_rows``).
"""

from __future__ import annotations

import json
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build

__all__ = ["REPS", "C", "BLOCKS", "MODES", "CASES", "BandPlan", "inputs",
           "seeded_inputs", "plan_band", "staged_rows", "compiled_limits",
           "blocks_per_sm", "gather_micro_torch", "gather_micro_cuda", "run",
           "main"]

REPS = 64          # gathers per element of a tile
C = 8              # tables; rep r reads table r % C
BLOCKS = 256       # tiles per launch: the Pallas grid's steps
TIMED = 20         # timed launches per mode, after one warm-up
SPIN_CYCLES = 1 << 23   # ~4 ms of the card's clock, ahead of the timed calls
MODES = ("empty", "lane", "lane2", "sublane", "select")   # csrc order
WINDOWS = {"sublane": (8, 16, 32), "select": (8, 16, 24, 32)}
# (mode, S) that main() reports after the empty baseline
CASES = (("lane", 128), ("lane2", 128), ("sublane", 8), ("sublane", 16),
         ("sublane", 32), ("select", 8), ("select", 16), ("select", 24),
         ("select", 32))

ROWS, COLS = 64, 128           # the tile
ROW_BYTES = COLS * 4
SMEM_BLOCK_MAX = 232_448       # dynamic shared memory of one block (H100)
MAX_THREADS = 1024             # of a block
# threads of the largest block of a mode, as compiled: select's ladder
# needs more registers than a thread of a 1024-thread block can have
MODE_MAX_THREADS = {"select": 512}
# elements of one thread (rows of one column), as compiled into the
# kernels; select shares each row read among them
PER = {"empty": 4, "lane": 4, "lane2": 4, "sublane": 4, "select": 8}
# a row band's tables take at most this, so six blocks share an SM
BAND_SMEM_TARGET = 32 << 10


class BandPlan(NamedTuple):
    """How a launch cuts a tile: thread blocks of ``rows`` rows and
    ``threads`` threads with ``smem`` bytes of dynamic shared memory."""
    rows: int
    threads: int
    smem: int


def band_plan(rows: int, per: int, smem: int, what: str,
              max_threads: int = MAX_THREADS) -> BandPlan:
    """The plan of ``rows``-row blocks whose threads own ``per`` rows;
    raises ValueError if no kernel can run it."""
    threads = rows // per * COLS
    if (rows < per or ROWS % rows or rows % per or threads > max_threads
            or smem > SMEM_BLOCK_MAX):
        raise ValueError(f"{what}: no block of {rows} rows ({threads} "
                         f"threads, {smem} B of shared memory)")
    return BandPlan(rows, threads, smem)


def staged_rows(mode: str, S: int, i0: int, rows: int) -> List[range]:
    """The rows of each (128, 128) table that the block of tile rows
    [i0, i0 + rows) stages into shared memory."""
    if mode == "lane":
        return [range(i0, i0 + rows)]
    if mode == "lane2":
        return [range(i0, i0 + rows), range(64 + i0, 64 + i0 + rows)]
    if mode in WINDOWS:
        return [range(S)]
    return []


def plan_band(mode: str, S: int = 32, rows: Optional[int] = None) -> BandPlan:
    """The kernel's band plan for (mode, S).  lane and lane2 stage only
    their band's rows of the 8 tables: the largest band up to 8 rows
    whose tables fit ``BAND_SMEM_TARGET``.  sublane and select stage S
    rows of every table whatever the band, so the band is at least S rows
    (8 at least): staging then moves at most an eighth of the words the
    block gathers.  ``rows`` forces another band."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    if mode in WINDOWS and S not in WINDOWS[mode]:
        raise ValueError(f"{mode} takes S in {WINDOWS[mode]}, got {S}")

    def smem(r: int) -> int:
        return C * ROW_BYTES * sum(len(x) for x in staged_rows(mode, S, 0, r))

    if rows is None:
        if mode in WINDOWS:
            rows = next(r for r in (8, 16, 32, 64) if r >= S)
        else:
            rows = 8
            while smem(rows) > BAND_SMEM_TARGET and rows > PER[mode]:
                rows //= 2
    return band_plan(rows, PER[mode], smem(rows), f"{mode}, S={S}",
                     MODE_MAX_THREADS.get(mode, MAX_THREADS))


def inputs(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The benchmark's (tab, idx): tab = arange as (C, 128, 128), idx
    (64, 128) drawn in [0, 255) from numpy's generator seeded 0; int32."""
    tab = torch.arange(C * 128 * 128, dtype=torch.int32,
                       device=device).reshape(C, 128, 128)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (64, 128)).astype(np.int32)).to(device)
    return tab, idx


def seeded_inputs(seed: int, device=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """A further (tab, idx) from numpy's generator: table values in
    [-2^20, 2^20) and idx in [-2^30, 2^30), so negative and large."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(-2**20, 2**20, (C, 128, 128)).astype(np.int32)
    idx = rng.integers(-2**30, 2**30, (64, 128)).astype(np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(idx).to(device))


def check_int32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape} int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def check_on_card(tensors: dict) -> torch.device:
    """The one CUDA device all ``tensors`` (name -> tensor) lie on, each
    contiguous; raises ValueError otherwise."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the gather kernels need CUDA tensors, got "
                         f"{next(iter(tensors))} on {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _check(mode: str, S: int, tab: torch.Tensor, idx: torch.Tensor) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    if mode in WINDOWS and S not in WINDOWS[mode]:
        raise ValueError(f"{mode} takes S in {WINDOWS[mode]}, got {S}")
    check_int32("tab", tab, (C, 128, 128))
    check_int32("idx", idx, (64, 128))


def gather_micro_torch(mode: str, S: int, tab: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """The plain version: the (64, 128) int32 tile of ``mode`` (on the
    device of the inputs)."""
    _check(mode, S, tab, idx)
    acc = torch.zeros_like(idx)
    for r in range(REPS):
        t = tab[r % C]
        x = idx ^ r
        if mode == "empty":
            acc += x
        elif mode == "lane":
            acc += torch.gather(t[:64], 1, (x & 127).long())
        elif mode == "lane2":
            w = (x & 127).long()
            acc += torch.where(((x & 255) >> 7) == 1,
                               torch.gather(t[64:], 1, w),
                               torch.gather(t[:64], 1, w))
        elif mode == "sublane":
            acc += torch.gather(t[:S], 0, torch.remainder(x, S).long())
        else:
            m = torch.remainder(x, S)
            g = torch.zeros_like(idx)
            for s in range(S):
                g = torch.where(m == s, t[s], g)
            acc += g
    return acc


def compiled_limits() -> dict:
    """What the built library was compiled with: per mode the elements of
    a thread and the threads of the largest block, and per case of
    ``CASES`` (and empty) the bytes of shared memory a block of the
    planner's rows needs."""
    lib = _build.load_library("gather_micro")
    return {
        "per": {m: lib.paris_gm1_per(MODES.index(m)) for m in MODES},
        "max_threads": {m: lib.paris_gm1_max_threads(MODES.index(m))
                        for m in MODES},
        "smem": {(m, S): lib.paris_gm1_smem(MODES.index(m), S,
                                            plan_band(m, S).rows)
                 for m, S in (("empty", 32),) + CASES},
    }


def blocks_per_sm(mode: str, S: int, plan: BandPlan,
                  device: Optional[torch.device] = None) -> int:
    """Resident blocks per SM of the (mode, S) kernel at ``plan``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    dev = device if device is not None else card()
    lib = _build.load_library("gather_micro")
    n = lib.paris_gm1_blocks_per_sm(dev.index or 0, MODES.index(mode), S,
                                    plan.rows, plan.smem)
    if n < 0:
        raise RuntimeError(f"occupancy query of ({mode}, S={S}) at {plan} "
                           f"failed: CUDA error {-n} "
                           f"({lib.paris_gm_error_string(-n).decode()})")
    return n


def gather_micro_cuda(mode: str, S: int, tab: torch.Tensor,
                      idx: torch.Tensor, blocks: int = BLOCKS,
                      plan: Optional[BandPlan] = None) -> torch.Tensor:
    """The kernel: ``blocks`` copies of the tile of ``mode`` as a
    (blocks, 64, 128) int32 tensor, each computed by 64 / rows thread
    blocks of ``plan`` (``plan_band(mode, S)`` unless given).  Launches
    on the current stream and adds one to ``gather_micro_cuda.launches``;
    a launch the card refuses raises."""
    _check(mode, S, tab, idx)
    dev = check_on_card({"tab": tab, "idx": idx})
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    if plan is None:
        plan = plan_band(mode, S)
    out = torch.empty((blocks, 64, 128), dtype=torch.int32, device=dev)
    lib = _build.load_library("gather_micro")
    rc = lib.paris_gm1_launch(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        MODES.index(mode), S, tab.data_ptr(), idx.data_ptr(),
        out.data_ptr(), blocks, plan.rows, plan.smem)
    if rc != 0:
        raise RuntimeError(f"gather_micro kernel ({mode}, S={S}) launch "
                           f"at {plan} failed: CUDA error {rc} "
                           f"({lib.paris_gm_error_string(rc).decode()})")
    gather_micro_cuda.launches += 1
    return out


gather_micro_cuda.launches = 0


def card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the gather micro-benchmarks time CUDA kernels "
                           "and need a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def time_launches(launch: Callable[[], object], n: int = TIMED) -> float:
    """ms per call of ``launch``: one warm-up, then ``n`` calls between
    two CUDA events.  A spin on the card ahead of the first event keeps
    it busy while the host enqueues the calls, so that kernels shorter
    than a launch from Python (~50 us) run back to back and the events
    time the card, not the host."""
    launch()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def run(mode: str, S: int = 32) -> float:
    """ns per (64, 128) gather of ``mode`` on the card: a launch of
    BLOCKS tiles of REPS gathers each, timed over TIMED launches."""
    tab, idx = inputs(card())
    ms = time_launches(lambda: gather_micro_cuda(mode, S, tab, idx))
    return ms * 1e6 / (BLOCKS * REPS)


def main() -> dict:
    base = run("empty")
    out = {"empty_ns": round(base, 2)}
    for mode, S in CASES:
        out[f"{mode}_{S}_ns"] = round(run(mode, S) - base, 2)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
