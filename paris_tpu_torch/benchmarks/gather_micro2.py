"""Gather micro-benchmark K3b on the card (port of
``benchmarks/gather_micro2.py``): does a gather cost more when its
window is picked by a scalar read at run time?

    python -m paris_tpu_torch.benchmarks.gather_micro2     # needs a card

The table holds K = 16 windows of (64, 128) per c; k0 holds one window
index per rep.  For r in 0..63, with c = r % 8, x = idx ^ r and
w = x & 127, each mode adds to a (64, 128) int32 accumulator, per element
[i, j]:

  empty         x
  static_read   tab[c, r % K, i, j] + x          (a window known statically)
  dyn_read      tab[c, k0[r], i, j] + x          (a window read at run time)
  static_take   tab[c, r % K, i, w]
  dyn_take      tab[c, k0[r], i, w]
  dyn_take2     the takes at k0[r] and k0[r] + 2, picked by bit 7 of x
  chain_take2   the same at kk and kk + 2, with w and the pick taken from
                relv = x - 64 kk, where kk comes from k0 through the f32
                scalar chain of ``chain_window``
  chain_only    x + kk

Window indices are clamped into [0, K - 1], as XLA clamps a dynamic
slice.  ``main`` prints ns per (64, 128) gather of each mode (the empty
loop not subtracted) under the JSON keys of ``benchmarks/gather_micro2.py``.

The kernel gathers from shared memory: a thread block owns a band of rows
of one tile, computes every rep's windows from k0 first (``rep_windows``),
and copies their bands through a ring of ``RING`` stages (``plan_ring``).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .gather_micro import (BLOCKS, C, REPS, ROW_BYTES, BandPlan, band_plan,
                           card, check_int32, check_on_card, time_launches)

__all__ = ["REPS", "C", "K", "BLOCKS", "MODES", "RING", "inputs",
           "seeded_inputs", "chain_window", "rep_windows", "plan_ring",
           "compiled_limits", "blocks_per_sm", "gather_micro2_torch",
           "gather_micro2_cuda", "run", "main"]

K = 16             # windows per table
MODES = ("empty", "static_read", "dyn_read", "static_take", "dyn_take",
         "dyn_take2", "chain_take2", "chain_only")          # csrc order
RING = 4           # stages of the kernel's window ring, as compiled
PER = 4            # elements of one thread, as compiled
RING_ROWS = 4      # rows of a block's band: the fastest of 4..32 on an H100
# window bands a rep gathers from
WINDOWS = {"empty": 0, "static_read": 1, "dyn_read": 1, "static_take": 1,
           "dyn_take": 1, "dyn_take2": 2, "chain_take2": 2, "chain_only": 0}


def inputs(device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The benchmark's (k0, tab, idx): k0 (64,) drawn in [0, K - 2) from
    numpy's generator seeded 1, tab = arange as (C, K, 64, 128), idx as in
    gather_micro; int32."""
    k0 = torch.from_numpy(np.random.default_rng(1).integers(
        0, K - 2, (REPS,)).astype(np.int32)).to(device)
    tab = torch.arange(C * K * 64 * 128, dtype=torch.int32,
                       device=device).reshape(C, K, 64, 128)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (64, 128)).astype(np.int32)).to(device)
    return k0, tab, idx


def seeded_inputs(seed: int, device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """A further (k0, tab, idx) from numpy's generator: k0 in
    [-8, K + 8), so also outside the table; table values in
    [-2^20, 2^20) and idx in [-2^30, 2^30), so that no x - 64 kk leaves
    int32."""
    rng = np.random.default_rng(seed)
    k0 = rng.integers(-8, K + 8, (REPS,)).astype(np.int32)
    tab = rng.integers(-2**20, 2**20, (C, K, 64, 128)).astype(np.int32)
    idx = rng.integers(-2**30, 2**30, (64, 128)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (k0, tab, idx))


def chain_window(k0: torch.Tensor) -> torch.Tensor:
    """kk per rep, in f32 as ``benchmarks/gather_micro2.py:54-60``: a =
    min(s0 1.01, s0 1.02, s1 1.01, s1 1.02) with s0 = k0[r],
    s1 = k0[(r + 1) % REPS]; b = (a - 3) 0.25 - 0.5;
    kk = clip(((floor(b) - 1) >> 6) + k0[r], 0, K - 3)."""
    s0 = k0.float()
    s1 = torch.roll(k0, -1).float()
    a = torch.minimum(torch.minimum(s0 * 1.01, s0 * 1.02),
                      torch.minimum(s1 * 1.01, s1 * 1.02))
    b = (a - 3.0) * 0.25 - 0.5
    kr = (torch.floor(b).to(torch.int32) - 1) >> 6
    return torch.clamp(kr + k0, 0, K - 3)


def rep_windows(mode: str, k0: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The windows (one (64,) tensor each) whose bands the kernel copies
    for every rep of ``mode``: none, one or two."""
    reps = torch.arange(REPS, device=k0.device)
    if WINDOWS[mode] == 0:
        return ()
    if mode.startswith("static"):
        return (reps % K,)
    if mode == "chain_take2":
        kk = chain_window(k0)
        return (kk, kk + 2)
    wins = (k0.clamp(0, K - 1), (k0 + 2).clamp(0, K - 1))
    return wins[:WINDOWS[mode]]


def plan_ring(mode: str, rows: int = RING_ROWS) -> BandPlan:
    """The kernel's band plan for ``mode``: blocks of ``rows`` rows, and
    ``RING`` stages of the rows' bands of a rep's windows."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    return band_plan(rows, PER, RING * WINDOWS[mode] * rows * ROW_BYTES, mode)


def _check(mode: str, k0: torch.Tensor, tab: torch.Tensor,
           idx: torch.Tensor) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    check_int32("k0", k0, (REPS,))
    check_int32("tab", tab, (C, K, 64, 128))
    check_int32("idx", idx, (64, 128))


def gather_micro2_torch(mode: str, k0: torch.Tensor, tab: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """The plain version: the (64, 128) int32 tile of ``mode`` (on the
    device of the inputs)."""
    _check(mode, k0, tab, idx)
    reps = torch.arange(REPS, device=idx.device)
    if mode.startswith("chain"):
        kk = chain_window(k0)
        kw, kw2 = kk, kk + 2
    elif mode.startswith("static"):
        kw = kw2 = reps % K
    else:
        kw, kw2 = k0.clamp(0, K - 1), (k0 + 2).clamp(0, K - 1)
    if mode not in ("empty", "chain_only"):
        # the windows of every rep: (REPS, 64, 128) each
        win0 = tab[reps % C, kw.long()]
        win1 = (tab[reps % C, kw2.long()]
                if mode in ("dyn_take2", "chain_take2") else None)
    acc = torch.zeros_like(idx)
    for r in range(REPS):
        x = idx ^ r
        w = (x & 127).long()
        if mode == "empty":
            acc += x
        elif mode in ("static_read", "dyn_read"):
            acc += win0[r] + x
        elif mode in ("static_take", "dyn_take"):
            acc += torch.gather(win0[r], 1, w)
        elif mode == "dyn_take2":
            acc += torch.where(((x & 255) >> 7) == 1,
                               torch.gather(win1[r], 1, w),
                               torch.gather(win0[r], 1, w))
        elif mode == "chain_only":
            acc += x + kk[r]
        else:
            relv = x - 64 * kk[r]
            w2 = (relv & 127).long()
            acc += torch.where((relv >> 7) == 1,
                               torch.gather(win1[r], 1, w2),
                               torch.gather(win0[r], 1, w2))
    return acc


def compiled_limits() -> dict:
    """What the built library was compiled with: the ring's stages, the
    elements of a thread, and per mode the bytes of shared memory a block
    of the planner's rows needs."""
    lib = _build.load_library("gather_micro")
    return {
        "ring": lib.paris_gm_ring(),
        "per": lib.paris_gm2_per(),
        "smem": {m: lib.paris_gm2_smem(MODES.index(m), plan_ring(m).rows)
                 for m in MODES},
    }


def blocks_per_sm(mode: str, plan: BandPlan,
                  device: Optional[torch.device] = None) -> int:
    """Resident blocks per SM of the kernel of ``mode`` at ``plan``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    dev = device if device is not None else card()
    lib = _build.load_library("gather_micro")
    n = lib.paris_gm2_blocks_per_sm(dev.index or 0, MODES.index(mode),
                                    plan.rows, plan.smem)
    if n < 0:
        raise RuntimeError(f"occupancy query of {mode} at {plan} failed: "
                           f"CUDA error {-n} "
                           f"({lib.paris_gm_error_string(-n).decode()})")
    return n


def gather_micro2_cuda(mode: str, k0: torch.Tensor, tab: torch.Tensor,
                       idx: torch.Tensor, blocks: int = BLOCKS,
                       plan: Optional[BandPlan] = None) -> torch.Tensor:
    """The kernel: ``blocks`` copies of the tile of ``mode`` as a
    (blocks, 64, 128) int32 tensor, each computed by 64 / rows thread
    blocks of ``plan`` (``plan_ring(mode)`` unless given).  Launches on
    the current stream and adds one to ``gather_micro2_cuda.launches``; a
    launch the card refuses raises."""
    _check(mode, k0, tab, idx)
    dev = check_on_card({"tab": tab, "k0": k0, "idx": idx})
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    if plan is None:
        plan = plan_ring(mode)
    out = torch.empty((blocks, 64, 128), dtype=torch.int32, device=dev)
    lib = _build.load_library("gather_micro")
    rc = lib.paris_gm2_launch(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        MODES.index(mode), k0.data_ptr(), tab.data_ptr(), idx.data_ptr(),
        out.data_ptr(), blocks, plan.rows, plan.smem)
    if rc != 0:
        raise RuntimeError(f"gather_micro2 kernel ({mode}) launch at "
                           f"{plan} failed: CUDA error {rc} "
                           f"({lib.paris_gm_error_string(rc).decode()})")
    gather_micro2_cuda.launches += 1
    return out


gather_micro2_cuda.launches = 0


def run(mode: str) -> float:
    """ns per (64, 128) gather of ``mode`` on the card: a launch of
    BLOCKS tiles of REPS gathers each, timed over the launches of
    ``time_launches``."""
    k0, tab, idx = inputs(card())
    ms = time_launches(lambda: gather_micro2_cuda(mode, k0, tab, idx))
    return ms * 1e6 / (BLOCKS * REPS)


def main() -> dict:
    out = {f"{mode}_ns": round(run(mode), 3) for mode in MODES}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
