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
"""

from __future__ import annotations

import json
from typing import Callable, Tuple

import numpy as np
import torch

from .. import _build

__all__ = ["REPS", "C", "BLOCKS", "MODES", "CASES", "inputs",
           "gather_micro_torch", "gather_micro_cuda", "run", "main"]

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


def inputs(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The benchmark's (tab, idx): tab = arange as (C, 128, 128), idx
    (64, 128) drawn in [0, 255) from numpy's generator seeded 0; int32."""
    tab = torch.arange(C * 128 * 128, dtype=torch.int32,
                       device=device).reshape(C, 128, 128)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (64, 128)).astype(np.int32)).to(device)
    return tab, idx


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


def gather_micro_cuda(mode: str, S: int, tab: torch.Tensor,
                      idx: torch.Tensor, blocks: int = BLOCKS
                      ) -> torch.Tensor:
    """The kernel: ``blocks`` copies of the tile of ``mode``, one per
    thread block, as a (blocks, 64, 128) int32 tensor.  Launches on the
    current stream and adds one to ``gather_micro_cuda.launches``."""
    _check(mode, S, tab, idx)
    dev = check_on_card({"tab": tab, "idx": idx})
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    out = torch.empty((blocks, 64, 128), dtype=torch.int32, device=dev)
    lib = _build.load_library("gather_micro")
    rc = lib.paris_gm1_launch(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        MODES.index(mode), S, tab.data_ptr(), idx.data_ptr(),
        out.data_ptr(), blocks)
    if rc != 0:
        raise RuntimeError(f"gather_micro kernel ({mode}, S={S}) launch "
                           f"failed: CUDA error {rc} "
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
