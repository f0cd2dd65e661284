"""Profiling (port of ``paris_tpu/utils/profiling.py``).

  * ``trace()`` wraps a region in ``torch.profiler`` when a directory is
    given, else is a no-op, and writes one Chrome-trace JSON per region
    (open it in Perfetto or chrome://tracing);
  * ``annotate`` names a host region inside those traces, and in NVTX
    when a card is present;
  * ``ThroughputMeter`` reports projections/s and voxel updates/s (the
    BASELINE.json north-star metrics) during a run.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Optional

import torch


logger = logging.getLogger("paris_tpu_torch.profiling")

__all__ = ["trace", "annotate", "ThroughputMeter"]


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None,
          device: Optional[torch.device] = None):
    """Profile the enclosed region into a new Chrome-trace file in
    ``trace_dir`` (no-op if None).  Records host activity, and the card's
    kernels and copies when ``device`` is a CUDA device (by default: when a
    card is present)."""
    if not trace_dir:
        yield
        return
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        fd, path = tempfile.mkstemp(
            prefix=time.strftime("%Y%m%d-%H%M%S-"), suffix=".pt.trace.json",
            dir=trace_dir)
        os.close(fd)
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named host region: a ``record_function`` range in profiler traces,
    and an NVTX range when a card is present."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class ThroughputMeter:
    """Accumulates voxel-update / projection counts; logs rates.

    ``report_every`` controls the cadence of progress logs (the
    reference logged every 10th projection; we log on a work-volume
    cadence so huge runs aren't log-bound).
    """

    def __init__(self, voxels_per_block: int, report_every_s: float = 10.0):
        self.voxels = voxels_per_block
        self.t0 = time.perf_counter()
        self._last = self.t0
        self.report_every_s = report_every_s
        self.projections = 0

    def add(self, n_projections: int) -> None:
        self.projections += n_projections
        now = time.perf_counter()
        if now - self._last >= self.report_every_s:
            self._last = now
            self.log()

    @property
    def voxel_updates(self) -> int:
        return self.projections * self.voxels

    def rates(self):
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return self.projections / dt, self.voxel_updates / dt / 1e9

    def log(self) -> None:
        pps, gups = self.rates()
        logger.info("progress: %d projections, %.1f proj/s, %.1f Gupd/s",
                    self.projections, pps, gups)
