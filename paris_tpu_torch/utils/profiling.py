"""Profiling (port of ``paris_tpu/utils/profiling.py``).

  * ``trace()`` wraps a region in ``torch.profiler`` when a directory is
    given, else is a no-op, and writes one Chrome-trace JSON per region
    (open it in Perfetto or chrome://tracing);
  * ``annotate`` names a host region inside those traces, and in NVTX
    when a card is present;
  * ``ThroughputMeter`` (projections/s, voxel updates/s) is the JAX-free
    one of ``paris_tpu.utils.profiling``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Optional

import torch

from paris_tpu.utils.profiling import ThroughputMeter

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
