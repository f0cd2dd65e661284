"""Profiling and tracing (port of ``paris_tpu/utils/profiling.py``).

  * ``trace()`` wraps a region in ``torch.profiler`` when a directory is
    given, else is a no-op, and writes one Chrome-trace JSON per region
    (open it in Perfetto or chrome://tracing);
  * ``span`` names a region of the program.  Tracing is on while a
    ``torch.profiler`` session runs in the process (``trace()``'s, or any
    other): a span is then a ``record_function`` range in that session's
    trace and a record in memory (name, parent span, host start and end,
    thread, job id), and, asked for device time, a pair of timing CUDA
    events on the current stream.  Off, a span only adds its host seconds
    to the ``StageTimers`` it is given;
  * ``job`` opens the span of one job and the id its spans share;
  * ``count`` adds to the process's counters of work done;
  * ``collected()`` sums the spans of the latest profiled session, per
    name, beside the counters;
  * ``ThroughputMeter`` reports projections/s and voxel updates/s (the
    BASELINE.json north-star metrics) during a run.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


logger = logging.getLogger("paris_tpu_torch.profiling")

__all__ = ["trace", "span", "job", "count", "counters", "collected",
           "records", "ThroughputMeter"]


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None,
          device: Optional[torch.device] = None):
    """Profile the enclosed region into a new Chrome-trace file in
    ``trace_dir`` (no-op if None).  Records host activity on every thread
    (the staging workers name each copy of the pinned ring "h2d"), and
    the card's kernels and copies when ``device`` is a CUDA device (by
    default: when a card is present).  A profiled region starts the
    spans' record afresh."""
    if not trace_dir:
        yield
        return
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    # every thread: the staging workers' "h2d" ranges are the ring's copies
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
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


# ------------------------------------------------------------------ spans

class _Record:
    """One span entered while tracing was on."""

    __slots__ = ("name", "parent", "job", "thread", "start", "end",
                 "child_s", "events", "_device_s")

    def __init__(self, name: str, parent: Optional["_Record"],
                 job_id: Optional[int]):
        self.name, self.parent, self.job = name, parent, job_id
        self.thread = threading.current_thread().name
        self.start = self.end = None
        self.child_s = 0.0          # host seconds of its child spans
        self.events = None          # (start, end) timing CUDA events
        self._device_s = None

    def device_s(self) -> Optional[float]:
        """Seconds between its two CUDA events (waits for the second);
        None for a span without them."""
        if self._device_s is None and self.events and self.events[1]:
            start, end = self.events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
        return self._device_s


_session: Optional[List[_Record]] = None    # the latest profiled session's
_open = threading.local()                  # each thread's open spans
_job: Optional[int] = None                 # the running job's id
_job_ids = itertools.count(1)


def _new_session() -> None:
    global _session
    _session = []


# A profiler session starts through this hook of torch's (it sets the flag
# that spans read): each start begins a new record.
_profiler_start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
if _profiler_start is not None:
    def _run_on_profiler_start(start=_profiler_start):
        start()
        _new_session()
    _autograd_profiler._run_on_profiler_start = _run_on_profiler_start


class span:
    """A named region: ``with span("step", timers=t): ...``.

    Adds its host seconds to ``timers`` (a ``StageTimers``) when given.
    While a profiler session runs it is also a ``record_function`` range
    of that name, nested in the spans open on its thread, and a record
    of ``collected()``; with ``device`` also a timing CUDA event on the
    current stream at its entry and one at its exit (pass True only for
    work on the card).  With no session it enters no ``record_function``
    and makes no event."""

    __slots__ = ("name", "timers", "device", "_t0", "_rec", "_rf")

    def __init__(self, name: str, *, timers=None, device: bool = False):
        self.name, self.timers, self.device = name, timers, device
        self._rec = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._begin()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self.timers is not None:
            self.timers.add(self.name, t1 - self._t0)
        if self._rec is not None:
            self._finish(t1)

    def _begin(self) -> None:
        if _session is None:
            _new_session()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = _Record(self.name, stack[-1] if stack else None, _job)
        self._rf = _autograd_profiler.record_function(self.name)
        self._rf.__enter__()
        if self.device:
            rec.events = [torch.cuda.Event(enable_timing=True), None]
            rec.events[0].record()
        stack.append(rec)
        _session.append(rec)
        self._rec = rec

    def _finish(self, t1: float) -> None:
        rec = self._rec
        if rec.events:
            rec.events[1] = torch.cuda.Event(enable_timing=True)
            rec.events[1].record()
        self._rf.__exit__(None, None, None)
        rec.start, rec.end = self._t0, t1
        _open.stack.remove(rec)
        if rec.parent is not None:
            rec.parent.child_s += t1 - self._t0

    def device_seconds(self) -> Optional[float]:
        """The card's seconds between the span's entry and exit (waits for
        them), or None: not traced, or no device time asked for."""
        return None if self._rec is None else self._rec.device_s()


def records() -> List[dict]:
    """The finished spans of the latest profiled session, in order of
    entry: name, parent's name, job id, thread, host start and end
    (``perf_counter`` seconds), device seconds (None without events)."""
    return [{"name": r.name,
             "parent": r.parent.name if r.parent is not None else None,
             "job": r.job, "thread": r.thread, "start": r.start,
             "end": r.end, "device_s": r.device_s()}
            for r in list(_session or ()) if r.end is not None]


def collected() -> Optional[dict]:
    """The latest profiled session's spans and the counters:
    ``{"spans": {name: {"count", "host_s", "self_host_s", "device_s"}},
    "counters": counters()}``.  ``self_host_s`` is the host seconds less
    those of its child spans; ``device_s`` None for a span without
    device time.  None before any session."""
    if _session is None:
        return None
    out: Dict[str, dict] = {}
    for r in list(_session):
        if r.end is None:
            continue
        s = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                    "self_host_s": 0.0, "device_s": None})
        host = r.end - r.start
        s["count"] += 1
        s["host_s"] += host
        s["self_host_s"] += host - r.child_s
        if r.events:
            s["device_s"] = (s["device_s"] or 0.0) + r.device_s()
    return {"spans": out, "counters": counters()}


# --------------------------------------------------------------- counters

COUNTERS = ("his_bytes_read", "h2d_bytes", "d2h_bytes",
            "ddbvf_bytes_written", "steps")
_counts = dict.fromkeys(COUNTERS, 0)
_counts_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name`` (one of ``COUNTERS``)."""
    with _counts_lock:
        _counts[name] += int(n)


def counters() -> Dict[str, int]:
    """The process's counters, with the kernels' launch counts
    (``backproject_chunk_cuda.launches``, and per copy mode, i.e. per
    instantiation of K1, ``backproject_chunk_cuda.launches.async``,
    ``.element`` and ``.global``; ``u16_round_trip.launches``)."""
    from ..ops.backprojection_cuda import backproject_chunk_cuda
    from ..pipeline import u16_round_trip
    with _counts_lock:
        out = dict(_counts)
    out["backproject_chunk_cuda.launches"] = backproject_chunk_cuda.launches
    for mode, n in backproject_chunk_cuda.launches_by_copy.items():
        out[f"backproject_chunk_cuda.launches.{mode}"] = n
    out["u16_round_trip.launches"] = u16_round_trip.launches
    return out


@contextlib.contextmanager
def job():
    """The "job" span around one job, under a new job id that every span
    entered meanwhile carries (the job's worker threads' too); at its end
    one log line with what the counters counted during the job."""
    global _job
    before = counters()
    outer, _job = _job, next(_job_ids)
    try:
        with span("job"):
            yield _job
    finally:
        _job = outer
    after = counters()
    logger.info("job counters: %s", ", ".join(
        f"{name} {after[name] - before[name]}" for name in after))


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
