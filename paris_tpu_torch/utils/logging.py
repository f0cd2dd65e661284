"""Logging / timing utilities (reference: Boost trivial log + the single
wall-clock readout, src/main.cpp:60-67,171-178 — here with per-stage
timers and a throughput reporter, SURVEY.md §5 tracing)."""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

__all__ = ["setup_logging", "StageTimers", "fmt_duration"]


def setup_logging(verbose: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="[%(asctime)s] [%(levelname)s] %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )


def fmt_duration(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    return f"{m}m{s:02d}s" if m else f"{seconds:.2f}s"


class StageTimers:
    """Accumulating named wall-clock totals, fed by the spans
    (``utils/profiling.span``) given them; threads may add to one (the
    staging workers' "read" beside the consumer's)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + count

    def merge(self, other: "StageTimers") -> None:
        """Add ``other``'s totals and counts to these."""
        for name, seconds in list(other.totals.items()):
            self.add(name, seconds, other.counts[name])

    def report(self, log: Optional[logging.Logger] = None) -> str:
        lines = [
            f"{name}: {fmt_duration(t)} ({self.counts[name]} calls)"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        text = "; ".join(lines)
        if log:
            log.info("stage timings: %s", text)
        return text
