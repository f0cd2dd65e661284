"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: the device's kernel and copy intervals inside a window
named by one of the benchmark's own host spans, their union, the
longest idle gaps (named by the host spans around them) and the device
time by operation."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATS = ("user_annotation",)


def events(trace: dict) -> List[dict]:
    """The complete ("X") events of a Chrome trace."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e and "dur" in e]


def device_ops(evs: Iterable[dict]) -> List[Tuple[str, float, float, str]]:
    """(name, start us, end us, category) of every kernel, copy and
    memset on the device."""
    return [(e.get("name", ""), float(e["ts"]), float(e["ts"]) +
             float(e["dur"]), e.get("cat", "")) for e in evs
            if e.get("cat") in DEVICE_CATS]


def spans(evs: Iterable[dict], name: Optional[str] = None
          ) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of the host spans (``record_function``
    ranges), all or those called ``name``."""
    return [(e.get("name", ""), float(e["ts"]), float(e["ts"]) +
             float(e["dur"])) for e in evs
            if e.get("cat") in SPAN_CATS
            and (name is None or e.get("name") == name)]


def clip(ops, lo: float, hi: float):
    """``ops`` cut to [lo, hi], those outside dropped."""
    out = []
    for name, a, b, cat in ops:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((name, a, b, cat))
    return out


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of [a, b) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(ops) -> float:
    """Microseconds in which at least one of ``ops`` ran."""
    return sum(b - a for a, b in union([(a, b) for _, a, b, _ in ops]))


def idle_gaps(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of the device inside [lo, hi]."""
    gaps, t = [], lo
    for a, b in union([(a, b) for _, a, b, _ in ops]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def gap_name(gap: Tuple[float, float], host: Sequence[Tuple[str, float,
                                                             float]]) -> str:
    """The host spans around the middle of ``gap``, outermost first,
    joined by "/"; "(none)" where no span covers it."""
    mid = (gap[0] + gap[1]) / 2
    around = sorted((s for s in host if s[1] <= mid <= s[2]),
                    key=lambda s: s[1] - s[2])
    return "/".join(s[0] for s in around) or "(none)"


def summarize(trace: dict, window_span: str) -> Optional[dict]:
    """The device inside the spans called ``window_span``: seconds busy
    (kernels, copies, memsets), seconds of window, every kernel's
    (name, seconds), the ten operations with the most device seconds,
    and the ten longest idle gaps named by the host spans.  None where the trace has
    no such span or no device operation."""
    evs = events(trace)
    windows = spans(evs, window_span)
    ops = device_ops(evs)
    if not windows or not ops:
        return None
    host = spans(evs)
    busy = window = 0.0
    by_name: Dict[str, float] = {}
    kernels: List[Tuple[str, float]] = []
    gaps: List[Tuple[float, str]] = []
    for _, lo, hi in windows:
        inside = clip(ops, lo, hi)
        busy += busy_us(inside)
        window += hi - lo
        for name, a, b, cat in inside:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            if cat == "kernel":
                kernels.append((name, b - a))
        for g in idle_gaps(inside, lo, hi):
            gaps.append((g[1] - g[0], gap_name(g, host)))
    if busy <= 0:
        return None
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": window / 1e6,
            "kernels": [(n, us / 1e6) for n, us in kernels],
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for us, n in gaps[:10]]}


def is_k1(name: str) -> bool:
    """The benchmark's own matcher for the backprojection kernel (K1):
    the CUDA entry ``bp_kernel`` of ``csrc/backproject.cu``, any
    instantiation."""
    return "bp_kernel" in name


def span(name: str, on: bool = True):
    """A named host span (a ``record_function`` range) in the profiler's
    trace; ``on`` False: nothing."""
    import contextlib

    import torch
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()
