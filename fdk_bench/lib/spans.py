"""The program's own spans of the traced pass, as its tracer
(``paris_tpu_torch.utils.profiling.collected``) sums them: the spans
recorded while the run's profiler ran, per name, with their count, host
seconds and device seconds (timing CUDA events on the stream the span's
work runs on)."""

from __future__ import annotations

from typing import Optional


def program_spans(record) -> Optional[dict]:
    """{name: {"count", "host_s", "self_host_s", "device_s"}} of the
    traced pass; None where the run traced no block pass, or the program
    keeps no such record."""
    if not record.get("trace", {}).get("block"):
        return None
    from paris_tpu_torch.utils import profiling
    collected = getattr(profiling, "collected", None)
    got = collected() if collected is not None else None
    return got.get("spans") if got else None


def per_call_ms(record, name: str, key: str) -> Optional[float]:
    """Milliseconds of span ``name``'s ``key`` ("host_s" or "device_s")
    per call in the traced pass; None where it has none."""
    spans = program_spans(record)
    s = spans.get(name) if spans else None
    if not s or not s.get("count") or s.get(key) is None:
        return None
    return 1e3 * s[key] / s["count"]
