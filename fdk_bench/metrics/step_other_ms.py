"""step_other_ms (ms, step, traced run): device milliseconds per step of
every kernel of the profiled block pass that is not K1: the raw
conversion, the u16 round trip, the weighting, the cuFFT ramp filter,
the casts, the accumulator's zeroing."""

from fdk_bench.lib.trace import is_k1

UNIT = "ms"


def read(record):
    t = record.get("trace", {}).get("block")
    b = record.get("block")
    if not t or not b or not b.get("traced_steps"):
        return None
    other = sum(s for name, s in t["kernels"] if not is_k1(name))
    return 1e3 * other / b["traced_steps"]
