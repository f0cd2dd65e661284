"""step_k1_ms (ms, K1 backprojection, traced run): the card's
milliseconds per step of the program's "step.k1" span: the
backprojection kernel's launch, timed by the span's CUDA events on the
step's stream."""

from fdk_bench.lib.spans import per_call_ms

UNIT = "ms"


def read(record):
    return per_call_ms(record, "step.k1", "device_s")
