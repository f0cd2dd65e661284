"""step_filter_ms (ms, step, traced run): the card's milliseconds per
step of the program's "step.filter" span: the cosine weighting, the
cuFFT ramp filter and the cast to the kernel's type, timed by the
span's CUDA events on the step's stream."""

from fdk_bench.lib.spans import per_call_ms

UNIT = "ms"


def read(record):
    return per_call_ms(record, "step.filter", "device_s")
