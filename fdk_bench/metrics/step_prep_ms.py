"""step_prep_ms (ms, step, traced run): the card's milliseconds per step
of the program's "step.prep" span: the raw frames' conversion to float32,
then the fast mode's u16 round trip or the exact mode's identity
dequantize, timed by the span's CUDA events on the step's stream."""

from fdk_bench.lib.spans import per_call_ms

UNIT = "ms"


def read(record):
    return per_call_ms(record, "step.prep", "device_s")
