"""step_host_ms (ms, host, traced run): the host's milliseconds per step
of the program's "step" span (``Reconstructor.step_staged``): what it
costs the host to enqueue one step, the tracer's own spans inside it
included."""

from fdk_bench.lib.spans import per_call_ms

UNIT = "ms"


def read(record):
    return per_call_ms(record, "step", "host_s")
