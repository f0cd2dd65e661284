"""device_idle_share.job (%, device, traced run): 1 - the union of the
card's kernel, copy and memset intervals over the profiled jobs' spans
(the harness's own "fdk_bench.job" spans), as a share of their length."""

UNIT = "%"


def read(record):
    t = record.get("trace", {}).get("job")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
