"""device_idle_share.block (%, device, traced run): 1 - the union of the
card's kernel, copy and memset intervals over the profiled block pass
(the harness's "fdk_bench.block_pass" span, ending at a synchronize), as
a share of its length."""

UNIT = "%"


def read(record):
    t = record.get("trace", {}).get("block")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
