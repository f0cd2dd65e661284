"""k1_roofline (%, K1, traced run): the least time of the profiled block
pass's backprojection work (``lib/work.k1_pass_least_s``: the frozen
operation and byte count of block 0 at the card's published peaks) over
the summed device time of the kernels ``lib/trace.is_k1`` calls K1."""

from fdk_bench.lib.trace import is_k1

UNIT = "%"


def read(record):
    t = record.get("trace", {}).get("block")
    b = record.get("block")
    if not t or not b:
        return None
    k1 = sum(s for name, s in t["kernels"] if is_k1(name))
    if k1 <= 0:
        return None
    return 100.0 * b["k1_least_s"] / k1
