"""step_mfu (%, step, traced run): the least time of the profiled block
pass's backprojection work at the card's float32 peak (the K1 count of
``lib/work``) over the pass's whole length: the share of the chip's peak
the whole step reaches, which bounds K1's roofline share from below when
other work is on the path."""

UNIT = "%"


def read(record):
    t = record.get("trace", {}).get("block")
    b = record.get("block")
    if not t or not b or t["window_s"] <= 0:
        return None
    return 100.0 * b["k1_least_s"] / t["window_s"]
