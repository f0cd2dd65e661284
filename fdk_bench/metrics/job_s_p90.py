"""job_s_p90 (s, end to end, host clock): the 90th percentile of the
window's jobs' wall seconds (``statistics.quantiles``, n=10), the wait
an operator has for one preview."""

import statistics

UNIT = "s"


def read(record):
    jobs = record.get("jobs")
    if not jobs or len(jobs) < 2:
        return None
    return statistics.quantiles([j["wall_s"] for j in jobs], n=10)[8]
