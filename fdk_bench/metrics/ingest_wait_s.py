"""ingest_wait_s (s, host ingest + h2d): per job, the mean seconds the
program's step loop waited on a staged chunk ("stage_wait" of its
"block K ingest" lines): the host holding the card back."""

UNIT = "s"


def read(record):
    jobs = record.get("jobs")
    if not jobs or not any(j["blocks"] for j in jobs):
        return None
    return sum(j["stage_wait"] for j in jobs) / len(jobs)
