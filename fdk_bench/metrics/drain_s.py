"""drain_s (s, drain): per job, the mean seconds of the program's drain
of its blocks to the ddbvf, from its "block K drain" lines: the host's
pwrites plus the writer's waits on the slabs' copies to the host."""

UNIT = "s"


def read(record):
    jobs = record.get("jobs")
    if not jobs or not any(j["blocks"] for j in jobs):
        return None
    return sum(j["drain"] for j in jobs) / len(jobs)
