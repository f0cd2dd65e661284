"""job_other_s (s, job driver): per job, the mean of its wall seconds
(the harness's clock around ``run_job``) less the program's own
"reconstruct" seconds (its blocks' ingest lines) and drain seconds (its
blocks' drain lines: pwrites and waits on copies): the file table, the
plan, the sink and its manifest, the Reconstructor, the pinned rings,
the writer thread."""

UNIT = "s"


def read(record):
    jobs = record.get("jobs")
    if not jobs or not any(j["blocks"] for j in jobs):
        return None
    return sum(j["wall_s"] - j["reconstruct"] - j["drain"]
               for j in jobs) / len(jobs)
