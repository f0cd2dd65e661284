"""job_gupd_per_s (Gupd/s, end to end, host clock): ROI voxels x
projections of every job started in the window, over the seconds from
the first job's start to the last job's end."""

UNIT = "Gupd/s"


def read(record):
    jobs = record.get("jobs")
    if not jobs or record.get("job_window_s", 0) <= 0:
        return None
    return sum(j["updates"] for j in jobs) / record["job_window_s"] / 1e9
