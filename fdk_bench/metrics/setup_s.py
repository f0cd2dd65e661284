"""setup_s (s, end to end, host clock): from the process's start to the
window's start: the scan's synthesis and staging or writing, the kernel
libraries' load (their build, in a checkout's first run), the warm-up."""

UNIT = "s"


def read(record):
    return record.get("setup_s")
