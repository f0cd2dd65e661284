"""block_gupd_per_s (Gupd/s, end to end, host clock): voxel updates of
every step enqueued in the window (valid slices x projections) over the
window's seconds, which end at a ``torch.cuda.synchronize()``."""

UNIT = "Gupd/s"


def read(record):
    b = record.get("block")
    if not b or b["window_s"] <= 0:
        return None
    return b["updates"] / b["window_s"] / 1e9
