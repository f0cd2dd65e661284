"""Synthesize the BASELINE config-5 scan at its stated size: 3600
projections of 2048 x 2048, as HIS files of 8 float32 frames each (the
counterpart of ``benchmarks/synth_c5_3600.py``).

    python -m paris_tpu_torch.benchmarks.synth_c5_3600 --workdir DIR [--n-proj N]

Frames come from the analytic projector on the card
(``phantom.cone_beam_project_torch``).  Batch i+1 is computed on the card
while batch i is copied into pinned host memory on a copy stream of its
own and written, so the card's work hides behind the disk write.  Each
file is written as ``.tmp`` and renamed, so a file that exists is
complete; complete files are skipped, so an interrupted synthesis
continues where it stopped.  ``SYNTH_DONE`` is written last: the golden
oracle (``golden_slab``) tails the directory and reads the marker as "no
more files are coming".  3600 frames are 60.4 GB on disk.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from ..geometry import DetectorGeometry, VolumeGeometry, derive_volume_geometry
from ..io.his import write_his
from ..phantom import cone_beam_project_torch, projector_device

__all__ = ["N_PROJ", "BATCH", "PROJ_SUBDIR", "DONE_MARKER", "config5",
           "phantom_scale", "his_path", "synthesize", "main"]

N_PROJ = 3600
BATCH = 8                    # frames per HIS file
PROJ_SUBDIR = "proj3600"
DONE_MARKER = "SYNTH_DONE"


def config5(n_proj: int = N_PROJ) -> DetectorGeometry:
    """BASELINE config 5's detector: 2048 x 2048 pixels of 0.25 mm,
    d_so 2048 mm, d_od 1024 mm, ``n_proj`` projections over 360 degrees
    (its volume is 2048 x 2048 x 2055)."""
    return DetectorGeometry(2048, 2048, 0.25, 0.25, 0.0, 0.0, 2048.0, 1024.0,
                            360.0 / n_proj)


def phantom_scale(vol: VolumeGeometry) -> float:
    """The phantom's half extent in mm: 90 % of the volume's half width."""
    return vol.dim_x * vol.l_vx_x / 2 * 0.9


def his_path(pdir: str, first: int) -> str:
    """The HIS file whose first frame is ``first``."""
    return os.path.join(pdir, f"b{first:05d}.his")


def synthesize(workdir: str, det: DetectorGeometry, n_proj: int, *,
               device=None, subdir: str = PROJ_SUBDIR) -> dict:
    """Write projections 0..n_proj-1 (angle i * det.delta_phi) of the
    phantom into ``workdir/subdir`` as HIS files of ``BATCH`` frames, then
    ``SYNTH_DONE``.  ``device`` is the projector's (default: the card).
    Returns the frames written, the seconds of the whole run, of the disk
    writes, and the card's milliseconds per batch (None off the card)."""
    device = projector_device(device)
    scale = phantom_scale(derive_volume_geometry(det))
    angles = np.arange(n_proj, dtype=np.float64) * det.delta_phi
    pdir = os.path.join(workdir, subdir)
    os.makedirs(pdir, exist_ok=True)
    frame_bytes = 4 * det.n_row * det.n_col

    def complete(i: int, n: int) -> bool:
        try:                      # tmp + rename: an existing file is whole
            return os.path.getsize(his_path(pdir, i)) >= n * frame_bytes
        except OSError:
            return False

    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    host = [torch.empty((BATCH, det.n_col, det.n_row), dtype=torch.float32,
                        pin_memory=on_card) for _ in range(2)]
    card_ms = []                  # (start, end) event pairs of each batch
    t0 = time.perf_counter()
    write_s = 0.0
    n_written = 0
    pending = None     # (first frame, host buffer, card tensor, event)

    def drain(p):
        nonlocal write_s, n_written
        i, buf, _frames, copied = p
        if copied is not None:
            copied.synchronize()
        t = time.perf_counter()
        path = his_path(pdir, i)
        write_his(path + ".tmp", buf.numpy(), number_dtype=np.float32)
        os.replace(path + ".tmp", path)
        write_s += time.perf_counter() - t
        n_written += buf.shape[0]

    n_done = 0                    # batches computed: picks the host buffer
    for i in range(0, n_proj, BATCH):
        n = min(BATCH, n_proj - i)
        if complete(i, n):
            continue
        buf = host[n_done % 2][:n]
        n_done += 1
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            frames = cone_beam_project_torch(det, angles[i:i + n], scale,
                                             device=device)
            end.record()
            card_ms.append((start, end))
            # the copy waits for the batch; the next batch is computed
            # on the default stream while this one is copied and written
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(end)
                buf.copy_(frames, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
        else:
            frames = cone_beam_project_torch(det, angles[i:i + n], scale,
                                             device=device)
            buf.copy_(frames)
            copied = None
        if pending is not None:
            drain(pending)
        # the card tensor stays referenced until its copy has finished
        pending = (i, buf, frames, copied)
        if n_done % 25 == 1:
            dt = time.perf_counter() - t0
            print(f"[synth] {i + n}/{n_proj} frames "
                  f"({n_written / dt if dt else 0.0:.1f} fr/s, {dt:.0f} s)",
                  flush=True)
    if pending is not None:
        drain(pending)
    marker = os.path.join(pdir, DONE_MARKER)
    with open(marker + ".tmp", "w") as f:
        f.write(str(n_proj))
    os.replace(marker + ".tmp", marker)
    seconds = time.perf_counter() - t0
    ms = [s.elapsed_time(e) for s, e in card_ms]
    print(f"[synth] done: {n_written} frames written in {seconds:.1f} s "
          f"({write_s:.1f} s of disk writes)", flush=True)
    return {"frames_written": n_written, "seconds": seconds,
            "write_seconds": write_s,
            "card_ms_per_batch": float(np.median(ms)) if ms else None,
            "card_seconds": sum(ms) / 1e3 if ms else None}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--n-proj", type=int, default=N_PROJ)
    args = ap.parse_args(argv)
    return synthesize(args.workdir, config5(args.n_proj), args.n_proj)


if __name__ == "__main__":
    main()
