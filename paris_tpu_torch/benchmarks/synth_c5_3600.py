"""Synthesize the BASELINE config-5 scan at its stated size: 3600
projections of 2048 x 2048, as HIS files of 8 frames each (the
counterpart of ``benchmarks/synth_c5_3600.py``).

    python -m paris_tpu_torch.benchmarks.synth_c5_3600 --workdir DIR [--n-proj N] [--number-type uint16]

Frames come from the analytic projector on the card
(``phantom.cone_beam_project_torch``).  Batch i+1 is computed on the card
while batch i is copied into pinned host memory on a copy stream of its
own and written, so the card's work hides behind the disk write.  Each
file is written as ``.tmp`` and renamed, so a file that exists is
complete; complete files (their HIS header's frame count and number type,
and all their bytes) are skipped, so an interrupted synthesis continues
where it stopped.  ``scan_map.json`` (the number type and the affine map
from stored values to line integrals) and then ``SYNTH_DONE`` are written
last: the golden oracle (``golden_slab``) tails the directory and reads
the marker as "no more files are coming".

Number types: ``float32`` (HIS type 128) stores the line integrals, 60.4
GB at 3600 frames; ``uint16`` (HIS type 4, what flat-panel detectors
write) stores counts ``rint(p / scale)`` with one ``scale`` for the whole
scan and offset 0, 30.2 GB.  ``scale`` is fixed before the first frame,
from a bound on every line integral of the phantom at every angle
(``line_integral_bound``); the counts are rounded on the card, before the
copy to the host, and a count outside 0..65535 fails the synthesis.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..geometry import DetectorGeometry, VolumeGeometry, derive_volume_geometry
from ..io.his import HisFormatError, read_his_header, write_his
from ..phantom import (SHEPP_LOGAN_ELLIPSOIDS, cone_beam_project_torch,
                       projector_device)

__all__ = ["N_PROJ", "BATCH", "PROJ_SUBDIR", "DONE_MARKER", "MAP_FILE",
           "NUMBER_TYPES", "config5", "phantom_scale", "his_path",
           "line_integral_bound", "count_scale", "scan_bytes", "whole_his",
           "read_scan_map", "synthesize", "main"]

N_PROJ = 3600
BATCH = 8                    # frames per HIS file
PROJ_SUBDIR = "proj3600"
DONE_MARKER = "SYNTH_DONE"
MAP_FILE = "scan_map.json"
NUMBER_TYPES = ("float32", "uint16")
U16_MAX = 65535


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


def line_integral_bound(scale_mm: float) -> float:
    """An upper bound on every line integral of the phantom, at every
    angle: a line meets an ellipsoid in a chord no longer than twice its
    largest semi-axis, and an ellipsoid of negative density only lowers
    the integral, so the sum over the positive ones of density x longest
    chord bounds every ray.  The phantom's densities add up to >= 0
    everywhere, so no line integral is negative."""
    e = SHEPP_LOGAN_ELLIPSOIDS
    pos = e[:, 0] > 0
    return float(np.sum(e[pos, 0] * 2.0 * e[pos, 4:7].max(axis=1))
                 * scale_mm)


def count_scale(scale_mm: float) -> float:
    """Line integral per count of a uint16 scan: the bound at 65535."""
    return line_integral_bound(scale_mm) / U16_MAX


def scan_bytes(det: DetectorGeometry, n_proj: int,
               number_type: str = "float32") -> int:
    """Bytes of the synthesizer's HIS files for ``n_proj`` frames."""
    frame = np.dtype(number_type).itemsize * det.n_row * det.n_col
    headers = -(-n_proj // BATCH) * 68 + n_proj * 32
    return n_proj * frame + headers


def whole_his(path: str, n: int, number_type: Optional[str] = None) -> bool:
    """Does ``path`` hold ``n`` whole frames (of ``number_type``, if
    given)?  The frame size comes from the file's own HIS header."""
    try:
        header = read_his_header(path)
        size = os.path.getsize(path)
    except (OSError, HisFormatError):
        return False
    if header.frame_number != n or (
            number_type is not None
            and header.dtype != np.dtype(number_type)):
        return False
    return size >= header.file_bytes


def read_scan_map(pdir: str) -> dict:
    """The scan's ``scan_map.json``: number type, scale, offset, n_proj."""
    with open(os.path.join(pdir, MAP_FILE)) as f:
        return json.load(f)


def _write_atomic(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def synthesize(workdir: str, det: DetectorGeometry, n_proj: int, *,
               device=None, subdir: str = PROJ_SUBDIR,
               number_type: str = "float32") -> dict:
    """Write projections 0..n_proj-1 (angle i * det.delta_phi) of the
    phantom into ``workdir/subdir`` as HIS files of ``BATCH`` frames of
    ``number_type``, then ``scan_map.json`` and ``SYNTH_DONE``.
    ``device`` is the projector's (default: the card).  Returns the frames
    written, the map, the seconds of the whole run, of the disk writes,
    and the card's milliseconds per batch (None off the card); raises,
    writing no marker, if a uint16 count fell outside 0..65535."""
    if number_type not in NUMBER_TYPES:
        raise ValueError(f"number type {number_type!r} is not one of "
                         f"{NUMBER_TYPES}")
    device = projector_device(device)
    scale_mm = phantom_scale(derive_volume_geometry(det))
    u16 = number_type == "uint16"
    qscale = count_scale(scale_mm) if u16 else 1.0
    angles = np.arange(n_proj, dtype=np.float64) * det.delta_phi
    pdir = os.path.join(workdir, subdir)
    os.makedirs(pdir, exist_ok=True)

    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    # a uint16 frame travels as int16 with the same bits (counts above
    # 32767 wrap), and is viewed as uint16 on the host
    host_dtype = torch.int16 if u16 else torch.float32
    host = [torch.empty((BATCH, det.n_col, det.n_row), dtype=host_dtype,
                        pin_memory=on_card) for _ in range(2)]
    clipped = torch.zeros((), dtype=torch.int64, device=device)
    card_ms = []                  # (start, end) event pairs of each batch
    t0 = time.perf_counter()
    write_s = 0.0
    n_written = 0
    pending = None     # (first frame, host buffer, card tensor, event)

    def project(i, n):
        frames = cone_beam_project_torch(det, angles[i:i + n], scale_mm,
                                         device=device)
        if not u16:
            return frames
        counts = torch.round(frames / qscale)
        clipped.add_(((counts < 0) | (counts > U16_MAX)).sum())
        counts.clamp_(0, U16_MAX)
        return torch.where(counts > 32767, counts - 65536,
                           counts).to(torch.int16)

    def drain(p):
        nonlocal write_s, n_written
        i, buf, _frames, copied = p
        if copied is not None:
            copied.synchronize()
        t = time.perf_counter()
        path = his_path(pdir, i)
        data = buf.numpy().view(np.uint16) if u16 else buf.numpy()
        write_his(path + ".tmp", data, number_dtype=np.dtype(number_type))
        os.replace(path + ".tmp", path)
        write_s += time.perf_counter() - t
        n_written += buf.shape[0]

    n_done = 0                    # batches computed: picks the host buffer
    for i in range(0, n_proj, BATCH):
        n = min(BATCH, n_proj - i)
        if whole_his(his_path(pdir, i), n, number_type):
            continue
        buf = host[n_done % 2][:n]
        n_done += 1
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            frames = project(i, n)
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
            frames = project(i, n)
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
    n_clipped = int(clipped)
    if n_clipped:
        raise RuntimeError(f"{n_clipped} pixels fell outside 0..{U16_MAX} "
                           f"counts at {qscale} per count")
    scan_map = {"number_type": number_type, "scale": qscale, "offset": 0.0,
                "n_proj": n_proj, "clipped": n_clipped,
                "line_integral_bound": qscale * U16_MAX if u16 else None}
    _write_atomic(os.path.join(pdir, MAP_FILE), json.dumps(scan_map))
    _write_atomic(os.path.join(pdir, DONE_MARKER), str(n_proj))
    seconds = time.perf_counter() - t0
    ms = [s.elapsed_time(e) for s, e in card_ms]
    print(f"[synth] done: {n_written} {number_type} frames written in "
          f"{seconds:.1f} s ({write_s:.1f} s of disk writes)", flush=True)
    return {"frames_written": n_written, "map": scan_map, "seconds": seconds,
            "write_seconds": write_s,
            "card_ms_per_batch": float(np.median(ms)) if ms else None,
            "card_seconds": sum(ms) / 1e3 if ms else None}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--n-proj", type=int, default=N_PROJ)
    ap.add_argument("--number-type", default="float32", choices=NUMBER_TYPES)
    args = ap.parse_args(argv)
    return synthesize(args.workdir, config5(args.n_proj), args.n_proj,
                      number_type=args.number_type)


if __name__ == "__main__":
    main()
