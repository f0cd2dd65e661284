"""Projection source: streams HIS frames from a scan directory.

Replaces the reference ``source`` class (src/source.cpp:75-135) with an
iterator design:

  * the directory is scanned once, sorted (reference filesystem.cpp:65);
  * multi-frame files are flattened into a single global frame stream;
  * ``quality`` decimation keeps every q-th frame (source.cpp:105);
  * each kept frame carries its GLOBAL index and angle — computed from
    the per-source position, not a thread-local counter (fixing the
    reference's index-leak bug, SURVEY.md §5 bug 3);
  * unreadable / non-HIS files are skipped with a warning (source.cpp:97-100);
  * a background prefetch thread (``prefetch`` > 0) overlaps disk reads
    with device compute — the TPU analog of the reference's pipelined
    h2d loader stage.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .his import read_his, read_his_header, read_his_selective, HisFormatError
from .angles import read_angles
from ..exceptions import StageConstructionError

logger = logging.getLogger("paris_tpu_torch.io")

__all__ = ["Projection", "ProjectionSource", "scan_directory"]


@dataclasses.dataclass
class Projection:
    data: Optional[np.ndarray]  # (n_col, n_row) f32; None = not decoded
    idx: int              # global projection index (pre-decimation numbering)
    phi: float            # angle in degrees


def scan_directory(path: str, extensions: Sequence[str] = (".his",)) -> List[str]:
    """Sorted list of projection files in a directory."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"projection directory not found: {path}")
    names = sorted(
        n for n in os.listdir(path)
        if os.path.isfile(os.path.join(path, n))
        and (not extensions or os.path.splitext(n)[1].lower() in extensions)
    )
    return [os.path.join(path, n) for n in names]


class ProjectionSource:
    """Iterator over decimated, angle-tagged projections."""

    def __init__(
        self,
        proj_dir: str,
        *,
        angle_file: Optional[str] = None,
        delta_phi: float = 0.0,
        quality: int = 1,
        prefetch: int = 4,
        extensions: Sequence[str] = (".his",),
        slot_filter=None,
    ):
        """``slot_filter``: optional predicate on the POST-decimation
        stream position.  Frames whose position it rejects are yielded
        with ``data=None`` and their pixel decode is SKIPPED entirely
        (``read_his_selective``) — the multi-host disjoint-read path:
        each host decodes only the frames of its chunk shard, so input
        decode bandwidth scales with host count (the reference decoded
        the whole stream on every worker, src/source.cpp:88-130)."""
        if quality < 1:
            raise ValueError("quality must be >= 1")
        self.paths = scan_directory(proj_dir, extensions)
        self.quality = quality
        self.delta_phi = float(delta_phi)
        self.angles = read_angles(angle_file) if angle_file else None
        self.prefetch = prefetch
        self.slot_filter = slot_filter
        if self.angles is not None:
            # a SHORT angle table is an error, not a silent fallback:
            # the reference reads exactly one angle per projection
            # (src/source.cpp:107-110) — falling back to idx*delta_phi
            # past the table's end would mix two angle conventions
            # mid-stream with no warning (r4 verdict 5).  Cheap check:
            # 68-byte header reads only; unreadable files are skipped
            # here exactly as the stream skips them later.
            total = 0
            for p in self.paths:
                try:
                    total += read_his_header(p).frame_number
                except (HisFormatError, OSError):
                    continue
            if total > len(self.angles):
                raise StageConstructionError(
                    f"angle file {angle_file} has {len(self.angles)} "
                    f"entries but the projection stream has {total} "
                    f"frames (pre-decimation); refusing to mix "
                    f"table angles with idx*delta_phi")

    def _angle(self, idx: int) -> float:
        if self.angles is None:
            return idx * self.delta_phi
        if idx >= len(self.angles):
            # backstop for streams that grew PAST the construction-time
            # count (e.g. a file whose header read failed then became
            # readable): never mix table angles with idx*delta_phi
            from ..exceptions import StageRuntimeError
            raise StageRuntimeError(
                f"projection stream reached index {idx} but the angle "
                f"table has only {len(self.angles)} entries")
        return float(self.angles[idx])

    def _kept_before(self, idx: int) -> int:
        """Number of kept (post-decimation) frames among indices [0, idx)."""
        return -(-idx // self.quality)

    def _iter_frames(self) -> Iterator[Projection]:
        idx = 0
        # the selective reader decodes ONLY wanted frames: required for
        # disjoint multi-host reads (slot_filter) and a q-fold decode
        # saving under quality decimation (the full reader decodes every
        # frame of a file just to drop q-1 of q).  It is single-threaded
        # Python, though, so with the THREADED native decoder available
        # it only wins when decimation skips most frames — keep native
        # full-decode for small q (measured crossover ~q=4 on few-core
        # hosts; decoding 1/2 the frames at ~1/3 the rate loses)
        from .native import available as _native_available
        selective = self.slot_filter is not None or (
            self.quality > 1
            and (self.quality >= 4 or not _native_available()))
        for path in self.paths:
            try:
                if not selective:
                    frames = read_his(path)
                    n = frames.shape[0]
                else:
                    idx0 = idx

                    def want(j: int) -> bool:
                        gi = idx0 + j
                        if gi % self.quality:
                            return False       # decimated away
                        if self.slot_filter is None:
                            return True
                        return self.slot_filter(self._kept_before(gi))

                    n, frames = read_his_selective(path, want)
            except (HisFormatError, OSError) as e:
                logger.warning("skipping invalid file %s: %s", path, e)
                continue
            for j in range(n):
                if idx % self.quality == 0:
                    frame = frames[j] if not selective else frames.get(j)
                    yield Projection(
                        data=(None if frame is None else
                              np.ascontiguousarray(frame, dtype=np.float32)),
                        idx=idx,
                        phi=self._angle(idx),
                    )
                idx += 1

    def __iter__(self) -> Iterator[Projection]:
        if self.prefetch <= 0:
            yield from self._iter_frames()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()
        err: List[BaseException] = []

        def _put(item) -> bool:
            # bounded-wait put so an abandoned consumer (exception in
            # the reconstruct loop, generator closed mid-stream) cannot
            # leave this thread blocked forever with an open file
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for p in self._iter_frames():
                    if not _put(p):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                _put(_END)

        t = threading.Thread(target=worker, daemon=True, name="his-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield item
        finally:
            stop.set()
            while True:          # unblock a pending put, then reap
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
        if err:
            raise err[0]

    def iter_chunks(self, chunk_size: int) -> Iterator[List[Projection]]:
        """Yield lists of up to ``chunk_size`` projections."""
        buf: List[Projection] = []
        for p in self:
            buf.append(p)
            if len(buf) == chunk_size:
                yield buf
                buf = []
        if buf:
            yield buf
