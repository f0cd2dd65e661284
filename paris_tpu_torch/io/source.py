"""Projection source: streams HIS frames from a scan directory.

Replaces the reference ``source`` class (src/source.cpp:75-135) with an
iterator design:

  * the directory is scanned once, sorted (reference filesystem.cpp:65),
    and each file's header is read once, into a file table that every
    pass over the stream reuses (a job's blocks, say);
  * multi-frame files are flattened into a single global frame stream;
  * ``quality`` decimation keeps every q-th frame (source.cpp:105);
  * each kept frame carries its GLOBAL index and angle — computed from
    the per-source position, not a thread-local counter (fixing the
    reference's index-leak bug, SURVEY.md §5 bug 3);
  * unreadable / non-HIS files are skipped with a warning (source.cpp:97-100);
  * a background prefetch thread (``prefetch`` > 0) overlaps disk reads
    with device compute — the TPU analog of the reference's pipelined
    h2d loader stage;
  * ``raw=True`` keeps the frames in the type they were stored in (u8,
    u16, f32; ``his.raw_dtype``), to be converted on the card;
  * ``chunk_reads`` plans the stream as chunks without reading it: each
    ``ChunkRead`` reads its frames straight into a caller's buffer (a
    pinned staging slot), one file's run of frames per native call.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .his import (HisFormatError, HisHeader, read_his,
                  read_his_frames, read_his_header, read_his_selective)
from .angles import read_angles
from ..exceptions import StageConstructionError

logger = logging.getLogger("paris_tpu_torch.io")

__all__ = ["Projection", "ProjectionSource", "HisFile", "ChunkRead",
           "scan_directory"]


@dataclasses.dataclass
class Projection:
    data: Optional[np.ndarray]  # (n_col, n_row) f32 (raw: as stored);
    #                             None = not decoded
    idx: int              # global projection index (pre-decimation numbering)
    phi: float            # angle in degrees


@dataclasses.dataclass(frozen=True)
class HisFile:
    """One entry of a source's file table: a path and its parsed header."""
    path: str
    header: HisHeader


def _common_dtype(dtypes) -> np.dtype:
    """The one raw type of ``dtypes``; float32 when they differ or there
    are none."""
    dtypes = set(dtypes)
    return dtypes.pop() if len(dtypes) == 1 else np.dtype(np.float32)


@dataclasses.dataclass
class ChunkRead:
    """One chunk of the stream as a read plan: ``rows`` frames (the chunk
    size, fewer at the stream's end) at angles ``phis`` (degrees);
    ``runs`` lists (file, first frame in the file, count, first row) of
    the frames to read, consecutive frames of one file in one run.  Rows
    no run covers (frames the source's ``slot_filter`` rejected) read as
    zeros.  ``dtype`` is the raw type of the runs' frames, float32 where
    they differ."""
    rows: int
    phis: np.ndarray
    runs: List[Tuple[HisFile, int, int, int]]
    dtype: np.dtype
    n_threads: int = 0

    def read_into(self, out: np.ndarray, lo: int = 0,
                  hi: Optional[int] = None) -> None:
        """Rows [lo, hi) of the chunk (clipped to ``rows``) into
        ``out[:hi - lo]`` (C-contiguous, ``dtype``), each run straight
        into its rows."""
        hi = self.rows if hi is None else min(hi, self.rows)
        uncovered = np.ones(max(0, hi - lo), bool)
        for f, first, count, row in self.runs:
            a, b = max(row, lo), min(row + count, hi)
            if a >= b:
                continue
            dst = out[a - lo:b - lo]
            if f.header.raw_dtype == out.dtype:
                read_his_frames(f.path, f.header, first + a - row, dst,
                                self.n_threads)
            else:
                dst[...] = read_his_frames(
                    f.path, f.header, first + a - row,
                    np.empty(dst.shape, f.header.raw_dtype), self.n_threads)
            uncovered[a - lo:b - lo] = False
        out[:len(uncovered)][uncovered] = 0

    def file_bytes(self, lo: int = 0, hi: Optional[int] = None) -> int:
        """Bytes of stored frames that ``read_into(out, lo, hi)`` reads
        from the files."""
        hi = self.rows if hi is None else min(hi, self.rows)
        total = 0
        for f, _, count, row in self.runs:
            n = min(row + count, hi) - max(row, lo)
            if n > 0:
                total += (n * f.header.width * f.header.height
                          * f.header.dtype.itemsize)
        return total


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
        raw: bool = False,
    ):
        """``slot_filter``: optional predicate on the POST-decimation
        stream position.  Frames whose position it rejects are yielded
        with ``data=None`` and their pixel decode is SKIPPED entirely
        (``read_his_selective``) — the multi-host disjoint-read path:
        each host decodes only the frames of its chunk shard, so input
        decode bandwidth scales with host count (the reference decoded
        the whole stream on every worker, src/source.cpp:88-130).
        ``raw``: frames in their stored type (``his.raw_dtype``), not
        float32."""
        if quality < 1:
            raise ValueError("quality must be >= 1")
        self.paths = scan_directory(proj_dir, extensions)
        self.quality = quality
        self.delta_phi = float(delta_phi)
        self.angles = read_angles(angle_file) if angle_file else None
        self.prefetch = prefetch
        self.slot_filter = slot_filter
        self.raw = raw
        # the file table: every header read once, here.  Unreadable and
        # non-HIS files, and files shorter than their header says, are
        # skipped with a warning (src/source.cpp:97-100), as a read of
        # them would be
        self.files: List[HisFile] = []
        total = 0
        for p in self.paths:
            try:
                header = read_his_header(p)
            except (HisFormatError, OSError) as e:
                logger.warning("skipping invalid file %s: %s", p, e)
                continue
            total += header.frame_number
            size = os.path.getsize(p)
            if size < header.file_bytes:
                logger.warning("skipping invalid file %s: truncated (%d of "
                               "%d bytes)", p, size, header.file_bytes)
                continue
            self.files.append(HisFile(p, header))
        if self.angles is not None:
            # a SHORT angle table is an error, not a silent fallback:
            # the reference reads exactly one angle per projection
            # (src/source.cpp:107-110) — falling back to idx*delta_phi
            # past the table's end would mix two angle conventions
            # mid-stream with no warning (r4 verdict 5).  The count is of
            # every readable header, truncated files included.
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

    @property
    def raw_dtype(self) -> np.dtype:
        """The raw type of the table's frames; float32 where they differ."""
        return _common_dtype(f.header.raw_dtype for f in self.files)

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
        for entry in self.files:
            path = entry.path
            try:
                if not selective:
                    frames = (read_his_frames(
                        path, entry.header, 0,
                        np.empty((entry.header.frame_number,
                                  entry.header.height, entry.header.width),
                                 entry.header.raw_dtype))
                        if self.raw else read_his(path))
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

                    n, frames = read_his_selective(path, want, raw=self.raw)
            except (HisFormatError, OSError) as e:
                logger.warning("skipping invalid file %s: %s", path, e)
                continue
            for j in range(n):
                if idx % self.quality == 0:
                    frame = frames[j] if not selective else frames.get(j)
                    if frame is not None and not self.raw:
                        frame = np.ascontiguousarray(frame, dtype=np.float32)
                    yield Projection(data=frame, idx=idx,
                                     phi=self._angle(idx))
                idx += 1

    def chunk_reads(self, chunk_size: int,
                    n_threads: int = 0) -> Iterator[ChunkRead]:
        """The stream as ``ChunkRead``s of ``chunk_size`` frames (the last
        one shorter), planned from the file table without reading a
        pixel: the frames ``iter_chunks`` would yield, in the same order,
        at the same angles, in their raw type.  ``n_threads`` is the
        native reader's thread budget per run."""
        rows, phis, runs, idx = 0, [], [], 0

        def chunk():
            return ChunkRead(rows, np.asarray(phis, np.float32), runs,
                             _common_dtype(f.header.raw_dtype
                                           for f, *_ in runs)
                             if runs else self.raw_dtype, n_threads)

        for entry in self.files:
            for j in range(entry.header.frame_number):
                if idx % self.quality == 0:
                    pos = self._kept_before(idx)
                    if self.slot_filter is None or self.slot_filter(pos):
                        last = runs[-1] if runs else None
                        if (last is not None and last[0] is entry
                                and last[1] + last[2] == j
                                and last[3] + last[2] == rows):
                            runs[-1] = (entry, last[1], last[2] + 1, last[3])
                        else:
                            runs.append((entry, j, 1, rows))
                    phis.append(self._angle(idx))
                    rows += 1
                    if rows == chunk_size:
                        yield chunk()
                        rows, phis, runs = 0, [], []
                idx += 1
        if rows:
            yield chunk()

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
