"""Single-device FDK reconstruction pipeline (port of
``paris_tpu/pipeline.py``).

Projections are processed in fixed-size chunks.  ``stage_chunk`` fills a
slot of a ring of pinned host buffers with a chunk's frames in the type
they were stored in (u8, u16 or f32; a ``ChunkRead`` reads them from the
HIS files straight into the slot) and copies it to the card on a copy
stream of its own; the step that consumes it waits on that copy's event
alone.  ``step_staged`` then, on the card: converts the frames to float32,
in fast mode takes them through the per-frame affine u16 quantization of
the JAX package's host (bit for bit ``paris_quantize_u16``), cuts the
detector-row band the block samples, dequantizes, cosine-weights and
ramp-filters it as one batch, and backprojects it into a resident volume
block, which is updated in place (the JAX package donated it).  Chunks
are staged on worker threads (``stage_stream``), so reads and copies
overlap the card's work on earlier chunks.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import os
import threading
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .geometry import DetectorGeometry, VolumeGeometry, detector_row_band
from .ops.weighting import weight_map
from .ops.filtering import ramp_filter_spectrum, filter_projections
from .ops.backprojection_torch import make_bp_grid
from .ops.backprojection_cuda import backproject_chunk
from .io.source import ChunkRead
from .utils.profiling import count, span

__all__ = ["Reconstructor", "reconstruct", "preprocess_chunk",
           "dequantize_chunk", "quantize_chunk_u16", "identity_qparams",
           "quantize_u16_torch", "u16_round_trip", "Staged", "ArrayRows",
           "stage_stream", "resolve_backend", "from_jax_state",
           "to_jax_state"]


def preprocess_chunk(chunk: torch.Tensor, weights: torch.Tensor,
                     spectrum: torch.Tensor, n_row: int) -> torch.Tensor:
    """Weight and ramp-filter a (C, n_col, n_row) float32 chunk."""
    return filter_projections(chunk * weights, spectrum, n_row)


def dequantize_chunk(chunk: torch.Tensor, qparams: torch.Tensor
                     ) -> torch.Tensor:
    """Per-frame affine dequant: (C, ...) x (C, 2) [scale, lo] -> f32."""
    return (chunk.to(torch.float32) * qparams[:, 0, None, None]
            + qparams[:, 1, None, None])


def quantize_chunk_u16(chunk: np.ndarray, pad_to: int, *,
                       concurrency: int = 1):
    """Per-frame affine-u16 wire quantization of an unpadded (n, V, H)
    chunk; returns (u16 chunk padded to ``pad_to`` frames, (pad_to, 2)
    f32 qparams rows [scale, lo]).  Padded tail frames get scale=0,
    lo=0 and dequantize to exact zeros.

    Copied from ``paris_tpu/pipeline.py:quantize_chunk_u16``, whose module
    imports JAX; it uses the same native quantizer when it is built.
    ``concurrency`` is how many of these calls run at once (the native
    quantizer's thread budget is cpu_count/concurrency).
    """
    n = chunk.shape[0]
    q = np.empty((pad_to,) + chunk.shape[1:], np.uint16)
    qparams = np.zeros((pad_to, 2), np.float32)
    from .io import native
    if native.quantize_u16_available() and chunk.flags.c_contiguous:
        native.quantize_u16(chunk, q, qparams, n_threads=max(
            1, (os.cpu_count() or 1) // max(1, concurrency)))
    else:
        lo = chunk.min(axis=(1, 2))
        scale = (chunk.max(axis=(1, 2)) - lo) / 65535.0
        scale[scale <= 0.0] = 1.0
        np.rint((chunk - lo[:, None, None]) * (1.0 / scale)[:, None, None],
                casting="unsafe", out=q[:n])
        qparams[:n, 0] = scale
        qparams[:n, 1] = lo
    q[n:] = 0
    return q, qparams


# The native quantizer's int32 conversion of a rounded code: the x86
# conversion of a value at or past 2^31 (or NaN) is INT_MIN, whose low 16
# bits are 0; below it, the code wraps modulo 2^16 (uint16 of int32).
_INT32_LIMIT = 2.0 ** 31


def _u16_params(frames: torch.Tensor, n: int) -> torch.Tensor:
    """(C, 2) float32 rows [scale, lo] of the per-frame affine u16
    quantization of (C, ...) float32 ``frames``, the first ``n`` of them
    data: lo and hi are a frame's min and max, scale = (hi - lo) / 65535
    by true division (a tensor divisor: ATen's CUDA division by a scalar
    multiplies by its reciprocal), 1 for a constant frame; frames from
    ``n`` on (padding) get (0, 0).  ``paris_quantize_u16`` bit for bit."""
    flat = frames.reshape(frames.shape[0], -1)
    lo, hi = flat.amin(dim=1), flat.amax(dim=1)
    scale = (hi - lo) / torch.full_like(lo, 65535.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    qparams = torch.stack([scale, lo], dim=1)
    qparams[n:] = 0
    return qparams


def _u16_codes(frames: torch.Tensor, qparams: torch.Tensor) -> torch.Tensor:
    """int32 codes in [0, 65535] of ``frames`` (C, ...) under ``qparams``:
    rint((x - lo) * (1 / scale)), half to even, each operation rounded on
    its own (separate kernels: no FMA can fuse them), then the native
    quantizer's uint16(int32(.)); 0 where scale is 0 (padding)."""
    scale, lo = qparams[:, 0], qparams[:, 1]
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale,
                      torch.zeros_like(scale))
    shape = (-1,) + (1,) * (frames.dim() - 1)
    r = torch.round((frames - lo.view(shape)) * inv.view(shape))
    r = torch.where(r < _INT32_LIMIT, r, torch.zeros_like(r))
    return r.to(torch.int32).bitwise_and_(0xFFFF)


def quantize_u16_torch(frames: torch.Tensor, n: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 codes, (C, 2) qparams) of the per-frame affine u16
    quantization of (C, V, H) float32 ``frames`` on their device, the
    first ``n`` (default all) of them data: ``quantize_chunk_u16`` of
    ``frames[:n]`` padded to C, bit for bit, codes and qparams (the codes
    as int32)."""
    qparams = _u16_params(frames, frames.shape[0] if n is None else n)
    return _u16_codes(frames, qparams), qparams


def u16_round_trip(frames: torch.Tensor, qparams: torch.Tensor
                   ) -> torch.Tensor:
    """float32 ``frames`` through the u16 wire and back:
    ``dequantize_chunk`` of their codes under ``qparams``, what the JAX
    package's fast mode computes from a frame quantized on its host.
    ``launches`` counts the calls on the card."""
    if frames.is_cuda:
        u16_round_trip.launches += 1
    return dequantize_chunk(_u16_codes(frames, qparams), qparams)


u16_round_trip.launches = 0


def identity_qparams(pad_to: int) -> np.ndarray:
    """(pad_to, 2) qparams that make dequantize_chunk the identity.

    Copied from ``paris_tpu/pipeline.py:identity_qparams``."""
    qp = np.zeros((pad_to, 2), np.float32)
    qp[:, 0] = 1.0
    return qp


# concurrent staging workers (stage_stream default); the raw HIS reader
# and the native quantizer divide their thread budget by this
_STAGE_WORKERS = 2


# staging slots per chunk shape: stage_stream keeps at most depth + 1
# chunks pending, so a slot comes round again only after its chunk has
# been consumed
_RING_SLOTS = 4


def stage_stream(stage_fn, pairs, *, depth: int = 3,
                 workers: int = _STAGE_WORKERS, timers=None):
    """Run ``stage_fn(data, angles)`` on a thread pool, keeping up to
    ``depth`` staged chunks in flight; yields ``(staged, n)`` in order.

    Copied from ``paris_tpu/pipeline.py:stage_stream``.  The consumer
    thread only enqueues steps; reads and host-to-device copies run on the
    workers.  ``timers`` (a ``StageTimers``) gets the consumer's seconds
    waiting on a staged chunk as "stage_wait".
    """
    with concurrent.futures.ThreadPoolExecutor(
            workers, thread_name_prefix="paris-stage") as ex:
        pairs = iter(pairs)
        futs: collections.deque = collections.deque()
        try:
            for data, ang in itertools.islice(pairs, depth):
                futs.append((ex.submit(stage_fn, data, ang), len(ang)))
            while futs:
                fut, n = futs.popleft()
                with span("stage_wait", timers=timers):
                    staged = fut.result()
                nxt = next(pairs, None)
                if nxt is not None:
                    futs.append(
                        (ex.submit(stage_fn, nxt[0], nxt[1]), len(nxt[1])))
                yield staged, n
        finally:
            for fut, _ in futs:
                fut.cancel()


class Staged(NamedTuple):
    """A chunk on the reconstructor's device, as ``step_staged`` consumes
    it: ``chunk`` (C, n_col, n_row) in its raw type (float32, uint8, or
    int16 holding u16 bits), the angles' ``sin`` and ``cos``, ``n`` the
    frames that are data (the rest are zero padding), ``ready`` the event
    of its host-to-device copy (None: nothing to wait for), and ``host``,
    when the stage was asked to keep one, the chunk's rows in host memory
    with its angles: an (``ArrayRows``, angles) pair to stage again."""
    chunk: torch.Tensor
    sin: torch.Tensor
    cos: torch.Tensor
    n: int
    ready: Optional["torch.cuda.Event"] = None
    host: Optional[Tuple["ArrayRows", np.ndarray]] = None


_RAW_TYPES = {np.dtype(np.float32): torch.float32,
              np.dtype(np.uint8): torch.uint8,
              np.dtype(np.uint16): torch.int16}   # u16 bits, 2 B/px


def _raw_array(a) -> np.ndarray:
    """An array of frames in a type the card converts (u8, u16, f32);
    any other type becomes float32 on the host."""
    a = np.asarray(a)
    return a if a.dtype in _RAW_TYPES else a.astype(np.float32)


class ArrayRows:
    """Frames in host memory as rows [row0, row0 + len(array)) of a chunk
    of ``rows`` frames, read like a ``ChunkRead``: ``read_into(out, lo,
    hi)`` copies rows [lo, hi) (clipped to ``rows``) into ``out`` and
    zeroes the ones it does not hold."""

    def __init__(self, array: np.ndarray, row0: int = 0,
                 rows: Optional[int] = None):
        self.array = _raw_array(array)
        self.row0 = row0
        self.rows = row0 + len(self.array) if rows is None else rows
        self.dtype = self.array.dtype

    def read_into(self, out: np.ndarray, lo: int = 0,
                  hi: Optional[int] = None) -> None:
        hi = self.rows if hi is None else min(hi, self.rows)
        a = max(lo, self.row0)
        b = max(a, min(hi, self.row0 + len(self.array)))
        out[:max(0, a - lo)] = 0
        out[a - lo:b - lo] = self.array[a - self.row0:b - self.row0]
        out[b - lo:max(0, hi - lo)] = 0


def _as_float32(chunk: torch.Tensor) -> torch.Tensor:
    """A staged chunk's frames as float32 (exact for u8 and u16)."""
    if chunk.dtype == torch.float32:
        return chunk
    if chunk.dtype == torch.int16:         # u16 bits
        return chunk.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32)
    return chunk.to(torch.float32)


class _Slot:
    """One staging buffer: ``frames`` (a chunk's raw frames) and ``trig``
    (its sines and cosines), pinned when ``pinned``; ``event`` is the copy
    that last used it (the drain's copies write it), ``lock`` held from
    its hand-out to the end of its use (its copy; for the drain, its
    pwrite)."""

    def __init__(self, shape, dtype, pinned: bool):
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
        self.frames = self.buf.numpy().view(dtype).reshape(shape)
        self.trig_t = torch.empty((2, shape[0]), dtype=torch.float32,
                                  pin_memory=pinned)
        self.trig = self.trig_t.numpy()
        self.event = None
        self.lock = threading.Lock()


class _Ring:
    """Preallocated pinned staging slots per (chunk shape, raw type),
    handed out round robin.  A slot is handed out again only after the
    copy that last read it has finished (its event), so the ring replaces
    a pinned copy per chunk."""

    def __init__(self, n_slots: int = _RING_SLOTS):
        self.n_slots = n_slots
        self._lock = threading.Lock()
        self._rings = {}

    def acquire(self, shape, dtype) -> _Slot:
        """A slot, its lock held (released once its copy is enqueued),
        after the copy that last read it has finished."""
        key = (tuple(shape), np.dtype(dtype))
        with self._lock:
            ring, k = self._rings.get(key, ([], 0))
            self._rings[key] = (ring, k + 1)
            if len(ring) < self.n_slots:
                ring.append(_Slot(shape, dtype, pinned=True))
            slot = ring[k % self.n_slots]
        slot.lock.acquire()
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    @property
    def nbytes(self) -> int:
        """Pinned bytes of the slots allocated so far."""
        with self._lock:
            return sum(slot.buf.numel() + 4 * slot.trig_t.numel()
                       for ring, _ in self._rings.values() for slot in ring)


def resolve_backend(backend: str, device=None) -> Tuple[str, torch.device]:
    """(backend, device) for a requested backend.

    ``cuda`` runs the hand-written kernel on a card and raises when there
    is none; ``torch`` runs the plain version on the CPU; ``auto`` is
    ``cuda``: a job never moves to the CPU unless it asks for ``torch``.
    """
    requested = backend
    if backend == "auto":
        backend = "cuda"
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                f"backend {requested!r} needs a CUDA device, and "
                "torch.cuda.is_available() is False; ask for the CPU with "
                "--backend torch (backend='torch')")
        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' cannot run on {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif backend == "torch":
        device = torch.device("cpu" if device is None else device)
        if device.type != "cpu":
            raise ValueError(f"backend 'torch' runs on the CPU, not {device}")
    else:
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected 'auto', 'cuda' or 'torch')")
    return backend, device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def from_jax_state(vol_yxz: np.ndarray, shape_zyx: Tuple[int, int, int],
                   device) -> torch.Tensor:
    """JAX Pallas accumulator (ny, nxp, nzp), x and z padded to 128
    (``backprojection_pallas.to_kernel_layout``) -> this package's
    (dz, ny, nx) float32 accumulator on ``device``."""
    dz, ny, nx = shape_zyx
    a = np.asarray(vol_yxz, np.float32)[:ny, :nx, :dz].transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_jax_state(volume: torch.Tensor) -> np.ndarray:
    """(dz, ny, nx) accumulator -> the JAX Pallas layout (ny, nxp, nzp)
    with x and z zero-padded to 128."""
    dz, ny, nx = volume.shape
    out = np.zeros((ny, _round_up(nx, 128), _round_up(dz, 128)), np.float32)
    out[:, :nx, :dz] = volume.detach().cpu().numpy().transpose(1, 2, 0)
    return out


class Reconstructor:
    """Single-device FDK for one (det, vol) geometry.

    ``chunk_size`` is the number of projections accumulated per volume
    pass; ``block_shape`` the (dz, ny, nx) accumulator.  Chunks are
    staged in their stored type.  ``accuracy``: "exact" backprojects the
    float32 projections; "fast" takes each frame through the per-frame
    affine u16 quantization of the JAX package's host, on the device,
    and hands the filtered chunk to the kernel as bf16, with float32
    arithmetic in the kernel.  ``v_band_width``: weight, filter and
    backproject only that many detector rows per step, the band a block
    of ``block_shape[0]`` slices samples (``_v_band_lo``); None = the
    whole detector.
    """

    def __init__(
        self,
        det: DetectorGeometry,
        vol: VolumeGeometry,
        *,
        chunk_size: int = 16,
        block_shape: Optional[Tuple[int, int, int]] = None,  # (dz, ny, nx)
        backend: str = "auto",
        accuracy: str = "exact",
        device=None,
        v_band_width: Optional[int] = None,
    ):
        if accuracy not in ("exact", "fast"):
            raise ValueError(f"accuracy must be 'exact' or 'fast', "
                             f"got {accuracy!r}")
        if int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.backend, self.device = resolve_backend(backend, device)
        self.det = det
        self.vol = vol
        self.accuracy = accuracy
        self.chunk_size = int(chunk_size)
        self.block_shape = tuple(block_shape or vol.shape_zyx)
        self.grid = make_bp_grid(det, vol)
        # band rows per step: exactly the requested width (the JAX package
        # rounded it up to 128 for the TPU's tiling)
        self._vp = det.n_col if v_band_width is None else \
            min(det.n_col, int(v_band_width))
        self._weights = weight_map(det, self.device)
        self._spectrum = ramp_filter_spectrum(det.n_row, det.l_px_row,
                                              self.device)
        # the chunk slots this process stages: all of them here, a rank's
        # own in DistributedReconstructor
        self._stage_rows = (0, self.chunk_size)
        self._identity = {}
        if self.device.type == "cuda":
            self._ring = _Ring()
            self._copy_stream = torch.cuda.Stream(self.device)

    # -- chunk iteration ----------------------------------------------------

    def _chunks(self, projections, angles_deg) -> Iterator[Tuple[np.ndarray,
                                                                 np.ndarray]]:
        """Yield fixed-size (chunk, angles) pairs, zero-padding the tail.

        Zero-padded projections contribute nothing (the filter of zeros
        is zero), so padding keeps every step the same shape.
        """
        C = self.chunk_size
        for i in range(0, len(angles_deg), C):
            chunk = np.asarray(projections[i:i + C], dtype=np.float32)
            ang = np.asarray(angles_deg[i:i + C], dtype=np.float32)
            if chunk.shape[0] < C:
                pad = C - chunk.shape[0]
                chunk = np.pad(chunk, ((0, pad), (0, 0), (0, 0)))
                ang = np.pad(ang, (0, pad))
            yield chunk, ang

    def _v_band_lo(self, z0_global: int) -> int:
        """First detector row of the band for the block at global z0
        (port of ``paris_tpu/pipeline.py:Reconstructor._v_band_lo``)."""
        n_col = self.det.n_col
        if self._vp >= n_col:
            return 0
        lo, hi = detector_row_band(self.det, self.vol, z0_global,
                                   self.block_shape[0])
        if hi - lo > self._vp:
            raise ValueError(
                f"v_band_width {self._vp} too narrow for block at "
                f"z={z0_global} (needs {hi - lo} rows)")
        return max(0, min(lo, n_col - self._vp))

    def _slot(self, shape, dtype) -> _Slot:
        """A staging slot: a pinned ring slot on the card (locked until its
        copy is enqueued), new host arrays on the CPU (the staged tensors
        are their memory)."""
        if self.device.type == "cuda":
            return self._ring.acquire(shape, dtype)
        slot = _Slot(shape, dtype, pinned=False)
        slot.lock.acquire()
        return slot

    def _put(self, slot: _Slot, n: int, host) -> Staged:
        """``slot`` on the device: on the card a copy on the copy stream,
        then an event the step waits on and the slot's next use waits for;
        on the CPU the slot's own memory."""
        shape = slot.frames.shape
        dtype = _RAW_TYPES[slot.frames.dtype]
        try:
            if self.device.type != "cuda":
                return Staged(slot.buf.view(dtype).view(shape),
                              slot.trig_t[0], slot.trig_t[1], n, None, host)
            with torch.cuda.stream(self._copy_stream), \
                    span("h2d", device=True):
                dev = torch.empty(slot.buf.shape, dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(slot.buf, non_blocking=True)
                trig = torch.empty(slot.trig_t.shape, dtype=torch.float32,
                                   device=self.device)
                trig.copy_(slot.trig_t, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            count("h2d_bytes", slot.buf.numel() + 4 * slot.trig_t.numel())
            slot.event = ready
            return Staged(dev.view(dtype).view(shape), trig[0], trig[1], n,
                          ready, host)
        finally:
            slot.lock.release()

    # -- public API ---------------------------------------------------------

    def init_block(self) -> torch.Tensor:
        return torch.zeros(self.block_shape, dtype=torch.float32,
                           device=self.device)

    def stage_chunk(self, chunk, ang, *, timers=None,
                    keep: bool = False) -> Staged:
        """Stage one (chunk, angles) pair: this process's rows of the chunk
        into a staging slot, in their raw type, then to the device.

        ``chunk`` is an array of frames (u8, u16 and f32 kept, any other
        type made float32), or anything with ``rows``, ``dtype`` and
        ``read_into(out, lo, hi)``: a ``ChunkRead`` reads its frames from
        the HIS files straight into the slot, an ``ArrayRows`` copies
        them.  ``timers`` gets the fill's seconds as "read" (a span); the
        bytes a ``ChunkRead`` reads from the files count as
        "his_bytes_read"; ``keep`` asks for the rows in host memory too
        (``Staged.host``).  Keep the result referenced until its step is
        enqueued.
        """
        data = chunk if hasattr(chunk, "read_into") else ArrayRows(chunk)
        lo, hi = self._stage_rows
        n = max(0, min(hi, data.rows) - lo)
        given = ang = np.asarray(ang, dtype=np.float32)
        if ang.shape[0] < self.chunk_size:
            ang = np.pad(ang, (0, self.chunk_size - ang.shape[0]))
        phi = np.deg2rad(ang[lo:hi]).astype(np.float32)
        slot = self._slot((hi - lo, self.det.n_col, self.det.n_row),
                          data.dtype)
        try:
            with span("read", timers=timers):
                data.read_into(slot.frames, lo, hi)
                slot.frames[n:] = 0
            if isinstance(data, ChunkRead):
                count("his_bytes_read", data.file_bytes(lo, hi))
            slot.trig[0] = np.sin(phi)
            slot.trig[1] = np.cos(phi)
            host = None
            if keep:
                rows = slot.frames[:n]
                host = (ArrayRows(rows.copy() if self.device.type == "cuda"
                                  else rows, lo, data.rows), given)
        except BaseException:
            slot.lock.release()
            raise
        return self._put(slot, n, host)

    def _filter_band(self, chunk: torch.Tensor, n: int,
                     z0_global: int) -> Tuple[torch.Tensor, int]:
        """A staged (C, n_col, n_row) chunk, ``n`` of its frames data ->
        (the band's rows as float32 frames, in fast mode through the u16
        round trip of whole-frame qparams, dequantized, weighted and
        ramp-filtered, in the kernel's dtype; the band's first detector
        row).  Conversion, the round trip, dequantization and weighting
        are elementwise once a frame's qparams are known, and the filter
        runs along each detector row, so cutting the band first gives the
        rows that cutting last would.  Conversion, round trip and
        dequantization are the "step.prep" span, weighting, filter and
        cast "step.filter"."""
        v_lo = self._v_band_lo(z0_global)
        rows = slice(v_lo, v_lo + self._vp)
        on_card = chunk.is_cuda
        with span("step.prep", device=on_card):
            frames = _as_float32(chunk)
            if self.accuracy == "fast":
                qparams = _u16_params(frames, n)
                band = u16_round_trip(frames[:, rows], qparams)
            else:
                band = dequantize_chunk(
                    frames[:, rows], self._identity_qparams(chunk.shape[0]))
        with span("step.filter", device=on_card):
            filtered = preprocess_chunk(band, self._weights[rows],
                                        self._spectrum, self.det.n_row)
            dtype = torch.bfloat16 if self.accuracy == "fast" \
                else torch.float32
            return filtered.to(dtype).contiguous(), v_lo

    def _identity_qparams(self, c: int) -> torch.Tensor:
        if c not in self._identity:
            self._identity[c] = torch.from_numpy(identity_qparams(c)).to(
                self.device)
        return self._identity[c]

    def _ready(self, staged: Staged) -> Staged:
        """Make the current stream wait for ``staged``'s copy (that event
        alone), and tell the allocator the copy stream's tensors are used
        here."""
        if staged.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.ready)
            staged.chunk.record_stream(stream)
            staged.sin.record_stream(stream)
        return staged

    def step_staged(self, volume: torch.Tensor, staged, *,
                    z_offset: int = 0,
                    roi_offset: Tuple[int, int, int] = (0, 0, 0),
                    timers=None) -> torch.Tensor:
        """Accumulate one ``Staged`` chunk into ``volume`` IN PLACE: the
        "step" span (its host seconds into ``timers`` when given), holding
        "step.prep", "step.filter" and "step.k1"."""
        with span("step", timers=timers):
            count("steps")
            chunk, sin, cos, n = self._ready(staged)[:4]
            rx1, ry1, rz1 = roi_offset
            filtered, v_lo = self._filter_band(chunk, n, rz1 + z_offset)
            return backproject_chunk(volume, filtered, sin, cos, self.grid,
                                     z_offset=rz1 + z_offset,
                                     roi_offset=(rx1, ry1, 0), v_lo=v_lo)

    def accumulate(self, volume: torch.Tensor, projections, angles_deg, *,
                   z_offset: int = 0,
                   roi_offset: Tuple[int, int, int] = (0, 0, 0)
                   ) -> torch.Tensor:
        """Stream all projections through weight/filter/backproject."""
        for staged, _ in stage_stream(
                self.stage_chunk, self._chunks(projections, angles_deg)):
            volume = self.step_staged(volume, staged, z_offset=z_offset,
                                      roi_offset=roi_offset)
        return volume

    def finalize(self, volume: torch.Tensor) -> np.ndarray:
        """Accumulator -> (dz, ny, nx) ndarray: one device-to-host copy
        on the current stream, no transpose."""
        return volume.cpu().numpy()

    def run(self, projections, angles_deg, **kw) -> np.ndarray:
        return self.finalize(
            self.accumulate(self.init_block(), projections, angles_deg, **kw))


def reconstruct(
    det: DetectorGeometry,
    vol: VolumeGeometry,
    projections,
    angles_deg,
    *,
    chunk_size: int = 16,
    backend: str = "auto",
    z_offset: int = 0,
    roi_offset: Tuple[int, int, int] = (0, 0, 0),
    block_shape: Optional[Tuple[int, int, int]] = None,
) -> np.ndarray:
    """One-shot FDK reconstruction; returns the (dz, ny, nx) volume."""
    rec = Reconstructor(det, vol, chunk_size=chunk_size, backend=backend,
                        block_shape=block_shape)
    return rec.run(projections, angles_deg,
                   z_offset=z_offset, roi_offset=roi_offset)
