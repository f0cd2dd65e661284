"""Single-device FDK reconstruction pipeline (port of
``paris_tpu/pipeline.py``).

Projections are processed in fixed-size chunks: a chunk is staged to
the device (per-frame affine u16 in fast mode, float32 in exact mode),
cut to the detector-row band the block samples, dequantized,
cosine-weighted and ramp-filtered as one batch, then backprojected into
a resident volume block, which is updated in place (the JAX package
donated it).  Chunks are staged on worker threads
(``stage_stream``) so host quantization and host-to-device copies
overlap the device's work on earlier chunks.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .geometry import DetectorGeometry, VolumeGeometry, detector_row_band
from .ops.weighting import weight_map
from .ops.filtering import ramp_filter_spectrum, filter_projections
from .ops.backprojection_torch import make_bp_grid
from .ops.backprojection_cuda import backproject_chunk

__all__ = ["Reconstructor", "reconstruct", "preprocess_chunk",
           "dequantize_chunk", "quantize_chunk_u16", "identity_qparams",
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


def identity_qparams(pad_to: int) -> np.ndarray:
    """(pad_to, 2) qparams that make dequantize_chunk the identity.

    Copied from ``paris_tpu/pipeline.py:identity_qparams``."""
    qp = np.zeros((pad_to, 2), np.float32)
    qp[:, 0] = 1.0
    return qp


# concurrent staging workers (stage_stream default); the native
# quantizer divides its thread budget by this
_STAGE_WORKERS = 2


def stage_stream(stage_fn, pairs, *, depth: int = 3,
                 workers: int = _STAGE_WORKERS):
    """Run ``stage_fn(data, angles)`` on a thread pool, keeping up to
    ``depth`` staged chunks in flight; yields ``(staged, n)`` in order.

    Copied from ``paris_tpu/pipeline.py:stage_stream``.  The consumer
    thread only enqueues steps; quantization and host-to-device copies
    run on the workers.
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
                staged = fut.result()
                nxt = next(pairs, None)
                if nxt is not None:
                    futs.append(
                        (ex.submit(stage_fn, nxt[0], nxt[1]), len(nxt[1])))
                yield staged, n
        finally:
            for fut, _ in futs:
                fut.cancel()


def resolve_backend(backend: str, device=None) -> Tuple[str, torch.device]:
    """(backend, device) for a requested backend.

    ``cuda`` runs the hand-written kernel on a card and raises when there
    is none; ``torch`` runs the plain version on the CPU; ``auto`` is
    ``cuda`` when ``torch.cuda.is_available()``, else ``torch``.
    """
    if backend == "auto":
        backend = "cuda" if torch.cuda.is_available() else "torch"
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("backend 'cuda' needs a CUDA device, and "
                             "torch.cuda.is_available() is False")
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
    pass; ``block_shape`` the (dz, ny, nx) accumulator.  ``accuracy``:
    "exact" stages and backprojects float32 projections; "fast" stages
    per-frame affine u16 (half the host-to-device bytes) and hands the
    filtered chunk to the kernel as bf16, with float32 arithmetic in the
    kernel.  ``v_band_width``: weight, filter and backproject only that
    many detector rows per step, the band a block of ``block_shape[0]``
    slices samples (``_v_band_lo``); None = the whole detector.
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

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        # pinned host copy + asynchronous h2d; PyTorch's pinned allocator
        # records an event per copy, so the pinned buffer is not reused
        # before its copy has finished
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- public API ---------------------------------------------------------

    def init_block(self) -> torch.Tensor:
        return torch.zeros(self.block_shape, dtype=torch.float32,
                           device=self.device)

    def stage_chunk(self, chunk, ang):
        """Start the host-to-device copy of one (chunk, angles) pair.

        Returns the (chunk, sin, cos, qparams) tensors ``step_staged``
        consumes; keep them referenced until that step is enqueued.
        """
        C = self.chunk_size
        chunk = np.asarray(chunk, dtype=np.float32)
        ang = np.asarray(ang, dtype=np.float32)
        if ang.shape[0] < C:
            ang = np.pad(ang, (0, C - ang.shape[0]))
        if self.accuracy == "fast":
            chunk, qparams = quantize_chunk_u16(
                chunk, C, concurrency=_STAGE_WORKERS)
        else:
            qparams = identity_qparams(C)
            if chunk.shape[0] < C:
                chunk = np.pad(
                    chunk, ((0, C - chunk.shape[0]), (0, 0), (0, 0)))
        phi = np.deg2rad(ang).astype(np.float32)
        return tuple(self._put(a) for a in
                     (chunk, np.sin(phi), np.cos(phi), qparams))

    def _filter_band(self, chunk: torch.Tensor, qparams: torch.Tensor,
                     z0_global: int) -> Tuple[torch.Tensor, int]:
        """Staged (n, n_col, n_row) frames -> (the band's rows, dequantized,
        weighted and ramp-filtered, in the kernel's dtype; the band's first
        detector row).  Dequantization and weighting are elementwise and
        the filter runs along each detector row, so cutting the band first
        gives the rows that cutting last would."""
        v_lo = self._v_band_lo(z0_global)
        rows = slice(v_lo, v_lo + self._vp)
        filtered = preprocess_chunk(
            dequantize_chunk(chunk[:, rows], qparams), self._weights[rows],
            self._spectrum, self.det.n_row)
        dtype = torch.bfloat16 if self.accuracy == "fast" else torch.float32
        return filtered.to(dtype).contiguous(), v_lo

    def step_staged(self, volume: torch.Tensor, staged, *,
                    z_offset: int = 0,
                    roi_offset: Tuple[int, int, int] = (0, 0, 0)
                    ) -> torch.Tensor:
        """Accumulate one staged chunk into ``volume`` IN PLACE."""
        chunk, sin, cos, qparams = staged
        rx1, ry1, rz1 = roi_offset
        filtered, v_lo = self._filter_band(chunk, qparams, rz1 + z_offset)
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
