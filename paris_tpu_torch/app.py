"""End-to-end reconstruction job: blocks x projection stream -> ddbvf
(port of ``paris_tpu/app.py``).

  * z-blocks come from ``plan_z_blocks``, sized by a device-memory budget
    (45% of the card's free memory unless the job sets one) or a forced
    extent, padded to one uniform shape;
  * each step weights, filters and backprojects only the detector rows
    the widest block samples (``detector_row_band``);
  * per block: stream the HIS projections (or reuse the host cache of a
    previous block) through the reconstructor, then write the block at its
    global z offset and record it in the sink's resume manifest;
  * block k's device-to-host copy and ddbvf write run on a writer thread,
    on a copy stream of their own, while block k+1 reconstructs — when two
    accumulators fit the card's free memory.  Unless the extent is forced,
    it is cut so that they do.  ``PARIS_WRITE_OVERLAP=0`` turns both off.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .exceptions import (
    ParisError, StageConstructionError, StageRuntimeError,
)
from .geometry import (
    DetectorGeometry, RegionOfInterest, SubvolumeInfo, VolumeGeometry,
    apply_roi, derive_volume_geometry, detector_row_band, plan_z_blocks,
)
from .io.sink import VolumeSink
from .io.source import ProjectionSource
from .utils.logging import StageTimers, fmt_duration
from .pipeline import Reconstructor, resolve_backend, stage_stream
from .utils.profiling import ThroughputMeter, trace

logger = logging.getLogger("paris_tpu_torch.app")

__all__ = ["ReconstructionJob", "run_job"]


@dataclasses.dataclass
class ReconstructionJob:
    """One reconstruction; the same fields as
    ``paris_tpu/app.py:ReconstructionJob``."""
    det: DetectorGeometry
    input_path: str
    output_path: str
    prefix: str = "vol"
    angle_path: Optional[str] = None
    quality: int = 1
    roi: Optional[RegionOfInterest] = None
    chunk_size: int = 16
    backend: str = "auto"             # "auto" | "cuda" | "torch"
    # "fast": u16 staging and bf16 projections into the kernel (float32
    # arithmetic inside); "exact": float32 staging and projections
    accuracy: str = "fast"
    block_dz: Optional[int] = None    # force z-block extent (else budget)
    hbm_budget_bytes: Optional[int] = None   # device-memory budget per block
    cache_projections: Optional[bool] = None   # None = auto (multi-block)
    resume: bool = False
    max_cache_bytes: int = 64 << 30
    # one torch.profiler Chrome trace per block's reconstruct stage
    trace_dir: Optional[str] = None
    # Stop after computing this many NEW blocks (None = all); completed
    # blocks are durable in the sink manifest, so re-running with
    # resume=True completes the volume.
    max_blocks: Optional[int] = None


def _block_hbm_bytes(vol_geo: VolumeGeometry, dz: int) -> int:
    """Device bytes of one z-block accumulator: (dz, ny, nx) float32,
    unpadded.  Finalize is a d2h copy of this contiguous tensor, which
    makes no device copy."""
    return 4 * dz * vol_geo.dim_y * vol_geo.dim_x


def _free_hbm_bytes(device: torch.device) -> Optional[int]:
    """Memory of the card this process can still use (bytes): the free
    memory cudaMemGetInfo reports plus what PyTorch's caching allocator
    holds but does not use.  None off the card."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free + cached)


def _auto_hbm_budget(device: torch.device) -> Optional[int]:
    """Default per-block budget: 45% of the card's free memory, which
    leaves room for a second accumulator (the writer overlap) plus chunk
    buffers and FFT workspace.  None (one whole-volume block) off the
    card."""
    free = _free_hbm_bytes(device)
    if not free:
        return None
    return int(free * 0.45)


def _fits_two_blocks(vol_geo: VolumeGeometry, dz: int, proj_buffer: int,
                     free_est: Optional[int], n_shards: int = 1) -> bool:
    """Do two accumulators (+ staging) fit the free-memory estimate?  The
    estimate is one device's; ``n_shards`` cuts the block to one rank's
    share of it."""
    if free_est is None:
        return True
    return (2 * _block_hbm_bytes(vol_geo, dz) // max(1, n_shards)
            + proj_buffer <= free_est)


def _overlap_block_dz(vol_geo: VolumeGeometry, free_est: Optional[int],
                      proj_buffer: int, dz_padded: int, n_shards: int = 1,
                      align: int = 8) -> Optional[int]:
    """Largest ``align``-aligned extent below ``dz_padded`` for which two
    accumulators (+ staging) fit the free-memory estimate, so that the
    writer can drain block k while block k+1 reconstructs (port of
    ``paris_tpu/app.py:_overlap_block_dz``).  None when ``dz_padded``
    already fits, or when nothing above 128 slices does: thinner blocks
    would multiply the passes over the projection stream."""
    def fits_two(dz: int) -> bool:
        return _fits_two_blocks(vol_geo, dz, proj_buffer, free_est, n_shards)

    if fits_two(dz_padded):
        return None
    dz2 = dz_padded - align
    while dz2 > 128 and not fits_two(dz2):
        dz2 -= align
    return dz2 if dz2 > 128 else None


def _plan_write_overlap(job, vol_geo: VolumeGeometry, info: SubvolumeInfo,
                        free_est: Optional[int], fit_proj_buffer: int, *,
                        hbm_budget: Optional[int], proj_buffer: int,
                        n_shards: int = 1) -> Tuple[SubvolumeInfo, bool]:
    """(block plan, overlap?) for the writer overlap, shared by ``run_job``
    and ``run_job_distributed``.  A multi-block plan whose extent the job did not force is cut
    to the extent at which two accumulators fit (``_overlap_block_dz``);
    the overlap then runs when they fit.  ``PARIS_WRITE_OVERLAP=0`` keeps
    the plan and turns the overlap off.  ``fit_proj_buffer`` is one
    device's staging bytes, ``proj_buffer`` what the planner reserves."""
    if os.environ.get("PARIS_WRITE_OVERLAP", "1") == "0":
        return info, False
    if free_est is not None and info.num > 1 and job.block_dz is None:
        dz2 = _overlap_block_dz(vol_geo, free_est, fit_proj_buffer,
                                info.dim_z_padded, n_shards=n_shards,
                                align=8 * n_shards)
        if dz2 is not None:
            info = plan_z_blocks(vol_geo, hbm_budget_bytes=hbm_budget,
                                 proj_buffer_bytes=proj_buffer,
                                 num_shards=n_shards, block_dz=dz2)
            logger.info("z-split adjusted for write overlap: %d block(s) "
                        "of %d slices (padded)", info.num, info.dim_z_padded)
    return info, _fits_two_blocks(vol_geo, info.dim_z_padded,
                                  fit_proj_buffer, free_est, n_shards)


def _widest_band(job, full_geo: VolumeGeometry,
                 info: SubvolumeInfo) -> Optional[int]:
    """Rows of the widest detector-row band over the blocks, so that one
    band width serves every block (port of ``paris_tpu/app.py:388-406``);
    None for one block, or when the band is the whole detector."""
    if info.num < 2:
        return None
    rz1 = job.roi.z1 if job.roi else 0
    width = max(hi - lo for lo, hi in (
        detector_row_band(job.det, full_geo, b.z0 + rz1, b.dim_z_padded)
        for b in info.blocks))
    if width >= job.det.n_col:
        return None
    logger.info("detector row band: %d of %d rows per block", width,
                job.det.n_col)
    return width


def _overlap_free_est(free: Optional[int],
                      user_budget: Optional[int]) -> Optional[int]:
    """Free-memory estimate for the write-overlap gate.  A user budget
    is an absolute cap; None = no information (overlap allowed)."""
    if free is None:
        return user_budget
    est = int(free * 0.95)
    return est if user_budget is None else min(est, user_budget)


def _finish_writer(writer, pending_future, logger_) -> None:
    """Writer-thread epilogue: drain an in-flight write (never torn
    mid-block) and always join the writer thread.  On the exception path
    the write's own failure is logged rather than raised, so it cannot
    mask the original error.

    Copied from ``paris_tpu/app.py:_finish_writer``, whose module imports
    JAX."""
    in_flight_exc = sys.exc_info()[1] is not None
    try:
        if pending_future is not None:
            pending_future.result()
    except Exception:
        if not in_flight_exc:
            raise
        logger_.exception("in-flight block write also failed "
                          "during error shutdown")
    finally:
        writer.shutdown(wait=True)


def _roi_offset(job: ReconstructionJob) -> Tuple[int, int, int]:
    if job.roi is None:
        return (0, 0, 0)
    return (job.roi.x1, job.roi.y1, job.roi.z1)


def _assemble_chunk(plist, det: DetectorGeometry) -> np.ndarray:
    """Projection list -> (C, n_col, n_row) array; frames left undecoded
    (None: another rank's slots) become zero rows.

    Copied from ``paris_tpu/parallel/app.py:_assemble_chunk``, whose module
    imports JAX."""
    if all(p.data is not None for p in plist):
        return np.stack([p.data for p in plist])
    out = np.zeros((len(plist), det.n_col, det.n_row), np.float32)
    for i, p in enumerate(plist):
        if p.data is not None:
            out[i] = p.data
    return out


def _source_chunks(job: ReconstructionJob, chunk_size: int,
                   slot_filter=None):
    """(chunk, angles in degrees) pairs of the job's HIS stream.  Frames
    whose stream position ``slot_filter`` rejects are not decoded and
    come as zero rows."""
    src = ProjectionSource(job.input_path, angle_file=job.angle_path,
                           delta_phi=job.det.delta_phi, quality=job.quality,
                           slot_filter=slot_filter)
    for plist in src.iter_chunks(chunk_size):
        yield (_assemble_chunk(plist, job.det),
               np.asarray([p.phi for p in plist], np.float32))


class _ProjectionCache:
    """The host copy of the projection stream that later blocks reuse, so
    a multi-block job reads the HIS directory once.  An explicit
    ``cache_projections=True`` always collects; None collects when a
    later block will reuse it; a stream above ``max_cache_bytes`` is not
    kept."""

    def __init__(self, job: ReconstructionJob, info: SubvolumeInfo):
        self.collect = job.cache_projections is True or (
            job.cache_projections is None and info.num > 1)
        self.max_bytes = job.max_cache_bytes
        self.data: Optional[Tuple[np.ndarray, np.ndarray]] = None


@contextlib.contextmanager
def _after(ready, copy_stream):
    """Run the enclosed copies on ``copy_stream`` once it has waited for
    ``ready`` (the block's last step); on the CPU (ready None), as they
    are."""
    if ready is None:
        yield
        return
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(ready)
        yield


def _reconstruct_block(rec, job: ReconstructionJob, block, info,
                       vol_geo: VolumeGeometry, cache: _ProjectionCache,
                       timers: StageTimers, chunks, *, first: bool):
    """Accumulate the whole projection stream into a new accumulator for
    ``block``: from ``cache`` when an earlier block filled it, else from
    ``chunks()`` (pairs of (chunk, angles)), staged on worker threads.
    Returns (accumulator, an event recorded after its last step on the
    card or None, the block's ThroughputMeter)."""
    logger.info("reconstructing block %d/%d (z %d..%d)", block.index + 1,
                info.num, block.z0, block.z0 + block.dim_z - 1)
    device = rec.device
    roi = _roi_offset(job)
    volume = rec.init_block()
    # the rate counts valid voxels only (padded tail slices are compute
    # overhead, not useful updates)
    meter = ThroughputMeter(block.dim_z * vol_geo.dim_y * vol_geo.dim_x)
    with timers.time("reconstruct"), trace(job.trace_dir, device):
        if cache.data is not None:
            data, angs = cache.data
            volume = rec.accumulate(volume, data, angs, z_offset=block.z0,
                                    roi_offset=roi)
            meter.add(len(angs))
        else:
            datas, angles = [], []

            def pairs():
                # consumed on THIS thread by stage_stream; staging
                # (quantize + h2d) runs on its worker threads
                for data, angs in chunks():
                    if cache.collect:
                        datas.append(data)
                        angles.append(angs)
                        if sum(d.nbytes for d in datas) > cache.max_bytes:
                            cache.collect = False
                            datas.clear()
                            angles.clear()
                    yield data, angs

            for staged, k in stage_stream(rec.stage_chunk, pairs()):
                volume = rec.step_staged(volume, staged, z_offset=block.z0,
                                         roi_offset=roi)
                if first:
                    # time-to-first-chunk marker: the first step of a
                    # process builds the kernel
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    logger.info("first chunk accumulated")
                    first = False
                meter.add(k)
            if cache.collect and datas:
                cache.data = (np.concatenate(datas), np.concatenate(angles))
        # close the stage only when the card has finished
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
            torch.cuda.synchronize(device)
    if meter.projections == 0:
        logger.warning("no projections found in %s", job.input_path)
    return volume, ready, meter


def _log_block_done(block, meter) -> None:
    pps, gups = meter.rates()
    logger.info("block %d done (%d projections, %.1f proj/s, %.1f Gupd/s)",
                block.index, meter.projections, pps, gups)


def run_job(job: ReconstructionJob) -> str:
    """Run a full reconstruction; returns the output ddbvf path.

    Raises ``StageConstructionError`` if the pipeline cannot be built
    (bad geometry, paths or backend) and ``StageRuntimeError`` if it
    fails mid-stream — the reference's two exception tiers.
    """
    try:
        return _run_job(job)
    except (ParisError, KeyboardInterrupt):
        raise
    except (OSError, ValueError) as e:
        raise StageRuntimeError(f"reconstruction failed: {e}") from e


def _run_job(job: ReconstructionJob) -> str:
    t_start = time.perf_counter()
    timers = StageTimers()

    try:
        full_geo = derive_volume_geometry(job.det)
        backend, device = resolve_backend(job.backend)
    except ValueError as e:
        raise StageConstructionError(str(e)) from e
    logger.info("volume [vx]: %d x %d x %d, voxel %.4f mm",
                full_geo.dim_x, full_geo.dim_y, full_geo.dim_z,
                full_geo.l_vx_x)
    vol_geo = apply_roi(full_geo, job.roi) if job.roi else full_geo
    if job.roi:
        logger.info("ROI volume [vx]: %d x %d x %d",
                    vol_geo.dim_x, vol_geo.dim_y, vol_geo.dim_z)

    proj_bytes = 4 * job.det.n_row * job.det.n_col
    proj_buffer = 4 * proj_bytes * job.chunk_size
    hbm_budget = job.hbm_budget_bytes
    if hbm_budget is None:
        hbm_budget = _auto_hbm_budget(device)
        if hbm_budget is not None:
            logger.info("auto device-memory budget: %.1f GB",
                        hbm_budget / 2**30)
    try:
        info = plan_z_blocks(
            vol_geo,
            hbm_budget_bytes=hbm_budget,
            proj_buffer_bytes=proj_buffer,
            block_dz=job.block_dz,
        )
    except ValueError as e:
        raise StageConstructionError(str(e)) from e
    logger.info("z-split: %d block(s) of %d slices (padded)",
                info.num, info.dim_z_padded)
    # Overlapped finalize: block k's device-to-host copy and ddbvf write
    # run on the writer thread while block k+1 reconstructs.  It needs two
    # accumulators resident at once, so it engages only when they fit.
    free_est = _overlap_free_est(_free_hbm_bytes(device),
                                 job.hbm_budget_bytes)
    info, overlap = _plan_write_overlap(
        job, vol_geo, info, free_est, proj_buffer,
        hbm_budget=hbm_budget, proj_buffer=proj_buffer)

    try:
        sink = VolumeSink(job.output_path, job.prefix, vol_geo.dim_x,
                          vol_geo.dim_y, vol_geo.dim_z, resume=job.resume)
    except (OSError, ValueError) as e:
        raise StageConstructionError(f"cannot open sink: {e}") from e

    try:
        rec = Reconstructor(
            job.det, full_geo, chunk_size=job.chunk_size, backend=backend,
            block_shape=(info.dim_z_padded, vol_geo.dim_y, vol_geo.dim_x),
            accuracy=job.accuracy, device=device,
            v_band_width=_widest_band(job, full_geo, info),
        )
    except ValueError as e:
        raise StageConstructionError(str(e)) from e
    logger.info("backend: %s on %s, chunk size %d, accuracy %s",
                rec.backend, device, rec.chunk_size, rec.accuracy)
    on_card = device.type == "cuda"

    cache = _ProjectionCache(job, info)
    n_done = 0

    if overlap and info.num > 1:
        logger.info("write overlap: block k+1 reconstructs while "
                    "block k drains to disk")
    copy_stream = torch.cuda.Stream(device) if on_card else None
    writer = concurrent.futures.ThreadPoolExecutor(
        1, thread_name_prefix="paris-write")
    pending: Optional[concurrent.futures.Future] = None

    def _finalize_write(vol_state, blk, ready):
        with timers.time("finalize+write"):
            with _after(ready, copy_stream):
                out = rec.finalize(vol_state)
            sink.write_block(blk.index, out[: blk.dim_z], blk.z0)

    try:
        for block in info.blocks:
            if sink.is_done(block.index):
                logger.info("block %d already complete, skipping (resume)",
                            block.index)
                continue
            # checked BEFORE the block starts, so max_blocks=0 computes
            # nothing
            if job.max_blocks is not None and n_done >= job.max_blocks:
                logger.info("stopping after %d block(s) (max_blocks); "
                            "resume=True completes the remaining blocks",
                            n_done)
                break
            volume, ready, meter = _reconstruct_block(
                rec, job, block, info, vol_geo, cache, timers,
                lambda: _source_chunks(job, rec.chunk_size),
                first=n_done == 0)
            if pending is not None:
                # bound in-flight accumulators at 2 (this block's + the
                # one draining); also surfaces writer-thread errors
                pending.result()
                pending = None
            pending = writer.submit(_finalize_write, volume, block, ready)
            # drop the loop's reference now: without overlap the wait
            # below frees the accumulator before the next init_block
            volume = None
            if not overlap:
                pending.result()
                pending = None
            n_done += 1
            _log_block_done(block, meter)

        if pending is not None:
            pending.result()
            pending = None
    finally:
        _finish_writer(writer, pending, logger)
    total = time.perf_counter() - t_start
    timers.report(logger)
    logger.info("reconstruction finished in %s -> %s",
                fmt_duration(total), sink.path)
    return sink.path
