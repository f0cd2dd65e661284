"""End-to-end reconstruction job: blocks x projection stream -> ddbvf
(port of ``paris_tpu/app.py``).

  * z-blocks come from ``plan_z_blocks``, sized by a device-memory budget
    (45% of the card's free memory unless the job sets one) or an extent:
    the job's, the resumed output's (its manifest records it), or on the
    card ``card_block_dz``'s, which splits the volume where block k's
    drain then hides behind block k+1's reconstruct from the stream kept
    on the card; padded to one uniform shape;
  * each step weights, filters and backprojects only the detector rows
    the widest block samples (``detector_row_band``);
  * per block: stream the HIS projections through the reconstructor,
    each chunk read raw into a pinned staging slot on a worker thread and
    copied to the card on a copy stream, then write the block at its
    global z offset and record it in the sink's resume manifest.  The
    HIS headers are read once per job (one file table);
  * the projection cache of a multi-block job keeps the staged raw
    stream for later blocks where ``plan_job`` decides, once: on the card
    when it fits beside the plan's accumulators (later blocks then do no
    host or copy work), else on the host under ``resolve_cache_cap``
    (staged again through the ring), else nowhere (read again);
  * each block drains to the ddbvf slab by slab on a writer thread
    (``io/drain.py``: on the card, async copies into a job-long ring of
    pinned slots on a copy stream of their own, each slot pwritten at its
    global z while the next slabs copy); it is marked done in the
    manifest after its last slab.  Block k drains while block k+1
    reconstructs when two accumulators fit the card's free memory.
    Unless the extent is forced, it is cut so that they do.
    ``PARIS_WRITE_OVERLAP=0`` turns both off.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import logging
import os
import sys
import time
from typing import Optional, Tuple

import torch

from .exceptions import (
    ParisError, StageConstructionError, StageRuntimeError,
)
from .geometry import (
    DetectorGeometry, RegionOfInterest, SubvolumeInfo, VolumeGeometry,
    apply_roi, derive_volume_geometry, detector_row_band, plan_z_blocks,
)
from .io.drain import BlockDrain
from .io.sink import VolumeSink
from .io.source import ProjectionSource
from .utils.logging import StageTimers, fmt_duration
from .pipeline import (Reconstructor, _STAGE_WORKERS, resolve_backend,
                       stage_stream)
from .utils import profiling
from .utils.profiling import ThroughputMeter, span, trace

logger = logging.getLogger("paris_tpu_torch.app")

__all__ = ["ReconstructionJob", "JobPlan", "plan_job", "run_job",
           "cache_placement"]


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
    # cap of the host projection cache; None = the smaller of 64 GiB and
    # half of the host's available memory (``resolve_cache_cap``)
    max_cache_bytes: Optional[int] = None
    # one torch.profiler Chrome trace per block: its reconstruct stage (a
    # "block" span), then the wait for the previous block's drain (a
    # "drain_wait" span)
    trace_dir: Optional[str] = None
    # Stop after computing this many NEW blocks (None = all); completed
    # blocks are durable in the sink manifest, so re-running with
    # resume=True completes the volume.
    max_blocks: Optional[int] = None


def _block_hbm_bytes(vol_geo: VolumeGeometry, dz: int) -> int:
    """Device bytes of one z-block accumulator: (dz, ny, nx) float32,
    unpadded.  The drain copies slabs of this contiguous tensor to the
    host, which makes no device copy."""
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


def extent_for(dim_z: int, k: int, align: int = 8) -> int:
    """The ``align``-aligned extent that splits ``dim_z`` slices into at
    most ``k`` blocks."""
    return -(-(-(-dim_z // k)) // align) * align


def predicted_job_seconds(k: int, *, updates: float, volume_bytes: float,
                          read_bytes: float, pixels: float) -> float:
    """Job seconds of a plan of ``k`` blocks, as the two-stage pipeline
    runs it: block 0 reconstructs from the HIS files (``FILES_OVER_CACHE``
    slower than a block served from the card cache, and never faster than
    reading the stream's ``read_bytes``); each later block reconstructs
    from the card cache while the one before drains (the drain then
    slower than alone); then the last block drains alone.  Every block
    passes over the stream's ``pixels`` once (the steps' whole-frame
    work).  A plan of one block keeps no cache and overlaps nothing.
    ``updates`` (voxels x projections) and ``volume_bytes`` are one
    rank's share."""
    recon = updates / K1_UPDATES_PER_S / k
    first = max(FILES_OVER_CACHE * recon, read_bytes / READ_BYTES_PER_S)
    beside = volume_bytes / DRAIN_BESIDE_BYTES_PER_S / k
    return (first + (k - 1) * max(recon, beside)
            + volume_bytes / DRAIN_BYTES_PER_S / k
            + k * pixels * PASS_S_PER_PIXEL)


def card_block_dz(vol_geo: VolumeGeometry, *, free_est: int,
                  proj_buffer: int, stream_card_bytes: int,
                  stream_host_bytes: int, n_proj: int, frame_pixels: int,
                  budget_dz: Optional[int] = None, n_shards: int = 1,
                  align: int = 8) -> Tuple[Optional[int], str]:
    """The card's block extent for a job that forces none: the role of
    ``paris_tpu/app.py:_perf_block_dz`` (whose TPU body tunes VMEM fills)
    on the card.  Returns (extent, why); extent None keeps the memory
    rule's plan.

    A split lets block k drain while block k+1 reconstructs from the
    stream kept on the card, so only the last block's drain is exposed.
    It is taken only where two accumulators, the stream's card cache
    (``stream_card_bytes``), the staging (``proj_buffer``) and
    ``CARD_CACHE_MARGIN`` fit ``free_est``: without the cache, later
    blocks would read the HIS files again beside the drain's pwrites.
    Among the block counts 1..``MAX_SPLIT`` whose aligned extent is at
    least ``MIN_SPLIT_DZ`` slices and so fits, it takes the one
    ``predicted_job_seconds`` says is fastest, its extent capped at
    ``budget_dz`` (the budget's largest); one block keeps the memory
    rule's plan.  ``n_shards`` ranks each hold 1/n of a
    block, reconstruct 1/n of its updates and drain 1/n of its bytes;
    the stream's bytes are one rank's."""
    slice_bytes = 4 * vol_geo.dim_x * vol_geo.dim_y
    n = max(1, n_shards)
    shares = dict(updates=vol_geo.voxels * n_proj / n,
                  volume_bytes=vol_geo.dim_z * slice_bytes / n,
                  read_bytes=stream_host_bytes,
                  pixels=n_proj * frame_pixels)
    one = predicted_job_seconds(1, **shares)
    room = free_est - proj_buffer - stream_card_bytes - CARD_CACHE_MARGIN
    best = None
    for k in range(2, MAX_SPLIT + 1):
        dz = extent_for(vol_geo.dim_z, k, align)
        blocks = -(-vol_geo.dim_z // dz)
        if (dz < MIN_SPLIT_DZ or blocks < 2
                or 2 * dz * slice_bytes // n > room):
            continue
        t = predicted_job_seconds(blocks, **shares)
        if best is None or t < best[0]:
            best = (t, dz, blocks)
    if best is None:
        return None, ("no split of at least %d slices fits two "
                      "accumulators beside the stream's %d card bytes"
                      % (MIN_SPLIT_DZ, stream_card_bytes))
    t, dz, blocks = best
    if t >= one:
        return None, ("one block: predicted %.2f s, %d blocks %.2f s"
                      % (one, blocks, t))
    why = ("%d blocks of %d slices, predicted %.2f s against %.2f s at "
           "one block; two accumulators and the stream's %d card bytes fit"
           % (blocks, dz, t, one, stream_card_bytes))
    if budget_dz is not None and dz > budget_dz:
        return budget_dz, why + "; capped at the budget's %d" % budget_dz
    return dz, why


@dataclasses.dataclass(frozen=True)
class JobPlan:
    """The z-blocks ``run_job`` runs a job in: ``info``, the blocks;
    ``overlap``, whether block k drains to disk while block k+1
    reconstructs; ``hbm_budget``, the per-block device-memory budget the
    plan was cut to (None: no budget, one block unless the extent is
    forced); ``cache``, where the projection cache keeps the staged stream
    for later blocks ("card", "host" or "off"), and ``cache_bytes`` its
    bytes there."""
    info: SubvolumeInfo
    overlap: bool
    hbm_budget: Optional[int]
    cache: str = "off"
    cache_bytes: int = 0


# steps the job's consumer thread may enqueue ahead of the card
STEP_LEAD = 4

# card memory kept free beside the card cache, the accumulators and the
# staging: the step's whole-frame float32 and band temporaries, cuFFT's
# workspace, the allocator's rounding
CARD_CACHE_MARGIN = 2 << 30

# The card's block-extent rule (``card_block_dz``), sized by the plan
# sweep on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6, PR
# 12: benchmarks/plan_sweep.py at config 3, 1024^3 from 360 and 3600
# float32 frames in 1, 2, 4 and 8 blocks; full_scale_2048.py at config 5
# from 1000 uint16 frames in 1 and 6 blocks):
K1_UPDATES_PER_S = 6.8e11   # a card-cached block's reconstruct: 656-743 G/s
FILES_OVER_CACHE = 1.05     # block 0, from the HIS files, over that: 1.0-1.07
READ_BYTES_PER_S = 4.5e9    # block 0 reads the stream no faster: 4.0-5.5 GB/s
DRAIN_BYTES_PER_S = 3.0e9   # a drain alone: 2.6-3.4 GB/s
DRAIN_BESIDE_BYTES_PER_S = 2.5e9   # beside a reconstruct: 2.4-3.0 GB/s
PASS_S_PER_PIXEL = 1.0e-11  # a block's pass over the stream, per frame pixel
MAX_SPLIT = 8               # the largest block count the sweep measured
MIN_SPLIT_DZ = 128          # thinner blocks are never split to


def cache_placement(card_bytes: int, host_bytes: int,
                    card_room: Optional[int], host_cap: int) -> str:
    """Where a job keeps its staged stream, ``card_bytes`` on the card
    (every chunk's slots) and ``host_bytes`` on the host (its frames):
    "card" when they fit ``card_room`` (the card's free memory less the
    plan's accumulators, staging and ``CARD_CACHE_MARGIN``; None: no
    card), else "host" when they are within ``host_cap``, else "off"."""
    if card_room is not None and card_bytes <= card_room:
        return "card"
    if host_bytes <= host_cap:
        return "host"
    return "off"


def _job_source(job: ReconstructionJob, slot_filter=None
                ) -> ProjectionSource:
    """The job's projection stream, raw: its file table (every HIS header
    read once) serves every block."""
    return ProjectionSource(job.input_path, angle_file=job.angle_path,
                            delta_phi=job.det.delta_phi, quality=job.quality,
                            slot_filter=slot_filter, raw=True)


def _stream_bytes(source: ProjectionSource, det: DetectorGeometry,
                  chunk_size: int, rows: Tuple[int, int]
                  ) -> Tuple[int, int, int]:
    """(bytes of this process's chunk rows ``rows`` of the stream as the
    card keeps them: every slot of every chunk; as the host keeps them:
    the frames; the stream's frames), in the chunks' raw types, from the
    file table."""
    lo, hi = rows
    card = host = frames = 0
    for r in source.chunk_reads(chunk_size):
        frame = r.dtype.itemsize * det.n_col * det.n_row
        card += (hi - lo) * frame
        host += max(0, min(hi, r.rows) - lo) * frame
        frames += r.rows
    return card, host, frames


def _plan_cache(job: ReconstructionJob, info: SubvolumeInfo,
                source: Optional[ProjectionSource], chunk_size: int,
                rows: Tuple[int, int], card_room: Optional[int]
                ) -> Tuple[str, int]:
    """(place, bytes) of the job's projection cache, decided once and
    logged: kept when the job asks (``cache_projections=True``) or, by
    default, when this run computes more than one block; then
    ``cache_placement`` of the stream's bytes."""
    runs = info.num if job.max_blocks is None else min(info.num,
                                                       job.max_blocks)
    if not (job.cache_projections is True
            or (job.cache_projections is None and runs > 1)):
        logger.info("projection cache: off (%s)",
                    "cache_projections=False"
                    if job.cache_projections is False else
                    "one block" if info.num < 2 else
                    "one block in this run, max_blocks")
        return "off", 0
    cap = resolve_cache_cap(job)
    logger.info("projection cache: on, cap %.2f GiB (%s)", cap / 2**30,
                "the job's max_cache_bytes"
                if job.max_cache_bytes is not None
                else "64 GiB or half of the host's available memory")
    if source is None:
        source = _job_source(job)
    card_bytes, host_bytes, _ = _stream_bytes(source, job.det, chunk_size,
                                              rows)
    place = cache_placement(card_bytes, host_bytes, card_room, cap)
    if place == "card":
        logger.info("projection cache: on the card, %d bytes (%d bytes of "
                    "the card free beside the plan)", card_bytes, card_room)
        return place, card_bytes
    if place == "host":
        logger.info("projection cache: on the host, %d bytes", host_bytes)
        return place, host_bytes
    logger.info("projection cache: the stream passed the cap of %d bytes, "
                "later blocks stream it again", cap)
    return "off", 0


def _memory_rule_why(job: ReconstructionJob, device: torch.device,
                     free_est: Optional[int]) -> Optional[str]:
    """Why the job keeps the memory rule's plan (the JAX package's), or
    None when the card's block-extent rule decides the extent."""
    if job.block_dz is not None:
        return "the job's block_dz"
    if job.hbm_budget_bytes is not None:
        return "the job's device-memory budget"
    if os.environ.get("PARIS_WRITE_OVERLAP", "1") == "0":
        return "PARIS_WRITE_OVERLAP=0"
    if device.type != "cuda" or free_est is None:
        return "off the card"
    if job.cache_projections is False:
        return "cache_projections=False"
    return None


def _budget_max_dz(hbm_budget: Optional[int], proj_buffer: int,
                   vol_geo: VolumeGeometry, align: int = 8
                   ) -> Optional[int]:
    """The largest ``align``-aligned extent the per-block budget holds
    (None: no budget)."""
    if hbm_budget is None:
        return None
    slices = (hbm_budget - proj_buffer) // _block_hbm_bytes(vol_geo, 1)
    return max(align, slices // align * align)


def plan_job(job: ReconstructionJob, vol_geo: VolumeGeometry,
             device: torch.device,
             source: Optional[ProjectionSource] = None) -> JobPlan:
    """The plan ``run_job`` takes for ``job`` on ``device``: the job's
    budget, else 45 % of the card's free memory; on the card, unless the
    job forces an extent or a budget, the extent of ``card_block_dz``
    (capped by that budget), which reads the stream's bytes and frames
    from ``source``'s file table; the blocks that fit the budget (or that
    extent); then the cut for the write overlap; then where the
    projection cache lives (``_plan_cache``: on the card when the stream
    fits the free memory less two accumulators with the overlap, else
    one, the staging and a margin).  ``source`` defaults to the job's,
    built only when the rule or the cache needs it.  The plan and why are
    logged beside the z-split.  A caller that must know where the block
    seams fall calls it too, and pins the result into the job
    (``block_dz=plan.info.dim_z_padded``): the free memory it reads can
    change between two calls.  Raises ValueError for a budget or extent
    no plan fits."""
    proj_bytes = 4 * job.det.n_row * job.det.n_col
    proj_buffer = 4 * proj_bytes * job.chunk_size
    hbm_budget = job.hbm_budget_bytes
    if hbm_budget is None:
        hbm_budget = _auto_hbm_budget(device)
        if hbm_budget is not None:
            logger.info("auto device-memory budget: %.1f GB",
                        hbm_budget / 2**30)
    free_est = _overlap_free_est(_free_hbm_bytes(device),
                                 job.hbm_budget_bytes)
    block_dz = job.block_dz
    why = _memory_rule_why(job, device, free_est)
    if why is None:
        if source is None:
            source = _job_source(job)
        card, host, frames = _stream_bytes(source, job.det, job.chunk_size,
                                           (0, job.chunk_size))
        block_dz, why = card_block_dz(
            vol_geo, free_est=free_est, proj_buffer=proj_buffer,
            stream_card_bytes=card, stream_host_bytes=host, n_proj=frames,
            frame_pixels=job.det.n_row * job.det.n_col,
            budget_dz=_budget_max_dz(hbm_budget, proj_buffer, vol_geo))
    info = plan_z_blocks(vol_geo, hbm_budget_bytes=hbm_budget,
                         proj_buffer_bytes=proj_buffer, block_dz=block_dz)
    logger.info("z-split: %d block(s) of %d slices (padded)",
                info.num, info.dim_z_padded)
    logger.info("block plan: %s", why if block_dz is not None
                else f"the memory rule ({why})")
    # Overlapped finalize: block k's device-to-host copy and ddbvf write
    # run on the writer thread while block k+1 reconstructs.  It needs two
    # accumulators resident at once, so it engages only when they fit.
    info, overlap = _plan_write_overlap(
        job, vol_geo, info, free_est, proj_buffer,
        hbm_budget=hbm_budget, proj_buffer=proj_buffer)
    card_room = None if free_est is None or device.type != "cuda" else (
        free_est - (2 if overlap else 1)
        * _block_hbm_bytes(vol_geo, info.dim_z_padded)
        - proj_buffer - CARD_CACHE_MARGIN)
    cache, cache_bytes = _plan_cache(job, info, source, job.chunk_size,
                                     (0, job.chunk_size), card_room)
    return JobPlan(info, overlap, hbm_budget, cache, cache_bytes)


def _recorded_block_dz(job: ReconstructionJob,
                       vol_geo: VolumeGeometry) -> Optional[int]:
    """On ``resume``, the block extent the output's manifest records
    (``VolumeSink.recorded_block_dz``); else None."""
    if not job.resume:
        return None
    try:
        return VolumeSink.recorded_block_dz(
            job.output_path, job.prefix, vol_geo.dim_x, vol_geo.dim_y,
            vol_geo.dim_z)
    except (OSError, ValueError) as e:
        raise StageConstructionError(f"cannot read the manifest: {e}") from e


def _resume_extent(job: ReconstructionJob, vol_geo: VolumeGeometry,
                   recorded: Optional[int], n_shards: int = 1
                   ) -> ReconstructionJob:
    """The job a resume runs, at the block extent ``recorded`` in the
    output's manifest: the manifest marks blocks by index, so a resumed
    job cut to another extent would skip other slices than those written.
    A job that forces no extent takes the recorded one; a forced extent
    that plans to another, or a recorded one this run's ``n_shards``
    ranks cannot take, raises ``StageConstructionError``.  ``recorded``
    None (a new output, or a manifest from before extents were recorded)
    leaves the job as it is."""
    if recorded is None:
        return job

    def planned(dz: int) -> int:
        return plan_z_blocks(vol_geo, block_dz=dz,
                             num_shards=n_shards).dim_z_padded

    if planned(recorded) != recorded:
        raise StageConstructionError(
            f"the output's manifest records blocks of {recorded} slices, "
            f"which {n_shards} rank(s) cannot plan; resume with the ranks "
            "that wrote it")
    if job.block_dz is not None and planned(job.block_dz) != recorded:
        raise StageConstructionError(
            f"block_dz {job.block_dz} plans blocks of "
            f"{planned(job.block_dz)} slices, but the output's manifest "
            f"records blocks of {recorded}; resume with that extent, or "
            "with none")
    if job.block_dz is None:
        logger.info("resume: blocks of %d slices, as the output's manifest "
                    "records", recorded)
    return dataclasses.replace(job, block_dz=recorded)


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


def _source_chunks(source: ProjectionSource, chunk_size: int):
    """(``ChunkRead``, angles in degrees) pairs of the job's HIS stream:
    read plans, each read on a staging worker straight into its slot with
    that worker's share of the host's threads.  Frames the source's
    ``slot_filter`` rejects are not read and come as zero rows."""
    n_threads = max(1, (os.cpu_count() or 1) // _STAGE_WORKERS)
    for r in source.chunk_reads(chunk_size, n_threads):
        yield r, r.phis


MAX_CACHE_BYTES = 64 << 30     # the cache's cap on a host with memory to spare


def _available_host_bytes() -> Optional[int]:
    """Physical memory the host has available now (bytes); None where
    ``os.sysconf`` does not know the names."""
    try:
        return (os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return None


def resolve_cache_cap(job: ReconstructionJob) -> int:
    """Bytes the job's host projection cache may hold: the job's
    ``max_cache_bytes`` as given, else the smaller of ``MAX_CACHE_BYTES``
    and half of the memory the host has available."""
    if job.max_cache_bytes is not None:
        return job.max_cache_bytes
    available = _available_host_bytes()
    if available is None:
        return MAX_CACHE_BYTES
    return min(MAX_CACHE_BYTES, available // 2)


class _ProjectionCache:
    """The staged stream that later blocks of a job reuse, kept where the
    plan put it (``JobPlan.cache``): "card", the staged chunks themselves
    (later blocks do no host or copy work); "host", each chunk's rows in
    pageable host memory, staged again through the ring; "off", nothing
    (every block reads the HIS files again)."""

    def __init__(self, place: str):
        self.place = place
        self.kept: Optional[list] = None

    def staged(self, rec, chunks, timers: StageTimers):
        """(staged chunk, projections) pairs of one block: from the cache
        once a pass filled it, else from ``chunks()`` ((chunk, angles)
        pairs) through ``stage_stream``, kept on this first pass when the
        plan caches.  ``timers`` gets the staging's "read" and
        "stage_wait" spans' seconds.  Sets ``origin`` to what served the
        block."""
        if self.kept is not None and self.place == "card":
            self.origin = "card cache"
            yield from self.kept
            return
        collect = self.kept is None and self.place != "off"
        self.origin = "host cache" if self.kept is not None else "HIS files"
        pairs = self.kept if self.kept is not None else chunks()
        stage = functools.partial(rec.stage_chunk, timers=timers,
                                  keep=collect and self.place == "host")
        kept, nbytes = [], 0
        for staged, k in stage_stream(stage, pairs, timers=timers):
            if collect and self.place == "card":
                kept.append((staged._replace(host=None), k))
                nbytes += staged.chunk.numel() * staged.chunk.element_size()
            elif collect:
                kept.append(staged.host)
                nbytes += staged.host[0].array.nbytes
            yield staged._replace(host=None), k
        if collect:
            self.kept = kept
            logger.info("projection cache: kept the stream's %d bytes for "
                        "later blocks", nbytes)


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
    split = StageTimers()            # this block's ingest split
    enqueued = collections.deque()   # events after the steps in flight
    with span("block", timers=split):
        # consumed on THIS thread; reads into the staging ring and the
        # copies to the card run on stage_stream's worker threads
        for staged, k in cache.staged(rec, chunks, split):
            volume = rec.step_staged(volume, staged, z_offset=block.z0,
                                     roi_offset=roi, timers=split)
            if device.type == "cuda":
                # stay at most STEP_LEAD steps ahead of the card, so that
                # the staged chunks the card has yet to read stay few
                enqueued.append(torch.cuda.Event())
                enqueued[-1].record()
                if len(enqueued) > STEP_LEAD:
                    with span("card_wait", timers=split):
                        enqueued.popleft().synchronize()
            if first:
                # time-to-first-chunk marker: the first step of a
                # process builds the kernel
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                logger.info("first chunk accumulated")
                first = False
            meter.add(k)
        # close the stage only when the card has finished
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
            torch.cuda.synchronize(device)
    if meter.projections == 0:
        logger.warning("no projections found in %s", job.input_path)
    timers.merge(split)
    _log_ingest(block, split, cache.origin)
    return volume, ready, meter


def _log_ingest(block, split: StageTimers, origin: str) -> None:
    """The block's ingest split, host seconds of its spans: "reconstruct",
    the "block" span (until the card has finished); "read", the staging
    workers' fills of the ring (HIS files, or the host cache, into a
    slot; summed over the workers, which read in parallel); "stage_wait",
    the consumer waiting on a staged chunk (the host holds the card
    back); "step_enqueue", the "step" spans, the consumer enqueuing the
    steps; "card_wait", the consumer waiting for the card to come within
    ``STEP_LEAD`` steps (the card holds the host back).  The rest of the
    stage is the card finishing the last steps."""
    t, c = split.totals, split.counts
    logger.info("block %d ingest from the %s: reconstruct %.3f s, read "
                "%.3f s (%d chunks), stage_wait %.3f s, step_enqueue %.3f s "
                "(%d steps), card_wait %.3f s", block.index, origin,
                t["block"], t.get("read", 0.0), c.get("read", 0),
                t.get("stage_wait", 0.0), t.get("step", 0.0),
                c.get("step", 0), t.get("card_wait", 0.0))


def _drain_block(drain: BlockDrain, write, block, timers: StageTimers
                 ) -> None:
    """Run ``write(split)``, the block's drain through ``drain``, as the
    job's "drain" span; merge its split into ``timers`` and log it:
    "d2h", the slabs' copies on the card (the "d2h" spans' CUDA events,
    so only in a profiled block; 0 otherwise and on the CPU); "write",
    the host seconds of the pwrites; "wait", the writer waiting on a
    slab's copy (the copy holds the write back)."""
    split = StageTimers()
    with span("drain", timers=timers):
        write(split)
    timers.merge(split)
    t, c = split.totals, split.counts
    logger.info("block %d drain: d2h %.3f s, write %.3f s, wait %.3f s "
                "(%d slabs of %d slices, %d pinned bytes)", block.index,
                t.get("d2h", 0.0), t.get("write", 0.0),
                t.get("copy_wait", 0.0), c.get("write", 0), drain.slices,
                drain.pinned_bytes)


def _log_block_done(block, meter) -> None:
    pps, gups = meter.rates()
    logger.info("block %d done (%d projections, %.1f proj/s, %.1f Gupd/s)",
                block.index, meter.projections, pps, gups)


def run_job(job: ReconstructionJob) -> str:
    """Run a full reconstruction; returns the output ddbvf path.

    Raises ``StageConstructionError`` if the pipeline cannot be built
    (bad geometry, paths or backend) and ``StageRuntimeError`` if it
    fails mid-stream — the reference's two exception tiers.  The job is
    one "job" span (``profiling.job``).
    """
    try:
        with profiling.job():
            return _run_job(job)
    except (ParisError, KeyboardInterrupt):
        raise
    except (OSError, ValueError) as e:
        raise StageRuntimeError(f"reconstruction failed: {e}") from e


def _run_job(job: ReconstructionJob) -> str:
    """The job's "job_setup" span from its start to its first block
    (geometry, plan, sink, ``Reconstructor``, rings, writer), then the
    blocks."""
    t_start = time.perf_counter()
    timers = StageTimers()

    with span("job_setup", timers=timers):
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

        source = _job_source(job)
        try:
            job = _resume_extent(job, vol_geo,
                                 _recorded_block_dz(job, vol_geo))
            plan = plan_job(job, vol_geo, device, source)
        except ValueError as e:
            raise StageConstructionError(str(e)) from e
        info, overlap = plan.info, plan.overlap

        try:
            sink = VolumeSink(job.output_path, job.prefix, vol_geo.dim_x,
                              vol_geo.dim_y, vol_geo.dim_z, resume=job.resume,
                              block_dz=info.dim_z_padded)
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

        cache = _ProjectionCache(plan.cache)
        n_done = 0

        if overlap and info.num > 1:
            logger.info("write overlap: block k+1 reconstructs while "
                        "block k drains to disk")
        # one ring of pinned slots for every block of the job
        drain = BlockDrain(device, (vol_geo.dim_y, vol_geo.dim_x),
                           info.dim_z_padded)
        writer = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="paris-write")
        pending: Optional[concurrent.futures.Future] = None

    def _finalize_write(vol_state, blk, ready):
        def write(split):
            drain.drain(vol_state, sink.path, blk.z0, blk.dim_z, ready=ready,
                        split=split)
            # only after the last slab: a drain that fails leaves the
            # block to be rewritten whole on resume
            sink.mark_done(blk.index)
        _drain_block(drain, write, blk, timers)

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
            with trace(job.trace_dir, device):
                volume, ready, meter = _reconstruct_block(
                    rec, job, block, info, vol_geo, cache, timers,
                    lambda: _source_chunks(source, rec.chunk_size),
                    first=n_done == 0)
                # bound in-flight accumulators at 2 (this block's + the
                # one draining); also surfaces writer-thread errors.  In
                # the block's trace, which so holds the drain's copies
                with span("drain_wait"):
                    if pending is not None:
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
