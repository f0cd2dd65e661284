"""The distributed reconstruction job: z-blocks over the ranks of the
default process group (port of ``paris_tpu/parallel/app.py``).

The multi-rank analog of ``app.run_job``.  Each z-block is reconstructed
with its z axis sharded over the ranks; every rank walks the same
projection stream but reads only the frames of its own chunk slots, raw,
through its own staging ring (and caches only those, where its plan
keeps a cache), and writes only its own slab, at its global offset
(``DistributedReconstructor.write_shards``): no rank holds a whole block
unless it is the only one.

Collectives (the agreements on probed memory, the barriers, the steps'
all-gathers) run on the main thread only.  The writer thread drains the
rank's slab, slab by slab through the job's pinned ring
(``io/drain.py``); the barrier that follows a block's
write, and the manifest mark, run on the main thread at a fixed point.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import Optional

from ..app import (
    CARD_CACHE_MARGIN, ReconstructionJob, _auto_hbm_budget,
    _block_hbm_bytes, _budget_max_dz, _finish_writer, _free_hbm_bytes,
    _job_source, _log_block_done, _memory_rule_why, _overlap_free_est,
    _plan_cache, _plan_write_overlap, _ProjectionCache, _drain_block,
    _reconstruct_block, _recorded_block_dz, _resume_extent, _source_chunks,
    _stream_bytes, _widest_band, card_block_dz,
)
from ..exceptions import ParisError, StageConstructionError, StageRuntimeError
from ..geometry import apply_roi, derive_volume_geometry, plan_z_blocks
from ..io.drain import BlockDrain
from ..io.sink import VolumeSink
from ..pipeline import resolve_backend
from ..utils.logging import StageTimers, fmt_duration
from ..utils import profiling
from ..utils.profiling import span, trace
from . import multihost
from .dist import DistributedReconstructor, owned_slots
from .mesh import world_and_rank

logger = logging.getLogger("paris_tpu_torch.parallel.app")

__all__ = ["run_job_distributed"]


def run_job_distributed(job: ReconstructionJob) -> str:
    """Run a full reconstruction over the ranks of the default process
    group (``multihost.initialize``); returns the output ddbvf path.
    Every rank calls it with the same job.  Raises as ``app.run_job``
    does.  The rank's job is one "job" span (``profiling.job``)."""
    try:
        with profiling.job():
            return _run_job_distributed(job)
    except (ParisError, KeyboardInterrupt):
        raise
    except (OSError, ValueError) as e:
        raise StageRuntimeError(f"reconstruction failed: {e}") from e


def _run_job_distributed(job: ReconstructionJob) -> str:
    """The rank's "job_setup" span (agreements, plan, sink,
    ``DistributedReconstructor``, rings, writer), then the blocks."""
    t_start = time.perf_counter()
    timers = StageTimers()
    with span("job_setup", timers=timers):
        world, rank = world_and_rank()

        try:
            full_geo = derive_volume_geometry(job.det)
            backend, device = resolve_backend(job.backend)
        except ValueError as e:
            raise StageConstructionError(str(e)) from e
        vol_geo = apply_roi(full_geo, job.roi) if job.roi else full_geo
        logger.info("volume [vx]: %d x %d x %d over %d rank(s)",
                    vol_geo.dim_x, vol_geo.dim_y, vol_geo.dim_z, world)

        chunk = max(job.chunk_size, world)
        chunk -= chunk % world
        proj_bytes = 4 * job.det.n_row * job.det.n_col
        proj_buffer = 4 * proj_bytes * chunk
        slot_filter = None
        lo, hi = owned_slots(rank, world, chunk)
        if world > 1:
            # decode only this rank's slots: input decode scales with ranks
            logger.info("disjoint input: this rank decodes %d of %d chunk "
                        "slots", hi - lo, chunk)
            slot_filter = lambda pos: lo <= pos % chunk < hi  # noqa: E731
        source = _job_source(job, slot_filter)
        # probes of the card can differ between ranks; the block plan and the
        # overlap flag must not (shard offsets, order of the barriers), so the
        # ranks take the smallest of each input of the plan
        auto_budget, free, recorded, card_bytes, host_bytes, frames = \
            multihost.agree_min(
                _auto_hbm_budget(device), _free_hbm_bytes(device),
                _recorded_block_dz(job, vol_geo),
                *_stream_bytes(source, job.det, chunk, (lo, hi)),
                device=device)
        job = _resume_extent(job, vol_geo, recorded, n_shards=world)
        hbm_budget = job.hbm_budget_bytes
        if hbm_budget is None and auto_budget is not None:
            # each rank holds 1/n of a block, so the budget of one card
            # scales to all of them
            hbm_budget = auto_budget * world
            logger.info("auto device-memory budget: %.1f GB over %d rank(s)",
                        hbm_budget / 2**30, world)
        # one rank's staging: its own slots, plus the gathered chunk and its
        # filtered temporary
        per_rank_proj = proj_buffer // world + 2 * proj_bytes * chunk
        free_est = _overlap_free_est(
            free, None if job.hbm_budget_bytes is None
            else job.hbm_budget_bytes // world)
        block_dz = job.block_dz
        why = _memory_rule_why(job, device, free_est)
        if why is None:
            block_dz, why = card_block_dz(
                vol_geo, free_est=free_est, proj_buffer=per_rank_proj,
                stream_card_bytes=card_bytes, stream_host_bytes=host_bytes,
                n_proj=frames, frame_pixels=job.det.n_row * job.det.n_col,
                n_shards=world, align=8 * world,
                budget_dz=_budget_max_dz(hbm_budget, proj_buffer, vol_geo,
                                         align=8 * world))
        try:
            info = plan_z_blocks(vol_geo, hbm_budget_bytes=hbm_budget,
                                 proj_buffer_bytes=proj_buffer,
                                 num_shards=world,
                                 z_align=8, block_dz=block_dz)
        except ValueError as e:
            raise StageConstructionError(str(e)) from e
        logger.info("z-split: %d block(s) of %d slices (padded)",
                    info.num, info.dim_z_padded)
        logger.info("block plan: %s", why if block_dz is not None
                    else f"the memory rule ({why})")
        info, overlap = _plan_write_overlap(
            job, vol_geo, info, free_est, per_rank_proj, hbm_budget=hbm_budget,
            proj_buffer=proj_buffer, n_shards=world)

        # rank 0 creates the shared ddbvf, the others attach after a barrier
        # (creating it twice would truncate what another rank wrote)
        try:
            if rank == 0:
                sink = VolumeSink(job.output_path, job.prefix, vol_geo.dim_x,
                                  vol_geo.dim_y, vol_geo.dim_z,
                                  resume=job.resume,
                                  block_dz=info.dim_z_padded)
            multihost.barrier("paris-sink-created")
            if rank != 0:
                sink = VolumeSink.attach(job.output_path, job.prefix,
                                         vol_geo.dim_x, vol_geo.dim_y,
                                         vol_geo.dim_z)
        except (OSError, ValueError) as e:
            raise StageConstructionError(f"cannot open sink: {e}") from e

        try:
            rec = DistributedReconstructor(
                job.det, full_geo, chunk_size=chunk,
                block_shape=(info.dim_z_padded, vol_geo.dim_y, vol_geo.dim_x),
                backend=backend,
                v_band_width=_widest_band(job, full_geo, info),
                accuracy=job.accuracy, device=device)
        except ValueError as e:
            raise StageConstructionError(str(e)) from e
        logger.info("backend: %s on %s, rank %d of %d, chunk size %d, "
                    "accuracy %s", rec.backend, device, rank, world, chunk,
                    rec.accuracy)

        # each rank caches its own slots, on its card when they fit beside its
        # share of the plan's accumulators
        card_room = None if device.type != "cuda" or free_est is None else (
            free_est - (2 if overlap else 1)
            * _block_hbm_bytes(vol_geo, info.dim_z_padded) // world
            - per_rank_proj - CARD_CACHE_MARGIN)
        place, _ = _plan_cache(job, info, source, chunk, (lo, hi), card_room)
        cache = _ProjectionCache(place)
        n_done = 0
        if overlap and info.num > 1:
            logger.info("write overlap: block k+1 reconstructs while "
                        "block k drains to disk")
        # one ring of pinned slots for every block of the job
        drain = BlockDrain(device, (vol_geo.dim_y, vol_geo.dim_x),
                           rec.local_dz)
        writer = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="paris-write")
        pending = None          # (future, block) of the draining block

    def _drain(vol_state, blk, ready):
        """Writer thread: local work only, no collective."""
        _drain_block(drain, lambda split: rec.write_shards(
            vol_state, sink.path, blk.z0, blk.dim_z, drain=drain,
            ready=ready, split=split), blk, timers)

    def _drain_pending():
        """Wait for the draining block's write, then, on the main thread,
        the barrier that says every rank wrote it and the manifest mark."""
        nonlocal pending
        if pending is None:
            return
        fut, blk = pending
        pending = None
        fut.result()
        multihost.barrier(f"paris-block-{blk.index}")
        if rank == 0:
            sink.mark_done(blk.index)

    with multihost.crash_diagnostics("reconstruct", job.output_path):
        try:
            for block in info.blocks:
                if sink.is_done(block.index):
                    logger.info("block %d already complete, skipping "
                                "(resume)", block.index)
                    continue
                # checked BEFORE the block starts, so max_blocks=0
                # computes nothing
                if job.max_blocks is not None and n_done >= job.max_blocks:
                    logger.info("stopping after %d block(s) (max_blocks); "
                                "resume=True completes the remaining "
                                "blocks", n_done)
                    break
                with trace(job.trace_dir, device):
                    volume, ready, meter = _reconstruct_block(
                        rec, job, block, info, vol_geo, cache, timers,
                        lambda: _source_chunks(source, chunk),
                        first=n_done == 0)
                    # bound in-flight accumulators at 2 (this block's and
                    # the draining one); surfaces writer errors.  In the
                    # block's trace, which so holds the drain's copies
                    with span("drain_wait"):
                        _drain_pending()
                pending = (writer.submit(_drain, volume, block, ready), block)
                # drop the loop's reference now: without overlap the wait
                # below frees the accumulator before the next init_block
                volume = None
                if not overlap:
                    _drain_pending()
                n_done += 1
                _log_block_done(block, meter)
            _drain_pending()
        finally:
            _finish_writer(writer, None if pending is None else pending[0],
                           logger)

    timers.report(logger)
    logger.info("distributed reconstruction finished in %s -> %s",
                fmt_duration(time.perf_counter() - t_start), sink.path)
    return sink.path
