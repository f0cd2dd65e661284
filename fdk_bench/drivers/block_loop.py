"""``block_loop``: z-blocks reconstructed one after another from a
projection stream kept on the card, as every block of a large scan after
the first runs in a job (``app``'s card cache).

Set-up synthesizes the seed's scan on the card as uint16 counts, chunk
by chunk, and stages every chunk through ``Reconstructor.stage_chunk``
(its pinned ring and copy stream), keeping the staged chunks on the card;
then one step into each block's z offset warms up every shape.  The
window runs ``step_staged`` over the whole stream for block 0, 1, ...
in turn, each block into a new accumulator, at most ``STEP_LEAD`` steps
ahead of the card, and ends at a ``torch.cuda.synchronize()``; nothing
is copied to the host inside it.  The block in progress when the window
closes is finished (or, if it had just begun, the block before it is
taken), finalized, and a sample of its voxels drawn from the seed is
held to the plain reference.  With ``--trace 1`` the window's first
block pass is profiled whole.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import numpy as np
import torch

from ..lib.geometry import derive_volume, row_band, scan_from
from ..lib.phantom import Projector, as_float
from ..lib.trace import span
from ..lib.work import k1_pass_least_s
from ..reference.compare import rel_rmse
from ..reference.fdk import fdk_at_voxels

# the job's own lead of the host over the card (app.STEP_LEAD)
STEP_LEAD = 4
# the host span the traced window is read over
TRACE_WINDOWS = {"block": "fdk_bench.block_pass"}


class CardRows:
    """Frames already on the card, read like the program's ``ChunkRead``:
    ``read_into(out, lo, hi)`` copies rows [lo, hi) into ``out`` (a
    staging slot) and zeroes the rest."""

    dtype = np.dtype(np.uint16)

    def __init__(self, counts: torch.Tensor):
        self.counts = counts
        self.rows = counts.shape[0]

    def read_into(self, out: np.ndarray, lo: int = 0, hi=None) -> None:
        hi = self.rows if hi is None else min(hi, self.rows)
        n = max(0, hi - lo)
        torch.from_numpy(out.view(np.int16))[:n].copy_(self.counts[lo:hi])
        out[n:] = 0


def sample_voxels(seed: int, z0: int, dz: int, ny: int, nx: int, n: int
                  ) -> torch.Tensor:
    """(n, 3) global (z, y, x) indices drawn from ``seed`` inside slices
    z0 .. z0 + dz - 1: an eighth of them on the first slice, an eighth on
    the last (the block's seams), the rest anywhere."""
    rng = np.random.default_rng([int(seed), 7])
    edge = n // 8
    z = rng.integers(0, dz, size=n)
    z[:edge] = 0
    z[edge:2 * edge] = dz - 1
    y = rng.integers(0, ny, size=n)
    x = rng.integers(0, nx, size=n)
    return torch.from_numpy(np.stack([z + z0, y, x], axis=1))


def run(ctx) -> None:
    from paris_tpu_torch.geometry import (DetectorGeometry,
                                          derive_volume_geometry,
                                          detector_row_band, plan_z_blocks)
    from paris_tpu_torch.pipeline import Reconstructor

    mix = ctx.mix
    scan = scan_from(ctx.config)
    n_proj = int(ctx.config["scan"]["n_proj"])
    C = int(mix["chunk_size"])
    det = DetectorGeometry(scan.n_row, scan.n_col, scan.l_px_row,
                           scan.l_px_col, scan.delta_s, scan.delta_t,
                           scan.d_so, scan.d_od, scan.delta_phi)
    vol = derive_volume_geometry(det)
    info = plan_z_blocks(vol, block_dz=int(mix["block_dz"]))
    band = max(hi - lo for lo, hi in (
        detector_row_band(det, vol, b.z0, b.dim_z_padded)
        for b in info.blocks))
    rec = Reconstructor(det, vol, chunk_size=C, backend=ctx.backend,
                        block_shape=(info.dim_z_padded, vol.dim_y,
                                     vol.dim_x),
                        accuracy=mix["accuracy"], device=ctx.device,
                        v_band_width=band if band < det.n_col else None)
    fvol = derive_volume(scan)
    proj = Projector(scan, fvol, ctx.seed, ctx.device)
    idx = np.arange(n_proj)
    staged = []
    for i0 in range(0, n_proj, C):
        part = idx[i0:i0 + C]
        staged.append(rec.stage_chunk(
            CardRows(proj.counts(part)),
            (part * scan.delta_phi).astype(np.float32)))
    ctx.note(f"staged {n_proj} frames in {len(staged)} chunks")
    # every shape once: a step at each block's offset; two accumulators
    # made and freed, so the window's come from the allocator's cache
    warm = [rec.init_block(), rec.init_block()]
    for b in info.blocks:
        rec.step_staged(warm[0], staged[0], z_offset=b.z0)
    ctx.sync()
    del warm
    ctx.warm_profiler()

    ny, nx = vol.dim_y, vol.dim_x
    on_card = ctx.device.type == "cuda"
    lead = collections.deque()
    steps = updates = passes = 0
    current, k = rec.init_block(), 0
    done = None
    t0 = ctx.start_window()
    stop = False
    while not stop:
        block = info.blocks[passes % info.num]
        traced = ctx.trace and passes == 0
        with (ctx.profiler() if traced else contextlib.nullcontext()), \
                span("fdk_bench.block_pass", traced):
            for k, s in enumerate(staged):
                if not traced and time.perf_counter() - t0 >= ctx.seconds:
                    stop = True
                    break
                with span("fdk_bench.step", traced):
                    rec.step_staged(current, s, z_offset=block.z0)
                steps += 1
                updates += block.dim_z * ny * nx * s.n
                if on_card:
                    ev = torch.cuda.Event()
                    ev.record()
                    lead.append(ev)
                    if len(lead) > STEP_LEAD:
                        lead.popleft().synchronize()
            else:
                k = len(staged)
            if traced:
                ctx.sync()
        if stop:
            break
        done = (current, block)
        current = rec.init_block()
        passes += 1
    ctx.sync()
    window = time.perf_counter() - t0
    ctx.close_window()
    lead.clear()
    ctx.attempted = steps
    r = ctx.record
    r["block"] = {"updates": updates, "window_s": window, "steps": steps,
                  "passes": passes}
    # the traced pass's work by the frozen count: block 0, whole
    b0 = info.blocks[0]
    elem = 2 if mix["accuracy"] == "fast" else 4
    fband = max(hi - lo for lo, hi in (
        row_band(scan, fvol, b.z0, b.dim_z_padded) for b in info.blocks))
    r["block"]["traced_steps"] = len(staged)
    r["block"]["k1_least_s"] = k1_pass_least_s(
        b0.dim_z, ny, nx, n_proj, fband, scan.n_row, elem)[0]

    # the block to judge: the one in progress, finished after the window,
    # unless it had only begun and a whole one is at hand
    if done is not None and k < len(staged) // 2:
        volume, block = done
    else:
        volume, block = current, info.blocks[passes % info.num]
        for s in staged[k:]:
            rec.step_staged(volume, s, z_offset=block.z0)
    s = None
    ctx.sync()
    ctx.note(f"window {window:.3f} s, {steps} steps, {passes} passes; "
             f"judging block {block.index}")
    out = rec.finalize(volume)
    vox = sample_voxels(ctx.seed, block.z0, block.dim_z, ny, nx,
                        int(mix["sample_voxels"]))
    local = vox.clone()
    local[:, 0] -= block.z0
    got = torch.from_numpy(out[local[:, 0].numpy(), local[:, 1].numpy(),
                               local[:, 2].numpy()].astype(np.float64))
    del out, volume, current, done, staged, rec, s
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    judge(ctx, proj, scan, fvol, idx, vox, got)
    ctx.note("reference done")


def judge(ctx, proj, scan, fvol, idx, vox, got) -> None:
    """Hold ``got`` (the program's values at ``vox``) to the plain
    reference; with ``ctx.control``, hold the reference computed in that
    lower precision instead, in the program's place."""
    def frames(part):
        return as_float(proj.counts(part))

    ref = fdk_at_voxels(frames, idx, scan, fvol, vox, device=ctx.device)
    if ctx.control is not None:
        got = fdk_at_voxels(frames, idx, scan, fvol, vox, device=ctx.device,
                            lowp=ctx.control)
    ctx.numbers["rel_rmse"] = rel_rmse(got.to(ref.device), ref)
