"""The output drain: a z-block accumulator into the ddbvf, slab by slab.

The JAX package pulled a whole block (or ~1 GiB slabs it transposed on
the host) into pageable memory and then wrote it, the sizes its kernel
layout and its TPU's memory set.  On the card one pageable ``.cpu()`` of
a block pays the copy, then the first touch of every destination page,
then the pwrite, one after the other, and holds the launching thread
back while CUDA stages it through a bounce buffer.  ``BlockDrain``
instead cuts the block's valid slices into z-slabs of whole slices
(about ``SLAB_BYTES`` each) and, on the card:

  * copies each slab, ``non_blocking``, into a slot of a ring of
    ``DRAIN_SLOTS`` pinned host buffers (``pipeline._Ring``), on a copy
    stream of its own that first waits for the block's ``ready`` event;
  * waits for a slab's copy event, then pwrites the slot at global slice
    ``z0 + offset`` through ``ddbvf.write_slices`` (the native writer on a
    contiguous view of the slot: no host copy), while the next slabs'
    copies are in flight;
  * hands a slot out again only after the pwrite that read it has
    returned, and waits for a slot's last copy before it hands it out
    (which matters only after a drain that failed);
  * keeps the accumulator referenced until its last copy has completed,
    and ``record_stream``s it on the copy stream, so that the caching
    allocator cannot give its memory to the next block while a copy still
    reads it.

The ring is allocated at the first drain and kept for every later block
of the job: its pinned bytes are ``DRAIN_SLOTS`` slabs, whatever the block
size.  On the CPU the accumulator is host memory already, and its slabs
are written as views: no pinned memory, no copy stream.  Nothing falls
back: a pinned allocation, a copy or a pwrite that fails raises.
"""

from __future__ import annotations

import collections
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from . import ddbvf
from ..pipeline import _Ring
from ..utils.profiling import count, span

__all__ = ["BlockDrain", "SLAB_BYTES", "DRAIN_SLOTS", "slab_slices"]

# bytes per slab: whole slices of about this much (32 slices of 4 MiB at a
# 1024^2 slice, 8 of 16 MiB at 2048^2)
SLAB_BYTES = 128 << 20
# pinned slots: one being written while the next slabs' copies run
DRAIN_SLOTS = 3


def slab_slices(slice_bytes: int, max_slices: int, slab_bytes: int) -> int:
    """Slices per slab: as many whole slices as ``slab_bytes`` holds, at
    least one and at most ``max_slices`` (the accumulator's)."""
    return max(1, min(int(max_slices), int(slab_bytes) // int(slice_bytes)))


class BlockDrain:
    """Drains (dz, ny, nx) float32 accumulators on ``device`` into ddbvf
    files, slab by slab: one per job, reused by every block.

    ``max_slices`` is the accumulator's dz (a block's padded extent, or a
    rank's slab of it); a slab holds ``slices`` of them, as many as
    ``SLAB_BYTES`` holds.  ``drain`` writes a block; ``pinned_bytes`` is
    what its ring holds."""

    def __init__(self, device, slice_shape: Tuple[int, int],
                 max_slices: int):
        self.device = torch.device(device)
        self.slice_shape = tuple(int(n) for n in slice_shape)
        slice_bytes = 4 * self.slice_shape[0] * self.slice_shape[1]
        self.slices = slab_slices(slice_bytes, max_slices, SLAB_BYTES)
        if self.device.type == "cuda":
            self._ring = _Ring(DRAIN_SLOTS)
            self._stream = torch.cuda.Stream(self.device)

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the ring holds (0 on the CPU)."""
        return self._ring.nbytes if self.device.type == "cuda" else 0

    def slabs(self, dim_z: int):
        """(offset, slices) of the slabs of a block's first ``dim_z``
        slices."""
        return [(o, min(self.slices, dim_z - o))
                for o in range(0, dim_z, self.slices)]

    def drain(self, volume: torch.Tensor, path: str, z0: int, dim_z: int,
              ready=None, split=None) -> int:
        """Write the first ``dim_z`` slices of ``volume`` (at most all of
        them) into the ddbvf at ``path`` from global slice ``z0``, slab by
        slab; returns the slices written.  ``ready``: the event after the
        block's last step (on the card; by default an event recorded now
        on the current stream, so the drain waits for the work queued
        there that writes ``volume``).  ``split`` (a ``StageTimers``)
        gets "d2h" (the slabs' copies on the card: the "d2h" spans' device
        seconds, so only while a profiler runs), "write" (the pwrites, one
        count per slab) and "copy_wait" (the writer waiting on a slab's
        copy), each a span."""
        if tuple(volume.shape[1:]) != self.slice_shape:
            raise ValueError(f"accumulator slices {tuple(volume.shape[1:])} "
                             f"are not the drain's {self.slice_shape}")
        n = max(0, min(int(dim_z), volume.shape[0]))
        if volume.device.type != "cuda":
            host = volume.detach().contiguous().numpy()
            for o, s in self.slabs(n):
                with span("write", timers=split):
                    ddbvf.write_slices(path, host[o:o + s], z0 + o)
                count("ddbvf_bytes_written", host[o:o + s].nbytes)
            return n
        with torch.cuda.device(volume.device):
            self._drain_card(volume, path, z0, n, ready, split)
        return n

    def _drain_card(self, volume, path, z0, n, ready, split) -> None:
        stream = self._stream
        if ready is None:
            ready = torch.cuda.current_stream(volume.device).record_event()
        stream.wait_event(ready)
        # the allocator frees the accumulator only after the copy stream's
        # work queued by then, even if this drain raises mid-block
        volume.record_stream(stream)
        shape = (self.slices,) + self.slice_shape
        slabs = iter(self.slabs(n))
        inflight: collections.deque = collections.deque()

        def issue(o: int, s: int) -> None:
            slot = self._ring.acquire(shape, np.float32)
            try:
                done = torch.cuda.Event()
                dst = slot.buf.view(torch.float32).view(shape)[:s]
                with torch.cuda.stream(stream), \
                        span("d2h", device=True) as d2h:
                    dst.copy_(volume[o:o + s], non_blocking=True)
                    done.record(stream)
                slot.event = done
            except BaseException:
                slot.lock.release()
                raise
            count("d2h_bytes", dst.nbytes)
            inflight.append((slot, o, s, d2h, done))

        try:
            for o, s in itertools.islice(slabs, DRAIN_SLOTS):
                issue(o, s)
            while inflight:
                slot, o, s, d2h, done = inflight.popleft()
                try:
                    with span("copy_wait", timers=split):
                        done.synchronize()
                    seconds = d2h.device_seconds()
                    if split is not None and seconds is not None:
                        split.add("d2h", seconds)
                    with span("write", timers=split):
                        ddbvf.write_slices(path, slot.frames[:s], z0 + o)
                    count("ddbvf_bytes_written", slot.frames[:s].nbytes)
                finally:
                    slot.lock.release()
                nxt: Optional[Tuple[int, int]] = next(slabs, None)
                if nxt is not None:
                    issue(*nxt)
        finally:
            # a failed drain leaves copies in flight: their slots are
            # handed out again only after their events (``_Ring.acquire``)
            for slot, *_ in inflight:
                slot.lock.release()
