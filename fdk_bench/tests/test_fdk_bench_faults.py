"""A run with the timed path broken underneath reads ``correct`` false;
a sound run, true; and the control (the plain reference in the mix's
lower precision, in the program's place) false.  Each drives the whole
of a run at a tiny size on the CPU, the look for a card skipped.  The
cells run on one card, so no exchange between cards can be left out."""

import json
import os

import numpy as np
import pytest
import torch

from fdk_bench import run as R
from fdk_bench.tests.conftest import TINY, tiny_mix

MIXES = ["block-pass-fast", "block-pass-exact", "roi-column-q1",
         "align-sweep-q8"]


def _run(mix_name, control=None, seed=2 ** 31 + 77):
    return R.run_cell(TINY, tiny_mix(mix_name), [], seed=seed, seconds=0.3,
                      trace=False, backend="torch", device="cpu",
                      control=control)


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from paris_tpu_torch import pipeline
    monkeypatch.setattr(pipeline.Reconstructor, "step_staged",
                        lambda self, volume, staged, **kw: volume)


def _half(monkeypatch):
    """Half of each chunk's projections left out, the rest counted
    twice (the mean taken over the rest)."""
    from paris_tpu_torch import pipeline
    orig = pipeline.backproject_chunk

    def half(volume, filtered, sin, cos, grid, **kw):
        return orig(volume, (2 * filtered[::2]).to(filtered.dtype),
                    sin[::2], cos[::2], grid, **kw)
    monkeypatch.setattr(pipeline, "backproject_chunk", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: one slice of each block
    the program hands out (``finalize``: its first) or writes (the
    drain's pwrite: the slab's middle one) offset by a tenth of the
    block's largest magnitude."""
    from paris_tpu_torch import pipeline
    from paris_tpu_torch.io import ddbvf
    fin, write = pipeline.Reconstructor.finalize, ddbvf.write_slices

    def finalize(self, volume):
        out = fin(self, volume).copy()
        out[0] += 0.1 * np.abs(out).max()
        return out

    def write_slices(path, volume, first):
        volume = np.array(volume, copy=True)
        volume[len(volume) // 2] += 0.1 * np.abs(volume).max()
        return write(path, volume, first)
    monkeypatch.setattr(pipeline.Reconstructor, "finalize", finalize)
    monkeypatch.setattr(ddbvf, "write_slices", write_slices)


@pytest.mark.parametrize("mix", MIXES)
def test_a_sound_run_is_correct(mix):
    res = _run(mix)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert json.dumps(res)


@pytest.mark.parametrize("mix", MIXES)
def test_the_control_is_not_correct(mix):
    res = _run(mix, control=tiny_mix(mix)["control"])
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("mix", MIXES)
def test_a_broken_timed_path_is_not_correct(mix, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(mix)
    assert not res["correct"], res["compared"]
