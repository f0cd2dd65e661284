"""The benchmark's CPU tests: torch on one thread, JAX kept on the CPU
where a test compares with the JAX package."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {"name": "tiny", "scan": {
    "n_row": 48, "n_col": 40, "l_px_row": 1.0, "l_px_col": 1.0,
    "delta_s": 0.0, "delta_t": 0.0, "d_so": 200.0, "d_od": 100.0,
    "n_proj": 32, "orbit_deg": 360.0, "number_type": "uint16",
    "frames_per_file": 8}}


LIMITS = {"block-pass-fast": 1e-3, "block-pass-exact": 2e-5,
          "roi-column-q1": 4e-4, "align-sweep-q8": 1.5e-3}


def tiny_mix(name: str, **changes) -> dict:
    """A mix of the benchmark cut to the tiny scan's sizes, with a limit of
    the tiny size's own (the card's limits come from the card's readings
    at the cells' sizes).  On the CPU at three seeds the sound program
    reads / the control reads: block fast 1.2-2.2e-4 / 2.9-3.0e-3, block
    exact 4.5-4.7e-7 / 1.8-1.9e-4 (bfloat16), column 7.7-8.0e-5 /
    1.16-1.25e-3, align 3.1-3.5e-4 / 3.9-5.6e-3."""
    import json
    with open(os.path.join(ROOT, "fdk_bench", "traffic", name + ".json")) as f:
        mix = json.load(f)
    cuts = {"block-pass-fast": dict(block_dz=8, sample_voxels=4096,
                                    chunk_size=8),
            "block-pass-exact": dict(block_dz=8, sample_voxels=4096,
                                     chunk_size=8),
            "roi-column-q1": dict(roi={"xy": 8, "z": "all"}, chunk_size=8),
            "align-sweep-q8": dict(roi={"xy": 16, "z": 2}, quality=2,
                                   chunk_size=8)}
    mix.update(cuts[name])
    mix["limits"] = {"rel_rmse": LIMITS[name]}
    mix.update(changes)
    return mix
