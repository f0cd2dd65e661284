"""A cell run on the card, as the driver runs it (marker ``cuda``: skips
without a card)."""

import json
import os
import subprocess
import sys

import pytest

from fdk_bench import run as R


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_block_cell_runs_correct_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "fdk_bench.run", "--workload",
         "c5-block-fast", "--seed", str(2 ** 31 + 101), "--seconds",
         "8", "--trace", str(trace)], cwd=R.ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "compared"
    want = {m["name"] for m in R.cell_metrics(
        R.load_json(os.path.join(R.ROOT, "BENCHMARK.json")),
        "c5-block-fast", bool(trace))}
    assert set(res["metrics"]) == want


@pytest.mark.cuda
def test_job_driver_runs_correct_on_the_card(card):
    """The job driver, kept for the job cells left for later, on the
    card at the align sweep's sizes."""
    import torch
    res = R.run_cell(R.load_json(R.find("config", "rabbitct-1248x960")),
                     R.load_json(R.find("traffic", "align-sweep-q8")), [],
                     seed=2 ** 31 + 103, seconds=3, trace=True,
                     backend="cuda", device=torch.device("cuda", 0))
    assert res["correct"] and res["attempted"] > 10
