"""The plain version of the K3a gather micro-benchmark
(paris_tpu_torch/benchmarks/gather_micro.py) against the Pallas kernel of
benchmarks/gather_micro.py, run in interpret mode (CPU torch, CPU JAX).
Tolerance: exact int32 equality."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paris_tpu_torch.benchmarks import gather_micro as gm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_reference(name):
    """``benchmarks/`` is no package: load one of its modules by path."""
    spec = importlib.util.spec_from_file_location(
        f"_{name}_reference", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return load_reference("gather_micro")


def torch_inputs(which):
    """0: the benchmark's (tab, idx); 1, 2: numpy-seeded ones with negative
    and large idx and random tables."""
    return gm.inputs() if which == 0 else gm.seeded_inputs(which)


@pytest.fixture(scope="module")
def jax_tile(ref):
    """(mode, S, which) -> the Pallas kernel's tile on the inputs
    ``torch_inputs(which)``, computed once per module.  The BlockSpecs of
    gather_micro.py:86-96 with grid=(1,): every grid step writes the same
    block, so one step computes the same tile.  The kernel of a (mode, S)
    is traced once for all inputs."""
    kernels, tiles = {}, {}

    def get(mode, S, which=0):
        if (mode, S) not in kernels:
            kernels[(mode, S)] = jax.jit(pl.pallas_call(
                ref.make_kernel(mode, S), grid=(1,),
                in_specs=[pl.BlockSpec((gm.C, 128, 128), lambda i: (0, 0, 0),
                                       memory_space=pltpu.VMEM),
                          pl.BlockSpec((64, 128), lambda i: (0, 0),
                                       memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec((64, 128), lambda i: (0, 0),
                                       memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((64, 128), jnp.int32),
                interpret=True))
        if (mode, S, which) not in tiles:
            tab, idx = (jnp.asarray(t.numpy()) for t in torch_inputs(which))
            tiles[(mode, S, which)] = np.asarray(
                kernels[(mode, S)](tab, idx))
        return tiles[(mode, S, which)]
    return get


def test_constants_and_inputs_match_reference(ref):
    assert (gm.REPS, gm.C) == (ref.REPS, ref.C)
    tab, idx = gm.inputs()
    np.testing.assert_array_equal(
        tab.numpy(),
        np.arange(ref.C * 128 * 128, dtype=np.int32).reshape(ref.C, 128, 128))
    np.testing.assert_array_equal(
        idx.numpy(), np.random.default_rng(0).integers(0, 255, (64, 128)))
    assert tab.dtype == idx.dtype == torch.int32


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode,S", [("empty", 32)] + list(gm.CASES))
def test_plain_matches_pallas_interpret(jax_tile, mode, S, which):
    got = gm.gather_micro_torch(mode, S, *torch_inputs(which))
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), jax_tile(mode, S, which))


def test_seeded_inputs_are_negative_and_large():
    tab, idx = gm.seeded_inputs(1)
    assert tab.dtype == idx.dtype == torch.int32
    assert tab.shape == (gm.C, 128, 128) and idx.shape == (64, 128)
    assert int(idx.min()) < -2**29 and int(idx.max()) > 2**29
    assert not torch.equal(idx, gm.seeded_inputs(2)[1])


@pytest.mark.parametrize("S", [8, 16, 32])
def test_select_ladder_equals_sublane_gather(jax_tile, S):
    np.testing.assert_array_equal(jax_tile("select", S),
                                  jax_tile("sublane", S))
    tab, idx = gm.inputs()
    assert torch.equal(gm.gather_micro_torch("select", S, tab, idx),
                       gm.gather_micro_torch("sublane", S, tab, idx))


def test_plain_refuses_unknown_mode_window_or_shape():
    tab, idx = gm.inputs()
    with pytest.raises(ValueError, match="unknown mode"):
        gm.gather_micro_torch("texture", 8, tab, idx)
    with pytest.raises(ValueError, match="S in"):
        gm.gather_micro_torch("sublane", 24, tab, idx)
    with pytest.raises(ValueError, match="int32"):
        gm.gather_micro_torch("lane", 128, tab.long(), idx)
    with pytest.raises(ValueError, match="int32"):
        gm.gather_micro_torch("lane", 128, tab, idx[:32])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back to the plain version."""
    tab, idx = gm.inputs()
    before = gm.gather_micro_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gm.gather_micro_cuda("lane", 128, tab, idx)
    assert gm.gather_micro_cuda.launches == before


def test_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        gm.run("empty")
