"""The plain version of the K3b gather micro-benchmark
(paris_tpu_torch/benchmarks/gather_micro2.py) against the Pallas kernel of
benchmarks/gather_micro2.py, run in interpret mode (CPU torch, CPU JAX).
Tolerance: exact int32 equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paris_tpu_torch.benchmarks import gather_micro2 as gm2
from test_torch_gather_micro import load_reference


@pytest.fixture(scope="module")
def ref():
    return load_reference("gather_micro2")


@pytest.fixture(scope="module")
def jax_tile(ref):
    """mode -> the Pallas kernel's tile, computed once per module.  The
    BlockSpecs of gather_micro2.py:82-93 with grid=(1,): every grid step
    writes the same block, so one step computes the same tile."""
    k0, tab, idx = (jnp.asarray(t.numpy()) for t in gm2.inputs())
    tiles = {}

    def get(mode):
        if mode not in tiles:
            f = pl.pallas_call(
                ref.make_kernel(mode), grid=(1,),
                in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                          pl.BlockSpec((gm2.C, gm2.K, 64, 128),
                                       lambda i: (0, 0, 0, 0),
                                       memory_space=pltpu.VMEM),
                          pl.BlockSpec((64, 128), lambda i: (0, 0),
                                       memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec((64, 128), lambda i: (0, 0),
                                       memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((64, 128), jnp.int32),
                interpret=True)
            tiles[mode] = np.asarray(f(k0, tab, idx))
        return tiles[mode]
    return get


def test_constants_and_inputs_match_reference(ref):
    assert (gm2.REPS, gm2.C, gm2.K) == (ref.REPS, ref.C, ref.K)
    k0, tab, idx = gm2.inputs()
    np.testing.assert_array_equal(
        k0.numpy(), np.random.default_rng(1).integers(0, ref.K - 2,
                                                      (ref.REPS,)))
    np.testing.assert_array_equal(
        tab.numpy(), np.arange(ref.C * ref.K * 64 * 128, dtype=np.int32)
        .reshape(ref.C, ref.K, 64, 128))
    np.testing.assert_array_equal(
        idx.numpy(), np.random.default_rng(0).integers(0, 255, (64, 128)))


@pytest.mark.parametrize("mode", gm2.MODES)
def test_plain_matches_pallas_interpret(jax_tile, mode):
    got = gm2.gather_micro2_torch(mode, *gm2.inputs())
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), jax_tile(mode))


def test_chain_window_matches_numpy_f32():
    """The scalar chain, step by step in NumPy float32, for every k0 the
    benchmark can draw and its neighbours."""
    k0 = np.arange(-4, gm2.K + 4, dtype=np.int32)
    k0 = np.concatenate([k0, k0[::-1], k0])[:gm2.REPS]
    s0, s1 = k0.astype(np.float32), np.roll(k0, -1).astype(np.float32)
    f = np.float32
    a = np.minimum(np.minimum(s0 * f(1.01), s0 * f(1.02)),
                   np.minimum(s1 * f(1.01), s1 * f(1.02)))
    b = (a - f(3.0)) * f(0.25) - f(0.5)
    kr = (np.floor(b).astype(np.int32) - 1) >> 6
    want = np.clip(kr + k0, 0, gm2.K - 3)
    np.testing.assert_array_equal(
        gm2.chain_window(torch.from_numpy(k0)).numpy(), want)


def test_plain_clamps_windows_into_the_table():
    """k0 past the table reads its last window, as XLA clamps a dynamic
    slice."""
    k0, tab, idx = gm2.inputs()
    last = torch.full_like(k0, gm2.K - 1)
    want = gm2.gather_micro2_torch("dyn_read", last, tab, idx)
    got = gm2.gather_micro2_torch("dyn_read", last + 7, tab, idx)
    assert torch.equal(got, want)


def test_plain_refuses_unknown_mode_or_shape():
    k0, tab, idx = gm2.inputs()
    with pytest.raises(ValueError, match="unknown mode"):
        gm2.gather_micro2_torch("dyn_take3", k0, tab, idx)
    with pytest.raises(ValueError, match="int32"):
        gm2.gather_micro2_torch("dyn_take", k0[:8], tab, idx)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back to the plain version."""
    before = gm2.gather_micro2_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gm2.gather_micro2_cuda("dyn_take", *gm2.inputs())
    assert gm2.gather_micro2_cuda.launches == before


def test_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        gm2.run("empty")
