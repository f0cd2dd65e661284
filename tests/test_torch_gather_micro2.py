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


def torch_inputs(which):
    """0: the benchmark's (k0, tab, idx); 1, 2: numpy-seeded ones with k0
    also past the table, negative and large idx and random tables.  A
    negative k0 is raised to 0 for both sides: XLA clamps it there, but
    the Pallas interpreter indexes as numpy does and wraps it."""
    if which == 0:
        return gm2.inputs()
    k0, tab, idx = gm2.seeded_inputs(which)
    return k0.clamp(min=0), tab, idx


@pytest.fixture(scope="module")
def jax_tile(ref):
    """(mode, which) -> the Pallas kernel's tile on the inputs
    ``torch_inputs(which)``, computed once per module.  The BlockSpecs of
    gather_micro2.py:82-93 with grid=(1,): every grid step writes the same
    block, so one step computes the same tile.  The kernel of a mode is
    traced once for all inputs."""
    kernels, tiles = {}, {}

    def get(mode, which=0):
        if mode not in kernels:
            kernels[mode] = jax.jit(pl.pallas_call(
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
                interpret=True))
        if (mode, which) not in tiles:
            k0, tab, idx = (jnp.asarray(t.numpy())
                            for t in torch_inputs(which))
            tiles[(mode, which)] = np.asarray(kernels[mode](k0, tab, idx))
        return tiles[(mode, which)]
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


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode", gm2.MODES)
def test_plain_matches_pallas_interpret(jax_tile, mode, which):
    got = gm2.gather_micro2_torch(mode, *torch_inputs(which))
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), jax_tile(mode, which))


def test_seeded_k0_leaves_the_table():
    k0, tab, idx = gm2.seeded_inputs(1)
    assert k0.dtype == tab.dtype == idx.dtype == torch.int32
    assert int(k0.min()) < 0 and int(k0.max()) >= gm2.K
    assert int(torch_inputs(1)[0].max()) >= gm2.K
    assert int(idx.min()) < -2**29 and int(idx.max()) > 2**29


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode", gm2.MODES)
def test_rep_windows_are_the_plain_versions(mode, which):
    """The windows the kernel copies per rep lie in the table, and are the
    ones the plain version reads: a table with every other window
    overwritten gives the same tile."""
    k0, tab, idx = (gm2.inputs() if which == 0
                    else gm2.seeded_inputs(which))
    wins = gm2.rep_windows(mode, k0)
    assert len(wins) == gm2.WINDOWS[mode]
    reps = torch.arange(gm2.REPS)
    kept = torch.full_like(tab, -7)
    for w in wins:
        assert w.shape == (gm2.REPS,)
        assert 0 <= int(w.min()) and int(w.max()) < gm2.K
        kept[reps % gm2.C, w.long()] = tab[reps % gm2.C, w.long()]
    assert torch.equal(gm2.gather_micro2_torch(mode, k0, kept, idx),
                       gm2.gather_micro2_torch(mode, k0, tab, idx))


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
