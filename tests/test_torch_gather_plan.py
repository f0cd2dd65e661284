"""The band plans of the K3a and K3b gather kernels
(paris_tpu_torch/benchmarks/gather_micro.py:plan_band,
gather_micro2.py:plan_ring): every plan is one the card can launch, and a
band computed from only the table rows its block stages equals the plain
version's rows, so the staging reads enough.  CPU torch only; tolerance:
int32 equality."""

import pytest
import torch

from paris_tpu_torch.benchmarks import gather_micro as gm
from paris_tpu_torch.benchmarks import gather_micro2 as gm2

K3A_CASES = [("empty", 32)] + list(gm.CASES)
POISON = -123456789        # what a row the block did not stage holds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on few
    cores, and a full OpenMP pool in each of them oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def k3a_inputs(which):
    """0: the benchmark's inputs; else seeded ones (negative and large
    idx, random tables)."""
    return gm.inputs() if which == 0 else gm.seeded_inputs(which)


def k3b_inputs(which):
    """As k3a_inputs; the seeded k0 also lies outside [0, K)."""
    return gm2.inputs() if which == 0 else gm2.seeded_inputs(which)


def staged_tables(mode, S, tab, i0, rows, drop=0):
    """The (C, 128, 128) tables as the block of rows [i0, i0 + rows)
    holds them: the rows ``staged_rows`` names (less the last ``drop`` of
    each range), poison elsewhere."""
    staged = torch.full_like(tab, POISON)
    for r in gm.staged_rows(mode, S, i0, rows):
        staged[:, r.start:r.stop - drop] = tab[:, r.start:r.stop - drop]
    return staged


def banded_k3a(mode, S, tab, idx, plan, drop=0):
    """The tile, each band computed from its block's staged rows only."""
    bands = []
    for i0 in range(0, gm.ROWS, plan.rows):
        staged = staged_tables(mode, S, tab, i0, plan.rows, drop)
        bands.append(gm.gather_micro_torch(mode, S, staged, idx)
                     [i0:i0 + plan.rows])
    return torch.cat(bands)


def banded_k3b(mode, k0, tab, idx, plan, skip_second=False):
    """The tile, each band computed from only the window bands its block
    copies through the ring: rows [i0, i0 + rows) of tab[r % C, w[r]] for
    every rep r and each w of ``rep_windows``."""
    reps = torch.arange(gm2.REPS)
    wins = gm2.rep_windows(mode, k0)
    bands = []
    for i0 in range(0, gm.ROWS, plan.rows):
        staged = torch.full_like(tab, POISON)
        for w in wins[:1] if skip_second else wins:
            staged[reps % gm2.C, w.long(), i0:i0 + plan.rows] = \
                tab[reps % gm2.C, w.long(), i0:i0 + plan.rows]
        bands.append(gm2.gather_micro2_torch(mode, k0, staged, idx)
                     [i0:i0 + plan.rows])
    return torch.cat(bands)


def check_launchable(plan, per):
    assert gm.ROWS % plan.rows == 0 and plan.rows % per == 0
    assert plan.threads == plan.rows // per * gm.COLS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert 0 <= plan.smem <= 232_448 and plan.smem % 16 == 0


@pytest.mark.parametrize("mode,S", K3A_CASES)
def test_k3a_plan_is_launchable(mode, S):
    plan = gm.plan_band(mode, S)
    check_launchable(plan, gm.PER[mode])
    assert plan.threads <= gm.MODE_MAX_THREADS.get(mode, gm.MAX_THREADS)
    staged = sum(len(r) for r in gm.staged_rows(mode, S, 0, plan.rows))
    assert plan.smem == gm.C * staged * gm.COLS * 4
    if mode in ("lane", "lane2"):
        # six blocks and their static shared memory share an SM
        assert 6 * (plan.smem + 1024) <= 233_472
    if mode in gm.WINDOWS:
        # staging moves at most an eighth of the words the block gathers
        assert plan.smem * 8 <= plan.rows * gm.COLS * 4 * gm.REPS


@pytest.mark.parametrize("mode", gm2.MODES)
def test_k3b_plan_is_launchable(mode):
    plan = gm2.plan_ring(mode)
    check_launchable(plan, gm2.PER)
    stage = gm2.WINDOWS[mode] * plan.rows * gm.COLS * 4
    assert plan.smem == gm2.RING * stage
    assert stage % 16 == 0 and (plan.rows * gm.COLS * 4) % 16 == 0
    assert gm2.RING >= 2


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode,S", K3A_CASES)
def test_k3a_banded_emulation_equals_plain(mode, S, which):
    tab, idx = k3a_inputs(which)
    want = gm.gather_micro_torch(mode, S, tab, idx)
    got = banded_k3a(mode, S, tab, idx, gm.plan_band(mode, S))
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("mode", gm2.MODES)
def test_k3b_banded_emulation_equals_plain(mode, which):
    k0, tab, idx = k3b_inputs(which)
    want = gm2.gather_micro2_torch(mode, k0, tab, idx)
    got = banded_k3b(mode, k0, tab, idx, gm2.plan_ring(mode))
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("mode,S,rows", [
    ("lane", 128, 4), ("lane", 128, 32), ("lane2", 128, 8),
    ("lane2", 128, 16), ("sublane", 8, 32), ("sublane", 32, 4),
    ("select", 16, 8), ("select", 24, 16)])
def test_k3a_other_bands_stage_enough(mode, S, rows):
    """A forced band is planned like the default one."""
    plan = gm.plan_band(mode, S, rows=rows)
    assert plan.rows == rows
    check_launchable(plan, gm.PER[mode])
    tab, idx = gm.seeded_inputs(3)
    assert torch.equal(banded_k3a(mode, S, tab, idx, plan),
                       gm.gather_micro_torch(mode, S, tab, idx))


@pytest.mark.parametrize("mode,rows", [("dyn_take2", 4), ("chain_take2", 16),
                                       ("dyn_read", 32), ("static_take", 32)])
def test_k3b_other_bands_stage_enough(mode, rows):
    plan = gm2.plan_ring(mode, rows=rows)
    assert plan.rows == rows
    check_launchable(plan, gm2.PER)
    k0, tab, idx = gm2.seeded_inputs(3)
    assert torch.equal(banded_k3b(mode, k0, tab, idx, plan),
                       gm2.gather_micro2_torch(mode, k0, tab, idx))


@pytest.mark.parametrize("mode,S", [("lane", 128), ("lane2", 128),
                                    ("sublane", 16), ("select", 24)])
def test_k3a_emulation_notices_a_row_not_staged(mode, S):
    """The emulation has teeth: with one staged row fewer per range the
    tile is wrong."""
    tab, idx = gm.seeded_inputs(1)
    got = banded_k3a(mode, S, tab, idx, gm.plan_band(mode, S), drop=1)
    assert not torch.equal(got, gm.gather_micro_torch(mode, S, tab, idx))


@pytest.mark.parametrize("mode", ["dyn_take2", "chain_take2"])
def test_k3b_emulation_notices_a_window_not_copied(mode):
    k0, tab, idx = gm2.inputs()
    got = banded_k3b(mode, k0, tab, idx, gm2.plan_ring(mode),
                     skip_second=True)
    assert not torch.equal(got, gm2.gather_micro2_torch(mode, k0, tab, idx))


def test_planners_refuse_what_no_kernel_runs():
    with pytest.raises(ValueError, match="unknown mode"):
        gm.plan_band("texture")
    with pytest.raises(ValueError, match="S in"):
        gm.plan_band("sublane", 24)
    with pytest.raises(ValueError, match="no block of 48 rows"):
        gm.plan_band("lane", 128, rows=48)          # does not divide 64
    with pytest.raises(ValueError, match="no block of 4 rows"):
        gm.plan_band("select", 8, rows=4)           # a thread owns 8 rows
    with pytest.raises(ValueError, match="2048 threads"):
        gm.plan_band("lane", 128, rows=64)
    with pytest.raises(ValueError, match="1024 threads"):
        gm.plan_band("select", 32, rows=64)         # select's blocks: 512
    with pytest.raises(ValueError, match="262144 B"):
        gm.plan_band("lane2", 128, rows=32)         # above a block's 227 KB
    with pytest.raises(ValueError, match="unknown mode"):
        gm2.plan_ring("dyn_take3")
    with pytest.raises(ValueError, match="no block of 2 rows"):
        gm2.plan_ring("dyn_take", rows=2)


def test_shared_memory_floors():
    """k3_compare's floor: the words a tile's gather loads and stages over
    132 SMs x 32 words a clock; select's is its compares."""
    from paris_tpu_torch.benchmarks.k3_compare import (smem_floor_ns,
                                                       smem_words)
    clock = 1980.0
    per_ns = 132 * 1.98
    assert smem_words("K3a", "lane", 128) == (1.0, 0.125)
    assert smem_words("K3a", "empty", 32) == (0.0, 0.0)
    assert smem_words("K3b", "dyn_take2", 0) == (1.0, 2.0)
    ns, by = smem_floor_ns("K3a", "lane", 128, clock)
    assert by == "shared memory"
    assert ns == pytest.approx(8192 * 1.125 / (32 * per_ns))
    ns, by = smem_floor_ns("K3b", "dyn_take", 0, clock)
    assert ns == pytest.approx(8192 * 2 / (32 * per_ns))
    ns, by = smem_floor_ns("K3a", "select", 32, clock)
    assert by == "compares"
    assert ns == pytest.approx(8192 * 2 * 32 / (64 * per_ns))
    assert smem_floor_ns("K3b", "chain_only", 0, clock)[0] == 0.0


def test_ptxas_report_names_the_gather_kernels():
    from paris_tpu_torch.benchmarks.k3_compare import ptxas_report
    log = """
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__abc10gm1_kernelILi4ELi32EEEvPKiS2_Pii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__abc10gm1_kernelILi4ELi32EEEvPKiS2_Pii
    40 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__abc10gm2_kernelILi5EEEvPKiS2_S2_Pii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 512 bytes smem
ptxas info    : Compiling entry function '_Z9bp_kernelIfLi8ELi16ELi1EEvPfPKT_PKfS6_8BpParams' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers
"""
    assert ptxas_report(log) == {("K3a", 4, 32): (64, 36),
                                 ("K3b", 5, 0): (40, 0)}
