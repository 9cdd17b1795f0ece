"""The PyTorch port's batch planner (porechop_tpu_torch/ops/dispatch.py) and
device-resident replay (ops/middle.py), on the CPU, against the JAX
package's AlignJobs and ReplayRunner on the same jobs.  Tolerance: exact
(integers; percent identities are the same float64 round trip of equal
integers)."""

import numpy as np
import pytest

from porechop_tpu.ops import dispatch as jax_dispatch
from porechop_tpu.ops import middle as jax_middle
from porechop_tpu_torch.ops import dispatch, kernels, middle

from .test_torch_cases import FIELDS, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _jobs(seed=4):
    """Windows on three ladder rungs (150, 1024 and 2048: the last two
    past the group max's rung guard), an empty window, adapters on three
    adapter rungs, about a third of the windows carrying a mutated copy of
    an adapter."""
    rng = np.random.default_rng(seed)
    adapters = [rng.integers(0, 4, n).astype(np.int8)
                for n in (28, 22, 37, 24, 50)]
    windows = []
    for k in range(36):
        n = (150, 150, 900, 1800)[k % 4]
        w = rng.integers(0, 5 if k % 5 == 0 else 4, n).astype(np.int8)
        if k % 3 == 0:
            a = adapters[k % len(adapters)].copy()
            a[rng.integers(0, len(a), 2)] = rng.integers(0, 4, 2)
            pos = int(rng.integers(0, n - len(a)))
            w[pos:pos + len(a)] = a
        windows.append(w)
    windows.append(np.zeros(0, np.int8))
    pairs = np.array([(w, a) for w in range(len(windows))
                      for a in range(len(adapters))], np.int64)
    groups = (pairs[:, 0] % 3) * len(adapters) + pairs[:, 1]
    return windows, adapters, pairs, groups, 3 * len(adapters)


def _both(windows, adapters, pairs):
    return (dispatch.AlignJobs(windows, adapters, pairs, device='cpu'),
            jax_dispatch.AlignJobs(windows, adapters, pairs))


def test_run_matches_jax():
    windows, adapters, pairs, _, _ = _jobs()
    got, want = (j.run() for j in _both(windows, adapters, pairs))
    for f in FIELDS + ('read_end_excl',):
        assert np.array_equal(got[f], want[f]), f
    for f in ('full_pct', 'partial_pct'):
        assert np.array_equal(got[f], want[f], equal_nan=True), f


@pytest.mark.parametrize('prefilter', [None, 90.0])
def test_run_stats_matches_jax(prefilter):
    windows, adapters, pairs, _, _ = _jobs(5)
    got, want = (j.run_stats(prefilter=prefilter)
                 for j in _both(windows, adapters, pairs))
    assert np.array_equal(got['full_pct'], want['full_pct'])
    if prefilter is None:
        assert np.array_equal(got['matches'], want['matches'])
        assert np.array_equal(got['full_len'], want['full_len'])
    else:
        # Sub-threshold lanes' stats are not meaningful under a prefilter;
        # passing lanes' are exact.
        hit = want['full_pct'] >= prefilter
        assert hit.any()
        assert np.array_equal(got['matches'][hit], want['matches'][hit])
        assert np.array_equal(got['full_len'][hit], want['full_len'][hit])


def test_run_group_max_matches_jax():
    windows, adapters, pairs, groups, n_groups = _jobs(6)
    got, want = (j.run_group_max(groups, n_groups)
                 for j in _both(windows, adapters, pairs))
    for f in ('matches', 'full_len', 'full_pct'):
        assert np.array_equal(got[f], want[f]), f


def test_run_group_score_max_matches_jax():
    windows, adapters, pairs, groups, n_groups = _jobs(7)
    got, want = (j.run_group_score_max(groups, n_groups)
                 for j in _both(windows, adapters, pairs))
    assert np.array_equal(got, want)


def test_progress_covers_every_job():
    windows, adapters, pairs, _, _ = _jobs(8)
    seen = []
    dispatch.AlignJobs(windows, adapters, pairs, device='cpu').run(
        progress=lambda idx: seen.extend(np.asarray(idx).tolist()))
    assert sorted(seen) == list(range(len(pairs)))


def test_long_window_runs_and_matches_jax():
    """A 16,400 bp window (rung 24,576, past the single-tile forward) runs
    through the column-tiled forward and equals the JAX package."""
    rng = np.random.default_rng(9)
    adapter = [rng.integers(0, 4, 24).astype(np.int8)]
    window = rng.integers(0, 4, 16_400).astype(np.int8)
    window[15_000:15_024] = adapter[0]
    got, want = (j.run() for j in _both([window], adapter, [(0, 0)]))
    for f in FIELDS + ('read_end_excl', 'full_pct'):
        assert np.array_equal(got[f], want[f]), f
    assert got['read_start'][0] == 15_000 and got['full_pct'][0] == 100.0


@pytest.mark.parametrize('lb,amax', [(150, 32), (10_240, 48),
                                     (262_144, 32), (1_048_576, 64)])
def test_bits_lanes_fit_the_budget(lb, amax):
    """The widest power of two of lanes whose trace bits fit the cell
    budget and whose flat bit index stays below 2^31, or the minimum."""
    n = dispatch.bits_lanes(lb, amax)
    l1p = kernels.tiled_l1p(lb)

    def fits(k):
        return k * (lb + 1) * amax <= dispatch._CELL_BUDGET \
            and k * l1p * amax < 2 ** 31
    assert n >= dispatch._MIN_LANES and n & (n - 1) == 0
    assert n == dispatch._MIN_LANES or fits(n)
    assert not fits(2 * n)


def test_unported_shapes_and_schemes_raise():
    """Schemes the kernels do not take raise; no window length does."""
    adapter = [np.zeros(24, np.int8)]
    with pytest.raises(NotImplementedError, match='gap_open < gap_ext'):
        dispatch.AlignJobs([np.zeros(30, np.int8)], adapter, [(0, 0)],
                           scoring=(3, -6, -2, -2), device='cpu').run()


def test_replay_rounds_match_jax():
    """Two replay rounds (the second masking each lane's first-round hit
    in place on the device tensor) against the JAX ReplayRunner, plus the
    upload accounting: read data once, O(B) scalars per round."""
    rng = np.random.default_rng(3)
    adapters = [rng.integers(0, 4, 28).astype(np.int8),
                rng.integers(0, 4, 22).astype(np.int8)]
    reads = [rng.integers(0, 4, int(rng.integers(200, 900))).astype(np.int8)
             for _ in range(7)]
    for r in reads[:4]:
        pos = int(rng.integers(0, len(r) - 28))
        r[pos:pos + 28] = adapters[0]
    runner = middle.ReplayRunner(reads, adapters, device='cpu')
    jrunner = jax_middle.ReplayRunner(reads, adapters)
    a_idx = np.zeros(len(reads), np.int32)
    ms = np.zeros(len(reads), np.int32)
    me = np.zeros(len(reads), np.int32)
    for _ in range(2):
        got = runner.round(a_idx, ms, me)
        want = jrunner.round(a_idx, ms, me)
        for f in FIELDS + ('read_end_excl', 'full_pct'):
            assert np.array_equal(got[f], want[f]), f
        ms = np.where(got['read_start'] >= 0, got['read_start'],
                      0).astype(np.int32)
        me = got['read_end_excl'].astype(np.int32)
    assert runner.h2d_read_bytes == jrunner.h2d_read_bytes
    assert runner.h2d_round_bytes == jrunner.h2d_round_bytes
