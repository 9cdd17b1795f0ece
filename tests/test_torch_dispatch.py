"""The PyTorch port's batch planner (porechop_tpu_torch/ops/dispatch.py) and
device-resident replay (ops/middle.py), on the CPU, against the JAX
package's AlignJobs and ReplayRunner on the same jobs.  Tolerance: exact
(integers; percent identities are the same float64 round trip of equal
integers)."""

import numpy as np
import pytest

from porechop_tpu.ops import dispatch as jax_dispatch
from porechop_tpu.ops import middle as jax_middle
from porechop_tpu.ops import spec as jax_spec
from porechop_tpu_torch.ops import dispatch, kernels, middle
from porechop_tpu_torch.parallel import mesh

from .test_torch_cases import (FIELDS, MODES, align_jobs, one_torch_thread,
                               run_mode)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# Cell budgets small enough that the planner's buckets cut into several
# launches: 32 lanes of rung 150 at adapter rung 24 a trace-bit launch, 32
# of rung 150 at adapter rung 64 a bitless one.
SMALL = {'_CELL_BUDGET': 32 * 151 * 24, '_GM_CELL_BUDGET': 32 * 151 * 64}


def _both(windows, adapters, pairs):
    return (dispatch.AlignJobs(windows, adapters, pairs, device='cpu'),
            jax_dispatch.AlignJobs(windows, adapters, pairs))


def test_run_matches_jax():
    windows, adapters, pairs, _, _ = align_jobs()
    got, want = (j.run() for j in _both(windows, adapters, pairs))
    for f in FIELDS + ('read_end_excl',):
        assert np.array_equal(got[f], want[f]), f
    for f in ('full_pct', 'partial_pct'):
        assert np.array_equal(got[f], want[f], equal_nan=True), f


@pytest.mark.parametrize('prefilter', [None, 90.0])
def test_run_stats_matches_jax(prefilter):
    windows, adapters, pairs, _, _ = align_jobs(5)
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
    windows, adapters, pairs, groups, n_groups = align_jobs(6)
    got, want = (j.run_group_max(groups, n_groups)
                 for j in _both(windows, adapters, pairs))
    for f in ('matches', 'full_len', 'full_pct'):
        assert np.array_equal(got[f], want[f]), f


def test_run_group_score_max_matches_jax():
    windows, adapters, pairs, groups, n_groups = align_jobs(7)
    got, want = (j.run_group_score_max(groups, n_groups)
                 for j in _both(windows, adapters, pairs))
    assert np.array_equal(got, want)


def test_progress_covers_every_job():
    windows, adapters, pairs, _, _ = align_jobs(8)
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


@pytest.mark.parametrize('scoring', [(3, -6, -2, -5), (2, -3, -3, -3)])
@pytest.mark.parametrize('mode', MODES)
def test_unported_shapes_and_schemes_raise(scoring, mode, monkeypatch):
    """Nothing raises for a scheme any more: the route is chosen by the
    scheme.  A scheme the kernels refuse (Gotoh with gap_open > gap_ext,
    and linear) runs on the host, launches no kernel and no plain version,
    and gives the JAX package's results in every mode (under the
    prefilter, which lanes pass and their values), and in the full run
    the executable spec's."""
    rng = np.random.default_rng(12)
    adapters = [rng.integers(0, 4, n).astype(np.int8) for n in (24, 18)]
    windows = [rng.integers(0, 5, n).astype(np.int8) for n in (60, 90, 40)]
    windows[1][30:54] = adapters[0]
    windows.append(np.zeros(0, np.int8))
    pairs = np.array([(w, a) for w in range(4) for a in range(2)], np.int64)
    groups = pairs[:, 1]

    def refused(*args):
        raise AssertionError('a kernel ran for %s' % (scoring,))
    for name in kernels.LAUNCHES:
        monkeypatch.setattr(kernels, name, refused)
        monkeypatch.setattr(kernels, name + '_plain', refused)
    port = dispatch.AlignJobs(windows, adapters, pairs, scoring, device='cpu')
    jax = jax_dispatch.AlignJobs(windows, adapters, pairs, scoring)
    args = (groups, 2) if mode.startswith('run_group') else ()
    if mode == 'run_stats_prefilter':
        got, want = (j.run_stats(prefilter=90.0) for j in (port, jax))
    else:
        got, want = (getattr(j, mode)(*args) for j in (port, jax))
    if not isinstance(got, dict):
        got, want = {'': got}, {'': want}
    assert set(got) == set(want)
    hit = ...
    if mode == 'run_stats_prefilter':
        hit = want['full_pct'] >= 90.0
        assert hit.any() and not hit.all()
        assert np.array_equal(got['full_pct'] >= 90.0, hit)
    for f in got:
        assert np.array_equal(got[f][hit], want[f][hit], equal_nan=True), f
    if mode != 'run':
        return
    codes = 'ACGTN'
    for k, (w, a) in enumerate(pairs[:-2]):
        s = jax_spec.align_stats(''.join(codes[c] for c in windows[w]),
                                 ''.join(codes[c] for c in adapters[a]),
                                 scoring)
        assert [got[f][k] for f in FIELDS] == [getattr(s, f) for f in FIELDS]


def _rung_jobs(amax, seed):
    """AlignJobs inputs whose adapters all pad to adapter rung amax (16:
    9 to 16 bases; 96: 65 to 96), against windows of rungs 150 and 1,024,
    one of them empty, a third carrying a copy of an adapter with one
    base in twenty (at least one) drawn anew."""
    rng = np.random.default_rng(seed)
    lens = (9, 16, 13) if amax == 16 else (96, 65, 81)
    adapters = [rng.integers(0, 4, n).astype(np.int8) for n in lens]
    windows = []
    for k in range(12):
        n = (150, 1000)[k % 2]
        w = rng.integers(0, 5 if k % 5 == 0 else 4, n).astype(np.int8)
        if k % 3 == 0:
            a = adapters[k % len(adapters)].copy()
            m = max(1, len(a) // 20)
            a[rng.integers(0, len(a), m)] = rng.integers(0, 4, m)
            pos = int(rng.integers(0, n - len(a)))
            w[pos:pos + len(a)] = a
        windows.append(w)
    windows.append(np.zeros(0, np.int8))
    pairs = np.array([(w, a) for w in range(len(windows))
                      for a in range(len(adapters))], np.int64)
    assert {dispatch.bucket_adapter_len(n) for n in lens} == {amax}
    groups = (pairs[:, 0] % 3) * len(adapters) + pairs[:, 1]
    return windows, adapters, pairs, groups, 3 * len(adapters)


@pytest.mark.parametrize('amax', [16, 96])
@pytest.mark.parametrize('mode', MODES)
def test_modes_at_adapter_rungs_match_jax(mode, amax):
    """Every planner mode on the CPU entries at adapter rung 16 (the
    narrowest) and 96 (the barcoded sets' rung) equals the JAX package's
    planner; under the prefilter, the passing lanes' values."""
    jobs = _rung_jobs(amax, amax + len(mode))
    got = run_mode(mode, jobs, 'cpu')
    want = run_mode(mode, jobs, None, jax_dispatch.AlignJobs)
    assert set(got) == set(want)
    hit = ...
    if mode == 'run_stats_prefilter':
        hit = want['full_pct'] >= 90.0
        assert hit.any() and not hit.all()
        assert np.array_equal(got['full_pct'] >= 90.0, hit)
    for f in got:
        assert np.array_equal(got[f][hit], want[f][hit], equal_nan=True), f


def _count_launches(monkeypatch):
    """Counters of the launches each package's planner enqueues: the
    port's mesh.launch_shards calls and the JAX package's chunk launches
    (with its size route off, every chunk is one)."""
    counts = {'port': 0, 'jax': 0}

    def spy(owner, name, key):
        fn = getattr(owner, name)

        def call(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(owner, name, call)
    spy(mesh, 'launch_shards', 'port')
    spy(jax_dispatch.AlignJobs, '_launch_chunk_gather', 'jax')
    spy(jax_dispatch.AlignJobs, '_run_chunk', 'jax')
    # As the port plans: no size route, no work share with the native
    # engine and no adapter-rung merge.
    monkeypatch.setattr(jax_dispatch.AlignJobs, '_native_available',
                        lambda self: False)
    monkeypatch.setattr(jax_dispatch.AlignJobs, '_MERGE_CELLS_PER_LAUNCH', 0)
    return counts


def _jobs(seed):
    """align_jobs' windows of rungs 150 and 1,024 (and the empty one), each
    twice, against its adapters of rungs 24 and 32: four buckets of 18 to
    72 jobs, a few launch shapes for the JAX package to compile."""
    windows, adapters, _, _, _ = align_jobs(seed)
    windows = [w for w in windows if len(w) <= 1024] * 2
    adapters = [a for a in adapters if len(a) <= 32]
    pairs = np.array([(w, a) for w in range(len(windows))
                      for a in range(len(adapters))], np.int64)
    groups = (pairs[:, 0] % 3) * len(adapters) + pairs[:, 1]
    return windows, adapters, pairs, groups, 3 * len(adapters)


@pytest.mark.parametrize('mode', MODES)
def test_small_budgets_launch_as_jax_chunks(monkeypatch, mode):
    """Under small cell budgets each mode's planner makes as many launches
    as the JAX package's planner makes chunks under the same budgets, more
    than under the default budgets, and the same results."""
    counts = _count_launches(monkeypatch)
    jobs = _jobs(7)
    default = run_mode(mode, jobs, 'cpu')
    n_default = counts['port']
    for name, value in SMALL.items():
        for mod in (dispatch, jax_dispatch):
            monkeypatch.setattr(mod, name, value)
    counts.update(port=0, jax=0)
    got = run_mode(mode, jobs, 'cpu')
    want = run_mode(mode, jobs, None, jax_dispatch.AlignJobs)
    assert counts['port'] == counts['jax'] > n_default, (counts, n_default)
    for f, v in want.items():
        assert np.array_equal(got[f], v, equal_nan=True), f
        assert np.array_equal(got[f], default[f], equal_nan=True), f


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
