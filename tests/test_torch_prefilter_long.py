"""The score prefilter's pass over windows longer than the bitless kernels
take (porechop_tpu_torch/ops/dispatch.py: subwindow_overlap, subwindows,
AlignJobs._run_stats_prefiltered), on the CPU with the kernels' plain
versions.

A long window is scored in sub-windows of at most SCORE_RUNG bases that
overlap by W(A), derived from the scheme; a pair whose best sub-window
score stays below the bound is certified, the others re-run exactly.
Here mutated adapter copies sit across every sub-window cut (inside the
overlap, straddling its two edges) and at the window's two ends, under two
schemes the kernels take: the prefiltered run passes exactly the lanes
that the unprefiltered run and the JAX package pass, with equal values.

Tolerance: exact (integers, and percent identities from equal integers).
"""

import numpy as np
import pytest

from porechop_tpu.ops import dispatch as jax_dispatch
from porechop_tpu_torch.ops import dispatch, kernels
from porechop_tpu_torch.utils import spans

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

THRESHOLD = 90.0
# Porechop's default scheme, and one with a cheaper gap extension and a
# dearer match, whose overlap is five adapter rungs.
SCHEMES = [(3, -6, -5, -2), (4, -4, -6, -1)]
LENGTHS = (16_400, 24_700, 40_000)
PLACES = ('inside', 'before', 'after', 'ends')


def _mutate(rng, adapter, k):
    """A copy of adapter with k substitutions, and for odd k one inserted
    base besides (a gap in the adapter)."""
    a = adapter.copy()
    at = rng.choice(len(a), k, replace=False)
    a[at] = (a[at] + rng.integers(1, 4, k)) % 4
    if k % 2:
        pos = int(rng.integers(1, len(a) - 1))
        a = np.insert(a, pos, rng.integers(0, 4))
    return a


def _cut_jobs(scheme, seed=11):
    """Windows of LENGTHS bp, one for each place: mutated copies of one
    adapter inside every overlap of consecutive sub-windows, straddling
    the start of each later sub-window ('before') or the end of each
    earlier one ('after'), or at the window's first and last bases
    ('ends').  Copies carry 1-3 errors, so some pass the threshold and
    some fall just short of it.  Every window against every adapter."""
    rng = np.random.default_rng(seed)
    adapters = [rng.integers(0, 4, n).astype(np.int8) for n in (28, 24, 33)]
    amax = dispatch.bucket_adapter_len(max(len(a) for a in adapters))
    overlap = dispatch.subwindow_overlap(amax, scheme)
    windows = []
    for length in LENGTHS:
        (n,), (size,) = dispatch.subwindows([length], dispatch.SCORE_RUNG,
                                            overlap)
        assert n >= 2
        offs = [min(k * (size - overlap), length - size) for k in range(n)]
        for place in PLACES:
            w = rng.integers(0, 4, length).astype(np.int8)
            ai = len(windows) % len(adapters)
            copy = _mutate(rng, adapters[ai], 1 + len(windows) % 3)
            if place == 'ends':
                starts = [0, length - len(copy)]
            else:
                starts = [{'inside': nxt + (overlap - len(copy)) // 2,
                           'before': nxt - len(copy) // 2,
                           'after': prev + size - len(copy) // 2}[place]
                          for prev, nxt in zip(offs, offs[1:])]
            for s in starts:
                w[s:s + len(copy)] = copy
            windows.append(w)
    pairs = np.array([(w, a) for w in range(len(windows))
                      for a in range(len(adapters))], np.int64)
    return windows, adapters, pairs


@pytest.fixture
def long_trace_bit_lanes(monkeypatch):
    """Lanes of windows past SCORE_RUNG that the trace-bit forward's plain
    version takes (pad lanes are 1 base long)."""
    lanes = []
    plain = kernels.forward_tiled_plain

    def spy(reads, read_lens, *args):
        lanes.append(int((read_lens > dispatch.SCORE_RUNG).sum()))
        return plain(reads, read_lens, *args)
    monkeypatch.setattr(kernels, 'forward_tiled_plain', spy)
    return lanes


@pytest.mark.parametrize('scheme', SCHEMES, ids=['3,-6,-5,-2', '4,-4,-6,-1'])
def test_cut_adapters_pass_as_unprefiltered_and_jax(scheme,
                                                    long_trace_bit_lanes):
    """The prefiltered run passes the lanes the exact runs pass, with
    their full_pct, matches and full_len; the long pairs that reach the
    trace-bit forward in it are those planner.long_survivors counts, and
    every sub-window is a lane of the score pass."""
    windows, adapters, pairs = _cut_jobs(scheme)
    spans.begin_job(True)
    try:
        got = dispatch.AlignJobs(windows, adapters, pairs, scheme,
                                 device='cpu').run_stats(prefilter=THRESHOLD)
    finally:
        spans.end_job(True)
    counts = spans.last_jobs(1)[0]['counts']
    survivors_tiled = sum(long_trace_bit_lanes)
    exact = dispatch.AlignJobs(windows, adapters, pairs, scheme,
                               device='cpu').run_stats()
    want = jax_dispatch.AlignJobs(windows, adapters, pairs,
                                  scheme).run_stats()
    hit = want['full_pct'] >= THRESHOLD
    assert hit.any() and not hit.all()
    for res in (got, exact):
        assert np.array_equal(res['full_pct'] >= THRESHOLD, hit)
        for f in ('full_pct', 'matches', 'full_len'):
            assert np.array_equal(res[f][hit], want[f][hit]), f
    # Copies that pass the threshold sit at every place.
    by_window = hit.reshape(len(windows), -1).any(axis=1)
    assert by_window.reshape(len(LENGTHS), len(PLACES)).any(axis=0).all()
    amax = dispatch.bucket_adapter_len(max(len(a) for a in adapters))
    n, _ = dispatch.subwindows([len(w) for w in windows],
                               dispatch.SCORE_RUNG,
                               dispatch.subwindow_overlap(amax, scheme))
    assert counts['planner.subwindow_lanes'] == len(adapters) * n.sum()
    assert counts['planner.long_survivors'] == survivors_tiled
    assert hit.sum() <= survivors_tiled < len(pairs)


@pytest.mark.parametrize('scheme,amax,want', [
    ((3, -6, -5, -2), 96, 240), ((3, -6, -5, -2), 32, 80),
    ((4, -4, -6, -1), 48, 240), ((2, -3, -3, -2), 24, 48),
    ((3, -6, -5, 0), 96, None), ((0, -1, -5, -2), 96, None)])
def test_overlap_comes_from_the_scheme(scheme, amax, want):
    """W(A) = A + ceil(A x top / gmin), top the best column score and gmin
    the cheapest gap base; no overlap where a gap base costs nothing or no
    column scores above 0."""
    assert dispatch.subwindow_overlap(amax, scheme) == want


@pytest.mark.parametrize('length', [12_289, 16_384, 24_336, 24_337, 24_576,
                                    40_000, 111_433, 262_144])
@pytest.mark.parametrize('overlap', [48, 240, 1_280])
def test_subwindows_cover_the_window_with_the_overlap(length, overlap):
    """Sub-windows of at most SCORE_RUNG bases start at 0, end at the
    window's end, step forward and overlap by at least `overlap`, so any
    span of `overlap` bases lies whole inside one of them."""
    width = dispatch.SCORE_RUNG
    (n,), (size,) = dispatch.subwindows([length], width, overlap)
    offs = [min(k * (size - overlap), length - size) for k in range(n)]
    assert overlap < size <= width and offs[0] == 0
    assert offs[-1] + size == length
    assert all(b > a and a + size - b >= overlap
               for a, b in zip(offs, offs[1:]))
    rng = np.random.default_rng(length + overlap)
    for start in rng.integers(0, length - overlap + 1, 200):
        assert any(o <= start and start + overlap <= o + size for o in offs)
    if n > 1:
        # One sub-window fewer could not hold the window with the overlap.
        assert (n - 1) * width - (n - 2) * overlap < length


def test_vacuous_bound_keeps_the_trace_bit_route(monkeypatch):
    """Under a scheme whose gap extension costs nothing the prefilter's
    bound holds (coef > 0) but the overlap has none: long windows take the
    trace-bit forward in the score pass, as before, and no sub-window
    lane is launched; the passing lanes equal the exact run's."""
    scheme = (3, -6, -5, 0)
    assert kernels.score_prefilter_coef(THRESHOLD, *scheme) > 0
    rng = np.random.default_rng(3)
    adapters = [rng.integers(0, 4, 24).astype(np.int8)]
    windows = [rng.integers(0, 4, 13_000).astype(np.int8),
               rng.integers(0, 4, 900).astype(np.int8)]
    windows[0][12_500:12_524] = adapters[0]
    shapes = []
    for name in ('forward_score_plain', 'forward_tiled_plain'):
        def spy(reads, *args, _plain=getattr(kernels, name), _name=name):
            shapes.append((_name, reads.shape[1]))
            return _plain(reads, *args)
        monkeypatch.setattr(kernels, name, spy)
    pairs = np.array([(0, 0), (1, 0)], np.int64)
    spans.begin_job(True)
    try:
        got = dispatch.AlignJobs(windows, adapters, pairs, scheme,
                                 device='cpu').run_stats(prefilter=THRESHOLD)
    finally:
        spans.end_job(True)
    assert spans.last_jobs(1)[0]['counts'] == {}
    assert ('forward_tiled_plain', 16_384) in shapes
    assert ('forward_score_plain', dispatch.SCORE_RUNG) not in shapes
    want = dispatch.AlignJobs(windows, adapters, pairs, scheme,
                              device='cpu').run_stats()
    assert got['full_pct'][0] == want['full_pct'][0] == 100.0
