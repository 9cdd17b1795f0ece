"""The planner's product form (porechop_tpu_torch/ops/dispatch.Product) on
the CPU.  The detection phase hands AlignJobs its jobs axis by axis: the
check reads (rows) against the adapter sets' sides (columns).  Held here
against the same jobs handed over as flat pairs and group ids, the
planner's path for every other caller: the group maxima, the prefilter's
group scores, the launch records (entry point, lanes, L, A, needed
cells) and the -v 1 progress lines are the same, through
find_matching_adapter_sets, on ligation and barcoded reads, reads shorter
than the 150 bp window, empty reads, two device entries, the forced host
route and the score prefilter; and directly under cell budgets small
enough that launches cut rows apart.  planner.product_lanes counts each
detection lane once."""

import contextlib
import io

import numpy as np
import pytest

import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.adapters import ADAPTERS
from porechop_tpu_torch.ops import dispatch
from porechop_tpu_torch.parallel import mesh
from porechop_tpu_torch.pipeline import phases
from porechop_tpu_torch.pipeline.model import Read
from porechop_tpu_torch.utils import spans
from porechop_tpu_torch.utils.synth import (synth_barcoded, synth_reads,
                                             write_fastq)

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# As tests/test_torch_dispatch.py's: a bitless launch of 32 lanes at rung
# 150 and adapter rung 64, 64 at adapter rung 24.
SMALL = {'_CELL_BUDGET': 32 * 151 * 24, '_GM_CELL_BUDGET': 32 * 151 * 64}

_LAUNCH_SHARDS = mesh.launch_shards

# The detection phase's columns: every search adapter set's sides.
N_ENTRIES = sum(bool(a.start_sequence) + bool(a.end_sequence)
                for a in ADAPTERS if '(full sequence)' not in a.name)


class _Recorded(dispatch.AlignJobs):
    """AlignJobs that keeps each group run's result, and whether its
    product was never made into flat pairs."""
    calls = None

    def run_group_max(self, group_ids, n_groups, progress=None):
        res = super().run_group_max(group_ids, n_groups, progress)
        self.calls.append(('gm', {k: v.copy() for k, v in res.items()},
                           self._pairs is None))
        return res

    def run_group_score_max(self, group_ids, n_groups, progress=None):
        res = super().run_group_score_max(group_ids, n_groups, progress)
        self.calls.append(('gsc', {'': res.copy()}, self._pairs is None))
        return res


class _Flat(_Recorded):
    """The same jobs as flat pairs and group ids."""

    def __init__(self, windows, adapters, jobs, *args, **kwargs):
        super().__init__(windows, adapters, jobs.pairs(), *args, **kwargs)
        self.gids = jobs.group_ids()

    def run_group_max(self, group_ids, n_groups, progress=None):
        return super().run_group_max(self.gids, n_groups, progress)

    def run_group_score_max(self, group_ids, n_groups, progress=None):
        return super().run_group_score_max(self.gids, n_groups, progress)


def _reads(kind):
    if kind == 'barcoded':
        return [Read(*r) for r in synth_barcoded(8, 500, seed=5,
                                                 barcodes=range(1, 4))]
    reads = [Read(*r) for r in synth_reads(8, 500, seed=3)]
    if kind == 'short':
        # Windows of every rung below 150, and at its edges.
        return [Read('s%d' % n, r.seq[:n], r.quals[:n])
                for n, r in zip((15, 31, 40, 64, 90, 149, 150, 151), reads)]
    if kind == 'empty':
        return reads[:3] + [Read('e0', '', '')] + reads[3:] + [
            Read('e1', '', '')]
    return reads


def _detect(planner, reads, monkeypatch, device='cpu', exact=True):
    """find_matching_adapter_sets at -v 1 with planner as its AlignJobs,
    with the launch records kept: its results, text and records."""
    planner.calls = []
    shards = []

    def counted(*args, **kwargs):
        shards.append(args[0])
        return _LAUNCH_SHARDS(*args, **kwargs)
    monkeypatch.setattr(phases, 'AlignJobs', planner)
    monkeypatch.setattr(mesh, 'launch_shards', counted)
    out = io.StringIO()
    spans.begin_job(True)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            sets = phases.find_matching_adapter_sets(
                reads, 1, 150, (3, -6, -5, -2), out, 90.0, 1,
                exact_scores=exact, device=device)
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            spans.end_job(True)
    (rec,) = spans.last_jobs(1)
    return {'calls': planner.calls, 'text': out.getvalue(),
            'sets': [a.name for a in sets],
            'scores': [(a.best_start_score, a.best_end_score)
                       for a in ADAPTERS],
            'launches': rec['launches'], 'cells': rec['cells'],
            'lanes': rec['counts'].get('planner.product_lanes', 0),
            'uploaded': shards}


@pytest.mark.parametrize('case', [
    'ligation', 'barcoded', 'short', 'empty', 'two_entries', 'host',
    'prefilter'])
def test_detection_product_equals_flat_pairs(monkeypatch, case):
    """Per case, find_matching_adapter_sets with the product as it is and
    with the product made into flat pairs: the same group maxima and
    prefilter scores, the same launches with the same needed cells, the
    same -v 1 text and the same sets.  On the kernels the product stays
    unexpanded, uploads no lane indices (no mesh.launch_shards call) and
    counts its non-degenerate lanes; on the host route it runs as flat
    pairs and counts none."""
    reads = _reads(case)
    device = 'cpu,cpu' if case == 'two_entries' else 'cpu'
    exact = case != 'prefilter'
    if case == 'host':
        monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    got = _detect(_Recorded, reads, monkeypatch, device, exact)
    want = _detect(_Flat, reads, monkeypatch, device, exact)
    assert [c[0] for c in got['calls']] == [c[0] for c in want['calls']]
    assert [c[0] for c in got['calls']] == (['gsc', 'gm'] if not exact
                                            else ['gm'])
    for (_, g, _), (_, w, _) in zip(got['calls'], want['calls']):
        assert g.keys() == w.keys()
        for f in g:
            assert np.array_equal(g[f], w[f], equal_nan=True), f
    for key in ('text', 'sets', 'scores', 'launches', 'cells'):
        assert got[key] == want[key], key
    assert got['text'].count('\r') >= len(reads) // 10 + 2
    live = sum(len(r.seq) > 0 for r in reads)
    if case == 'host':
        assert got['launches'] == [] and got['lanes'] == 0
        assert not any(c[2] for c in got['calls'])
    else:
        assert got['launches'] and got['uploaded'] == []
        assert all(c[2] for c in got['calls'])
        assert want['uploaded'] and want['lanes'] == 0
        if exact:
            assert got['lanes'] == live * N_ENTRIES
        else:
            assert got['lanes'] > live * N_ENTRIES


def _grid(seed):
    """Windows (rows of two, on rungs 32, 64 and 150, some rows empty) and
    adapters (rungs 24, 32 and 48, one empty) of a product whose columns
    share groups: three columns at adapter rung 24, so that SMALL's
    launches (and their halves on two entries) cut rows apart."""
    rng = np.random.default_rng(seed)
    adapters = [rng.integers(0, 4, n).astype(np.int8)
                for n in (22, 28, 17, 37, 0, 24)]
    windows = []
    for k in range(90):
        n = (150, 150, 120, 60, 20, 0)[k % 6] if k != 7 else 0
        for _ in range(2):
            w = rng.integers(0, 5, n).astype(np.int8)
            if k % 3 == 0 and n > 40:
                a = adapters[k % 4]
                w[5:5 + len(a)] = a
            windows.append(w)
    rows = np.arange(len(windows)).reshape(-1, 2)
    cols = ([0, 1, 0, 1, 1, 0, 1], [0, 1, 2, 3, 4, 5, 1],
            [0, 1, 2, 0, 3, 1, 2])
    return windows, adapters, dispatch.Product(rows, *cols), 4


def _run_grid(planner, mode, device, seed):
    windows, adapters, jobs, n_groups = _grid(seed)
    ticks = []

    def progress(idxs, counts=None):
        per_row = np.zeros(len(jobs.row_windows), np.int64)
        if counts is None:
            np.add.at(per_row, np.asarray(idxs) // len(jobs.col_side), 1)
        else:
            per_row[idxs] += counts
        ticks.append(per_row)
    planner.calls = []
    spans.begin_job(True)
    try:
        j = planner(windows, adapters, jobs, device=device)
        getattr(j, mode)(None, n_groups, progress=progress)
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            spans.end_job(True)
    (rec,) = spans.last_jobs(1)
    return planner.calls[0][1], ticks, rec, len(jobs.group_ids())


@pytest.mark.parametrize('device', ['cpu', 'cpu,cpu'])
@pytest.mark.parametrize('mode', ['run_group_max', 'run_group_score_max'])
def test_product_launches_as_its_flat_pairs(monkeypatch, mode, device):
    """Under cell budgets that cut launches mid-row: the product's results,
    launch records (needed cells included) and the rows each harvest
    resolves equal its flat pairs', and every job resolves once."""
    for name, value in SMALL.items():
        monkeypatch.setattr(dispatch, name, value)
    got, got_ticks, got_rec, P = _run_grid(_Recorded, mode, device, 11)
    want, want_ticks, want_rec, _ = _run_grid(_Flat, mode, device, 11)
    for f in want:
        assert np.array_equal(got[f], want[f], equal_nan=True), f
    assert got_rec['launches'] == want_rec['launches']
    assert got_rec['cells'] == want_rec['cells']
    assert len(got_rec['launches']) > 6
    assert len(got_ticks) == len(want_ticks) > 6
    for g, w in zip(got_ticks, want_ticks):
        assert np.array_equal(g, w)
    assert sum(t.sum() for t in got_ticks) == P
    assert got_rec['counts']['planner.product_lanes'] == (
        P - 7 * 16 - (90 - 16) * 1)


def test_product_expands_where_it_cannot_run_axis_by_axis():
    """A row whose windows differ in length and a window rung past the
    group max's take the flat pairs, with the flat pairs' results."""
    rng = np.random.default_rng(2)
    adapters = [rng.integers(0, 4, n).astype(np.int8) for n in (22, 30)]
    cases = {'uneven': (100, 90), 'long': (1800, 1800)}
    for name, (n0, n1) in cases.items():
        windows = [rng.integers(0, 4, n).astype(np.int8)
                   for _ in range(6) for n in (n0, n1)]
        jobs = dispatch.Product(np.arange(12).reshape(6, 2), [0, 1, 1],
                                [0, 1, 0], [0, 1, 2])
        j = dispatch.AlignJobs(windows, adapters, jobs, device='cpu')
        assert j._product_lens(j._GROUP_MAX_RUNG) is None, name
        got = j.run_group_max(None, 3)
        want = dispatch.AlignJobs(windows, adapters, jobs.pairs(),
                                  device='cpu').run_group_max(
                                      jobs.group_ids(), 3)
        for f in want:
            assert np.array_equal(got[f], want[f]), (name, f)


def test_product_pairs_are_detection_read_major_pairs():
    """Product.pairs() and group_ids() are the detection phase's flat
    jobs: job r * E + e is read r's window on entry e's side against its
    adapter, in group e; columns() keeps the rows and the columns' order."""
    R, side, ai = 5, np.array([0, 1, 1, 0]), np.array([3, 0, 2, 3])
    jobs = dispatch.Product(np.arange(2 * R).reshape(R, 2), side, ai,
                            np.arange(4))
    want = np.empty((R * 4, 2), np.int64)
    want[:, 0] = 2 * np.repeat(np.arange(R), 4) + np.tile(side, R)
    want[:, 1] = np.tile(ai, R)
    assert np.array_equal(jobs.pairs(), want)
    assert np.array_equal(jobs.group_ids(), np.tile(np.arange(4), R))
    keep = np.array([True, False, True, True])
    mask = np.tile(keep, R)
    sub = jobs.columns(keep)
    assert np.array_equal(sub.pairs(), want[mask])
    assert np.array_equal(sub.group_ids(), jobs.group_ids()[mask])
    assert len(sub.pairs()) == mask.sum()


def test_product_lanes_count_detection_once(tmp_path, monkeypatch):
    """On a small CLI run under PORECHOP_TPU_TIMING (ligation reads, -v 1,
    the middle pass on), planner.product_lanes is the check reads times
    the detection's entries, nothing from end trim or the middle, and the
    `[spans]` summary prints it."""
    path = tmp_path / 'reads.fastq'
    write_fastq(str(path), synth_reads(10, 800, seed=4, chimera_rate=0.3))
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    monkeypatch.chdir(tmp_path)
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        torch_cli.main(['-i', str(path), '-o', 'out.fastq', '-t', '2',
                        '-v', '1'], device='cpu')
    (rec,) = spans.last_jobs(1)
    assert rec['counts']['planner.product_lanes'] == 10 * N_ENTRIES
    assert {x[0] for x in rec['launches']} >= {'detect', 'endtrim', 'middle'}
    assert ('[spans] job %d count planner.product_lanes %d'
            % (rec['job'], 10 * N_ENTRIES)) in err.getvalue().splitlines()
