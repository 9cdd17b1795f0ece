"""The in-program recorder (porechop_tpu_torch/utils/spans.py) on the CPU:
off, a CLI run keeps no record and prints what the JAX CLI prints; on,
each cli.main call leaves one record (a failed one too) whose spans nest
inside the phases without overlap and add up to them, whose launch
records count the same cells as the benchmark's wrapper around the
kernel entry points (benchmark/pcbench/trace.py), whose spans are ranges
in a PORECHOP_TPU_PROFILE trace, and whose --stream phases are summed
over the chunks into the five `[timing] phase` lines."""

import collections
import contextlib
import importlib.util
import io
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

import porechop_tpu.cli as jax_cli
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.ops import dispatch, kernels
from porechop_tpu_torch.utils import spans
from porechop_tpu_torch.utils.synth import (synth_barcoded, synth_reads,
                                             write_fastq)

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'benchmark')
ALIGNMENT = ('detect', 'endtrim', 'middle')


def _bench_module(*parts):
    path = os.path.join(BENCH, *parts)
    spec = importlib.util.spec_from_file_location(
        'bench_' + parts[-1][:-3].replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """reads.fastq: 40 synthetic 1.5 kb reads, three in ten chimeric;
    barcoded.fastq: 24 natively barcoded 1 kb reads."""
    d = tmp_path_factory.mktemp('torch_spans')
    write_fastq(str(d / 'reads.fastq'),
                synth_reads(40, 1500, seed=3, chimera_rate=0.3))
    write_fastq(str(d / 'barcoded.fastq'),
                synth_barcoded(24, 1000, seed=5, barcodes=range(1, 4),
                               chimera_rate=0.3))
    return d


def _run(main, workdir, args, **kw):
    """A CLI run in a fresh workdir: (stdout, stderr, {file: bytes})."""
    os.makedirs(workdir)
    old = os.getcwd()
    os.chdir(workdir)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(args, **kw)
        files = {}
        for dir_path, _, names in os.walk('.'):
            for n in names:
                with open(os.path.join(dir_path, n), 'rb') as f:
                    files[os.path.join(dir_path, n)] = f.read()
    finally:
        os.chdir(old)
    return (out.getvalue().replace(str(workdir), '<dir>'),
            err.getvalue().replace(str(workdir), '<dir>'), files)


def _args(inputs, name='reads.fastq', extra=()):
    """The CLI's arguments on an input of the module's, to out.fastq
    unless extra bins the reads (-b)."""
    out = [] if '-b' in extra else ['-o', 'out.fastq']
    return ['-i', str(inputs / name), *out, '-t', '4', *extra]


def _timing(err):
    return [ln for ln in err.splitlines() if ln.startswith('[timing] ')]


def _newest():
    jobs = spans.last_jobs(1)
    return jobs[0]['job'] if jobs else None


def test_off_keeps_no_record_and_prints_what_jax_prints(inputs, tmp_path,
                                                        monkeypatch):
    """Without PORECHOP_TPU_TIMING: no record, no `[spans]` or `[timing]`
    line, and stdout, stderr and output bytes the JAX CLI's."""
    monkeypatch.delenv('PORECHOP_TPU_TIMING', raising=False)
    monkeypatch.setattr(jax_cli, '_TIMING', False)
    before = _newest()
    got = _run(torch_cli.main, tmp_path / 'torch',
               _args(inputs, extra=['-v', '1']), device='cpu')
    want = _run(jax_cli.main, tmp_path / 'jax',
                _args(inputs, extra=['-v', '1']))
    assert _newest() == before
    assert got == want
    assert '[spans]' not in got[1]


def test_off_spans_are_one_shared_no_op():
    """Outside a job (or with the switch off) every span is the one
    shared no-op and a callback is passed through as it is."""
    spans.begin_job(False)
    fn = len
    assert spans.span('plan') is spans.NOOP
    assert spans.phase('load', print) is spans.NOOP
    assert spans.upload(torch.device('cpu')) is spans.NOOP
    assert spans.enqueue([1], None, [1], None) is spans.NOOP
    assert spans.outside(fn) is fn
    assert spans.phase_seconds() is None
    spans.launch('forward_score', 'cpu', 'plain', 1, 1, 1)
    spans.end_job(True)


def test_one_record_per_call_and_a_failed_one(inputs, tmp_path,
                                              monkeypatch):
    """Each cli.main call leaves one record; a call that fails leaves one
    too, not ok, holding the phase it failed in.  The summary lines carry
    each phase's RSS."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    _, err, _ = _run(torch_cli.main, tmp_path / 'ok',
                     _args(inputs, extra=['-v', '0']), device='cpu')
    (rec,) = spans.last_jobs(1)
    assert rec['ok']
    assert list(rec['phases']) == list(spans.PHASES)
    assert all(n == 1 for _, n in rec['phases'].values())
    assert set(rec['rss_bytes']) == set(spans.PHASES)
    assert min(rec['rss_bytes'].values()) > 0
    lines = [ln for ln in err.splitlines() if ln.startswith('[spans] ')]
    assert lines[0].startswith('[spans] job %d ok ' % rec['job'])
    assert sum(' phase ' in ln and ' rss ' in ln for ln in lines) == 5
    assert {ln.split()[4] for ln in lines if ' span ' in ln} == \
        set(rec['totals'])

    def fail(args, device_name):
        with spans.phase('load'):
            raise RuntimeError('phase failed')
    monkeypatch.setattr(torch_cli, '_run_pipeline', fail)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            pytest.raises(RuntimeError, match='phase failed'):
        torch_cli.main(['-i', 'missing.fastq', '-o', 'out.fastq'],
                       device='cpu')
    (failed,) = spans.last_jobs(1)
    assert failed['job'] == rec['job'] + 1
    assert not failed['ok']
    assert list(failed['phases']) == ['load']
    assert '[spans] job %d failed ' % failed['job'] in err.getvalue()
    assert not _timing(err.getvalue())


@pytest.mark.parametrize('v', ['0', '1'])
def test_spans_add_up_to_the_phases(inputs, tmp_path, monkeypatch, v):
    """Within each phase the spans' self times sum to no more than the
    phase, and the benchmark's readers give glue + planner + wait equal to
    phases.ms_per_mb (read from the `[timing] phase` lines) within 2%."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    _, err, _ = _run(torch_cli.main, tmp_path / 'run',
                     _args(inputs, extra=['-v', v]), device='cpu')
    (rec,) = spans.last_jobs(1)
    for ph in ALIGNMENT:
        nested = sum(s for s, _ in rec['spans'].get(ph, {}).values())
        assert 0 < nested <= rec['phases'][ph][0]
    assert set(rec['totals']) == {'plan', 'upload', 'enqueue', 'wait'}
    jobs = _bench_module('pcbench', 'jobs.py')
    run = {'jobs': 1, 'bases': 1e6, 'phases': jobs.timing_phases(err)}
    read = {name: _bench_module('metrics', name + '.py').read(run)
            for name in ('phases.ms_per_mb', 'phases.glue_ms_per_mb',
                         'planner.host_ms_per_mb', 'device.wait_ms_per_mb')}
    assert all(x is not None and x > 0 for x in read.values()), read
    parts = (read['phases.glue_ms_per_mb'] + read['planner.host_ms_per_mb']
             + read['device.wait_ms_per_mb'])
    assert abs(parts / read['phases.ms_per_mb'] - 1) < 0.02, read


@pytest.mark.parametrize('name,extra', [
    ('reads.fastq', ['-v', '0']), ('reads.fastq', ['-v', '1']),
    ('barcoded.fastq', ['-v', '1', '-b', 'bins'])],
    ids=['v0', 'v1', 'barcoded'])
def test_launch_cells_equal_the_harness_wrapper(inputs, tmp_path,
                                                monkeypatch, name, extra):
    """The records' launches (entry point, lanes, L, A), launched cells
    and needed cells equal what the benchmark's LaunchRecorder records
    around the kernel entry points over the same run, its sums reduced on
    CPU tensors; the planner's share the dispatch metric's."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    args = _args(inputs, name, extra)
    trace = _bench_module('pcbench', 'trace.py')
    with trace.LaunchRecorder(kernels) as recorder:
        _run(torch_cli.main, tmp_path / 'run', args, device='cpu')
    theirs = recorder.launches()
    (rec,) = spans.last_jobs(1)
    ours = collections.Counter()
    for _, entry, dev, inst, B, L, A, n, sized, _ in rec['launches']:
        assert (dev, inst, sized) == ('cpu', 'plain', n)
        ours[(entry, B, L, A)] += n
    assert ours == collections.Counter(x[:4] for x in theirs)
    assert rec['cells']['launched'] == sum(B * L * A
                                           for _, B, L, A, *_ in theirs)
    assert rec['cells']['needed'] == sum(x[4] for x in theirs)
    assert {x[0] for x in rec['launches']} <= set(ALIGNMENT)
    share = {}
    for metric in ('planner.useful_cell_share', 'dispatch.useful_cell_share'):
        mod = _bench_module('metrics', metric + '.py')
        share[metric] = mod.read({'jobs': 1, 'launches': theirs})
    assert share['planner.useful_cell_share'] == pytest.approx(
        share['dispatch.useful_cell_share'], abs=1e-9)


def test_long_read_counts_its_subwindow_lanes_and_survivors(tmp_path,
                                                            monkeypatch):
    """A traced CPU job with one chimeric read past SCORE_RUNG: the middle
    pass's score prefilter counts a lane for each sub-window of each of
    the read's pairs (planner.subwindow_lanes) and the long pairs the
    bound leaves for the exact re-run (planner.long_survivors), at least
    the chimera's hits; the `[spans]` summary prints both."""
    reads = synth_reads(6, 900, seed=4, chimera_rate=0.0)
    (_, seq, quals), = synth_reads(1, 14_000, seed=6, chimera_rate=1.0)
    reads.append(('long_read', seq, quals))
    write_fastq(str(tmp_path / 'reads.fastq'), reads)
    seen = []
    real = dispatch.AlignJobs._run_stats_prefiltered

    def watched(self, coef, progress):
        res = real(self, coef, progress)
        lens = np.array([len(w) for w in self.windows])[self.pairs[:, 0]]
        long = lens > dispatch.SCORE_RUNG
        amax = dispatch.bucket_adapter_len(max(len(a)
                                               for a in self.adapters))
        n, _ = dispatch.subwindows(lens[long], dispatch.SCORE_RUNG,
                                   dispatch.subwindow_overlap(amax,
                                                              self.scoring))
        seen.append((int(n.sum()), int(long.sum()),
                     int((res['full_pct'][long] >= 90.0).sum())))
        return res
    monkeypatch.setattr(dispatch.AlignJobs, '_run_stats_prefiltered',
                        watched)
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    _, err, _ = _run(torch_cli.main, tmp_path / 'run',
                     ['-i', str(tmp_path / 'reads.fastq'), '-o', 'out.fastq',
                      '-t', '2'], device='cpu')
    (lanes, pairs, hits), = seen
    (rec,) = spans.last_jobs(1)
    counts = rec['counts']
    assert lanes == 2 * pairs > 0 and hits > 0
    assert counts['planner.subwindow_lanes'] == lanes
    assert hits <= counts['planner.long_survivors'] <= pairs
    head = '[spans] job %d count ' % rec['job']
    lines = err.splitlines()
    assert head + 'planner.subwindow_lanes %d' % lanes in lines
    assert (head + 'planner.long_survivors %d'
            % counts['planner.long_survivors']) in lines


def test_profile_trace_holds_the_spans_as_nested_ranges(inputs, tmp_path,
                                                        monkeypatch):
    """Under PORECHOP_TPU_PROFILE the phases and spans are record_function
    ranges in the trace: the phases in order and disjoint, every span
    inside one phase, and any two spans nested or disjoint."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    monkeypatch.setenv('PORECHOP_TPU_PROFILE', str(tmp_path / 'trace'))
    _run(torch_cli.main, tmp_path / 'run', _args(inputs, extra=['-v', '0']),
         device='cpu')
    (name,) = os.listdir(tmp_path / 'trace')
    with open(tmp_path / 'trace' / name) as f:
        events = json.load(f)['traceEvents']
    ranges = [(e['name'], float(e['ts']), float(e['ts']) + float(e['dur']))
              for e in events if e.get('cat') == 'user_annotation']
    phases = [r for r in ranges if r[0] in spans.PHASES]
    nested = [r for r in ranges if r[0] not in spans.PHASES]
    assert [p[0] for p in sorted(phases, key=lambda r: r[1])] == \
        list(spans.PHASES)
    assert {r[0] for r in nested} == {'plan', 'upload', 'enqueue', 'wait'}
    ordered = sorted(phases, key=lambda r: r[1])
    assert all(a[2] <= b[1] for a, b in zip(ordered, ordered[1:]))
    for _, s, e in nested:
        assert sum(ps <= s and e <= pe for _, ps, pe in phases) == 1
    for i, (_, s1, e1) in enumerate(nested):
        for _, s2, e2 in nested[i + 1:]:
            assert e1 <= s2 or e2 <= s1 or (s1 <= s2 and e2 <= e1) \
                or (s2 <= s1 and e1 <= e2)


def test_stream_phases_are_summed_over_chunks(inputs, tmp_path, monkeypatch):
    """A --stream run records its phases chunk by chunk, prints the five
    `[timing] phase` lines summed over them after its last chunk, and
    writes what the in-memory run writes."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    streamed = _run(torch_cli.main, tmp_path / 'streamed',
                    _args(inputs, extra=['-v', '1', '--stream', '8']),
                    device='cpu')
    (rec,) = spans.last_jobs(1)
    whole = _run(torch_cli.main, tmp_path / 'whole',
                 _args(inputs, extra=['-v', '1']), device='cpu')
    assert streamed[0] == whole[0]
    assert streamed[2] == whole[2]
    lines = [ln for ln in _timing(streamed[1]) if ' phase ' in ln]
    assert [ln.split()[2] for ln in lines] == list(spans.PHASES)
    for ln in lines:
        label, s = ln.split()[2], float(ln.split()[3][:-1])
        assert s == pytest.approx(rec['phases'][label][0], abs=6e-4)
    counts = {k: n for k, (_, n) in rec['phases'].items()}
    assert counts == {'load': 7, 'detect': 1, 'endtrim': 5, 'middle': 5,
                      'output': 6}
    assert rec['spans']['middle']['enqueue'][1] > 0


def test_stream_prints_no_phase_line_when_off(inputs, tmp_path,
                                              monkeypatch):
    monkeypatch.delenv('PORECHOP_TPU_TIMING', raising=False)
    before = _newest()
    _, err, _ = _run(torch_cli.main, tmp_path / 'streamed',
                     _args(inputs, extra=['-v', '0', '--stream', '8']),
                     device='cpu')
    assert not _timing(err) and '[spans]' not in err
    assert _newest() == before


class _Clock:
    """A stand-in for the time module whose perf_counter the test moves."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_self_time_of_nested_spans_and_pauses(monkeypatch):
    """A span's clock stops while a span it opened, or a pause, runs; the
    phase's time outside every span is left as its own work."""
    clock = _Clock()
    monkeypatch.setattr(spans, 'time', clock)
    monkeypatch.setattr(spans, '_JOBS', collections.deque(maxlen=4))

    def per_read():
        clock.now += 5
    spans.begin_job(True)
    try:
        with spans.phase('middle'):
            clock.now += 7                      # per-read work
            with spans.span('plan'):
                clock.now += 1
                with spans.upload(torch.device('cpu')):
                    clock.now += 2
                spans.outside(per_read)()
                with spans.span('wait'):
                    clock.now += 4
                clock.now += 3
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            spans.end_job(True)
    (rec,) = spans.last_jobs(5)
    assert rec['phases'] == {'middle': [22.0, 1]}
    assert rec['spans'] == {'middle': {'plan': [4.0, 1], 'upload': [2.0, 1],
                                       'wait': [4.0, 1]}}
    assert rec['seconds'] == 22.0


def test_launch_records_count_needed_cells_from_host_lengths(monkeypatch):
    """A launch enqueued with its lanes' host lengths records the cells
    they need; one without lengths, or with lengths for other lanes,
    records none."""
    monkeypatch.setattr(spans, '_JOBS', collections.deque(maxlen=4))
    wl, al = [10, 20, 1], [3, 4]
    spans.begin_job(True)
    try:
        with spans.phase('detect'):
            with spans.enqueue(wl, [0, 1, 2, 2], al, [1, 0, 0, 1]):
                spans.launch('forward_stats', 'cpu', 'plain', 4, 32, 24)
            with spans.enqueue(wl, None, al, None):
                spans.launch('forward_stats', 'cpu', 'plain', 4, 32, 24)
            spans.launch('forward_walk', 'cpu', 'plain', 4, 32, 24)
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            spans.end_job(True)
    (rec,) = spans.last_jobs(1)
    assert sorted(rec['launches']) == [
        ['detect', 'forward_stats', 'cpu', 'plain', 4, 32, 24, 2, 1,
         40 + 60 + 3 + 4],
        ['detect', 'forward_walk', 'cpu', 'plain', 4, 32, 24, 1, 0, 0]]
    assert rec['cells'] == {'launches': 3, 'launched': 3 * 4 * 32 * 24,
                            'launched_sized': 4 * 32 * 24, 'needed': 107}


def test_buffer_keeps_the_last_jobs(monkeypatch):
    monkeypatch.setattr(spans, '_JOBS', collections.deque(maxlen=3))
    with contextlib.redirect_stderr(io.StringIO()):
        for _ in range(5):
            spans.begin_job(True)
            spans.end_job(True)
    ids = [r['job'] for r in spans.last_jobs(10)]
    assert len(ids) == 3 and ids == sorted(ids)
    assert [r['job'] for r in spans.last_jobs(2)] == ids[1:]
    assert spans.last_jobs(0) == []


def test_spans_on_another_thread_are_not_recorded(monkeypatch):
    """The size route's native worker runs beside the job's thread: its
    spans would overlap the job's, so they are the no-op."""
    monkeypatch.setattr(spans, '_JOBS', collections.deque(maxlen=4))
    seen = []
    spans.begin_job(True)
    try:
        t = threading.Thread(target=lambda: seen.append(
            spans.span('host_route') is spans.NOOP))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert seen == [True]
        assert spans.span('plan') is not spans.NOOP
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            spans.end_job(True)


def test_upload_to_a_card_waits_first(monkeypatch):
    """Before copying to a card, upload synchronises the stream inside a
    `wait` span (the copy from pageable memory would anyway), so that the
    card's pending work is not counted as the copy."""
    synced = []
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        current_stream=lambda dev: types.SimpleNamespace(
            synchronize=lambda: synced.append(dev))))
    monkeypatch.setattr(spans, 'torch', fake)
    monkeypatch.setattr(spans, '_profiler_range', lambda name: None)
    monkeypatch.setattr(spans, '_JOBS', collections.deque(maxlen=4))
    card = types.SimpleNamespace(type='cuda')
    spans.begin_job(True)
    try:
        with spans.phase('middle'):
            with spans.upload(card):
                pass
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            spans.end_job(True)
    (rec,) = spans.last_jobs(1)
    assert synced == [card]
    assert {k: n for k, (_, n) in rec['spans']['middle'].items()} == \
        {'wait': 1, 'upload': 1}
