"""The PyTorch port's host route (ops/dispatch.py: schemes the kernels
refuse and PORECHOP_TPU_FORCE_HOST) and the middle replay's route and
decisions (ops/middle.py: replays_on_device, replay_step) on the CPU,
against the JAX package on the same seeded inputs, or the executable
spec.  Tolerance: exact (results are integers, and percent identities
the same float64 round trip of equal integers)."""

import contextlib
import io
import os

import numpy as np
import pytest

import porechop_tpu.cli as jax_cli
from porechop_tpu import adapters as jax_adapters
from porechop_tpu.ops import dispatch as jax_dispatch
from porechop_tpu.ops import engine_jax
from porechop_tpu.ops import middle as jax_middle
from porechop_tpu.pipeline import model as jax_model
from porechop_tpu.pipeline import phases as jax_phases
from porechop_tpu_torch import adapters, native
from porechop_tpu_torch import cli as torch_cli
from porechop_tpu_torch.ops import dispatch, middle, spec
from porechop_tpu_torch.pipeline import model, phases
from porechop_tpu_torch.utils.synth import (synth_barcoded, synth_reads,
                                             write_fastq)

from .test_torch_cases import MODES, align_jobs, one_torch_thread
from .test_torch_multihost import _jax_single, _run_ranks

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# A kernel scheme, a Gotoh scheme the kernels refuse, a linear one, and a
# kernel scheme with wide scores.
SCHEMES = [(3, -6, -5, -2), (3, -6, -2, -5), (2, -3, -3, -3),
           (20, -30, -5, -2)]


@pytest.mark.parametrize('scheme', SCHEMES)
@pytest.mark.parametrize('forced', [False, True])
def test_path_choices_match_jax(monkeypatch, scheme, forced):
    """score_path_available and stats_path_active choose the phases'
    prefilter flows as the JAX package's do, with its device on and off
    (PORECHOP_TPU_FORCE_HOST)."""
    if forced:
        monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    assert dispatch.score_path_available(scheme) == \
        jax_dispatch.score_path_available(scheme)
    for prefilter in (None, 90.0, 10.0):
        assert dispatch.stats_path_active(scheme, prefilter) == \
            jax_dispatch.stats_path_active(scheme, prefilter), prefilter


def _host_jobs(scheme):
    """align_jobs(13); under the linear scheme, whose spec aligns one job
    at a time in Python, only its windows of rung 150 and the empty one."""
    windows, adapters_, pairs, _, _ = align_jobs(13)
    if scheme[2] == scheme[3]:
        windows = [w for w in windows if len(w) <= 150]
        pairs = np.array([(w, a) for w in range(len(windows))
                          for a in range(len(adapters_))], np.int64)
    groups = (pairs[:, 0] % 3) * len(adapters_) + pairs[:, 1]
    return windows, adapters_, pairs, groups, 3 * len(adapters_)


def _mode(planner, mode, jobs, scheme, **kw):
    """One AlignJobs mode of `planner` (either package's class) under
    `scheme`, as a dict of host arrays."""
    windows, adapters_, pairs, groups, n_groups = jobs
    j = planner(windows, adapters_, pairs, scheme, **kw)
    if mode == 'run_stats_prefilter':
        return j.run_stats(prefilter=90.0)
    res = (getattr(j, mode)(groups, n_groups) if mode.startswith('run_group')
           else getattr(j, mode)())
    return res if isinstance(res, dict) else {'': res}


@pytest.mark.parametrize('scheme', SCHEMES)
@pytest.mark.parametrize('mode', MODES)
def test_forced_host_modes_match_jax(monkeypatch, mode, scheme):
    """Under PORECHOP_TPU_FORCE_HOST every mode runs on the host route
    with no device named (this host has no card) and equals the JAX
    package's forced-host run.  Under a Gotoh scheme the score-only modes
    (prefiltered stats, group score max) take the native engine's
    score-only entry point, and no other mode does."""
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    entries = []
    batch = native.align_batch

    def spy(*a, entry='align_simd_batch', **k):
        entries.append(entry)
        return batch(*a, entry=entry, **k)
    monkeypatch.setattr(native, 'align_batch', spy)
    dispatch.reset_routes()
    jobs = _host_jobs(scheme)
    got = _mode(dispatch.AlignJobs, mode, jobs, scheme)
    assert dispatch.ROUTES['device'] == [0, 0]
    assert dispatch.ROUTES['host'][0] > 0
    gotoh = scheme[2] != scheme[3]
    assert bool(entries) == gotoh
    assert ('align_simd_scores' in entries) == (
        gotoh and mode in ('run_stats_prefilter', 'run_group_score_max'))
    want = _mode(jax_dispatch.AlignJobs, mode, jobs, scheme)
    assert set(got) == set(want)
    for f in got:
        assert np.array_equal(got[f], want[f], equal_nan=True), f


def test_forced_host_without_gxx_raises(tmp_path, monkeypatch):
    """A forced-host run with no compiler raises and says why; it does not
    go on through another engine."""
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'native')
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match=r'\(3, -6, -5, -2\).*g\+\+'):
        dispatch.AlignJobs([np.zeros(30, np.int8)], [np.zeros(24, np.int8)],
                           [(0, 0)]).run()


def _middle_reads(package, seed=6):
    """Six 400 bp reads of `package`'s Read class: two carry SQK-NSK007's
    top adapter in their middle, one of them twice (a hit, a masked retry
    that hits again, then a miss), one its bottom adapter."""
    rng = np.random.default_rng(seed)
    top = 'AATGTACTTCGTTCAGTTACGTATTGCT'
    bottom = 'GCAATACGTAACTGAACGAAGT'
    reads = []
    for k in range(6):
        seq = list(''.join('ACGT'[c] for c in rng.integers(0, 4, 400)))
        for pos, adapter in {0: [(150, top)], 1: [(100, top), (260, top)],
                             2: [(200, bottom)]}.get(k, []):
            seq[pos:pos + len(adapter)] = adapter
        reads.append(package.Read('r%d' % k, ''.join(seq), 'I' * 400))
    return reads


def _middle_pass(phase_module, package, adapter_module, scheme, **kw):
    """The middle phase of one package over _middle_reads at -v 0: each
    read's middle ranges, trim ranges and hit text."""
    reads = _middle_reads(package)
    sets = [a for a in adapter_module.ADAPTERS if a.name == 'SQK-NSK007']
    phase_module.find_adapters_in_read_middles(
        reads, sets, 0, 85.0, 10, 100, scheme, io.StringIO(), 1, False, **kw)
    return [(r.middle_adapter_ranges, r.middle_trim_ranges, r.middle_hit_str)
            for r in reads]


@pytest.mark.parametrize('scheme', SCHEMES)
@pytest.mark.parametrize('forced', [False, True])
def test_replay_runs_where_the_rule_says(monkeypatch, scheme, forced):
    """middle.replays_on_device decides as the JAX package's replay rule
    at a size-route threshold of 0, under the schemes its device engine
    takes: on the device entries for a kernel scheme, unless the run is
    forced to the host.  The port's middle phase builds a ReplayRunner
    exactly then, and its reads' middle hits are the JAX package's."""
    if forced:
        monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    with monkeypatch.context() as m:
        m.setattr(jax_dispatch, '_HYBRID_CELLS', 0)
        want = engine_jax.supports(scheme) and jax_middle.should_use_device(
            4, 400, 28)
    assert middle.replays_on_device(scheme) == want
    runners = []
    runner = middle.ReplayRunner

    def spy(*a, **k):
        runners.append(a)
        return runner(*a, **k)
    monkeypatch.setattr(middle, 'ReplayRunner', spy)
    got = _middle_pass(phases, model, adapters, scheme, device='cpu')
    assert bool(runners) == want
    assert got == _middle_pass(jax_phases, jax_model, jax_adapters, scheme)
    assert sum(len(ranges) for ranges, _, _ in got) >= 3


@pytest.mark.parametrize('outcome', ['hit', 'miss', 'miss on the last'])
def test_replay_step_decides_as_the_reference(outcome):
    """replay_step on a full-adapter identity from the executable spec: a
    hit retries the same adapter, a miss moves on to the next, and a miss
    on the last adapter finishes the read (reference
    nanopore_read.py:221-243)."""
    top = spec.encode('AATGTACTTCGTTCAGTTACGTATTGCT')
    bottom = spec.encode('GCAATACGTAACTGAACGAAGT')
    rng = np.random.default_rng(2)
    read = rng.integers(0, 4, 300).astype(np.int8)
    read[120:120 + len(top)] = top
    ai = 1 if outcome == 'miss on the last' else 0
    adapter = bottom if ai or outcome == 'miss' else top
    r = spec.align_affine(read, adapter)
    pct = np.array([spec.seqan_pct(r.matches, r.full_len)])
    hit, nxt, live = middle.replay_step(pct, np.array([ai]), 85.0, 2)
    want = {'hit': (True, 0, True), 'miss': (False, 1, True),
            'miss on the last': (False, 2, False)}[outcome]
    assert (bool(hit[0]), int(nxt[0]), bool(live[0])) == want


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """reads.fastq: 48 synthetic 2 kb reads, three in ten chimeric;
    barcoded.fastq: 24 natively barcoded 1 kb reads (barcodes 1-3)."""
    d = tmp_path_factory.mktemp('torch_host_route')
    write_fastq(str(d / 'reads.fastq'),
                synth_reads(48, 2000, seed=3, chimera_rate=0.3))
    write_fastq(str(d / 'barcoded.fastq'),
                synth_barcoded(24, 1000, seed=5, barcodes=range(1, 4),
                               chimera_rate=0.2))
    return d


def _run(main, workdir, args, **kw):
    """Runs a CLI in `workdir` with relative paths; returns (stdout with
    the directory as <dir>, {output file: bytes})."""
    old = os.getcwd()
    os.chdir(workdir)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(args, **kw)
        if '-o' in args:
            paths = [args[args.index('-o') + 1]]
        else:
            b = args[args.index('-b') + 1]
            paths = [os.path.join(b, f) for f in sorted(os.listdir(b))]
        files = {}
        for p in paths:
            with open(p, 'rb') as f:
                files[p] = f.read()
        return buf.getvalue().replace(str(workdir), '<dir>'), files
    finally:
        os.chdir(old)


@pytest.mark.parametrize('flags', [
    ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '0'],
    ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '1'],
    ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '1', '--stream', '16'],
    ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '2'],
    ['-i', '../barcoded.fastq', '-b', 'bins', '-v', '1']])
def test_forced_host_cli_is_byte_identical(inputs, tmp_path, monkeypatch,
                                           flags):
    """PORECHOP_TPU_FORCE_HOST=1 with no device named (this host has no
    card): the whole run on the host route, the middle replay in host
    rounds, byte for byte the JAX package's forced-host run in memory
    (also where the port streams)."""
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')

    class NoReplayRunner:
        def __init__(self, *a, **k):
            raise AssertionError('the replay should run in host rounds')
    monkeypatch.setattr(middle, 'ReplayRunner', NoReplayRunner)
    dispatch.reset_routes()
    for d in ('jax', 'torch'):
        os.makedirs(tmp_path / d)
    for f in ('reads.fastq', 'barcoded.fastq'):
        os.symlink(inputs / f, tmp_path / f)
    args = flags + ['-t', '4']
    jax_args = list(args)
    if '--stream' in args:
        k = args.index('--stream')
        del jax_args[k:k + 2]
    want = _run(jax_cli.main, tmp_path / 'jax', jax_args)
    got = _run(torch_cli.main, tmp_path / 'torch', args)
    assert dispatch.ROUTES['device'] == [0, 0] and dispatch.ROUTES['host'][0]
    if '-o' in flags and flags[flags.index('-v') + 1] != '0':
        assert 'Splitting' in want[0]
    assert got == want


def test_forced_host_ranks_are_byte_identical(inputs, tmp_path,
                                              monkeypatch):
    """Two gloo ranks under PORECHOP_TPU_FORCE_HOST=1 with no --device
    (this host has no card, so a rank that looked for its card would
    fail): the merged output and rank 0's transcript are the JAX
    package's single forced-host run."""
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    args = ['-i', str(inputs / 'reads.fastq'), '-o', 'out.fastq', '-v', '1',
            '-t', '4']
    ranks, files = _run_ranks(args, tmp_path / 'ranks')
    want = _jax_single(args, tmp_path / 'jax')
    assert 'Splitting' in want[0]
    assert (ranks[0][0], files) == want
    assert ranks[1][0] == ''
