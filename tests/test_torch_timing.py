"""The port's instruments against the JAX package's, on the CPU:
PORECHOP_TPU_TIMING (the CLI's phase walls and the planner's `[timing]`
lines), PORECHOP_TPU_PROFILE (a trace written, the run unchanged) and
PORECHOP_TPU_LOAD_STATS (what each of two gloo ranks parsed).

The JAX package reads PORECHOP_TPU_TIMING when it is imported, so its
runs here set its module flags (`_TIMING` in porechop_tpu.cli and
porechop_tpu.ops.dispatch); the port reads the variable when main runs.
On the CPU both packages print a prefilter line in the middle phase (the
JAX package from its native host route, the port from the kernels' plain
versions), and none in detection, where both prefilter through their
group reductions."""

import contextlib
import io
import json
import os
import re

import pytest
import torch

import porechop_tpu.cli as jax_cli
import porechop_tpu.ops.dispatch as jax_dispatch
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import one_torch_thread
from .test_torch_multihost import _run_ranks

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

PHASES = ['load', 'detect', 'endtrim', 'middle', 'output']


@pytest.fixture(scope='module')
def reads_fastq(tmp_path_factory):
    """40 synthetic 1.5 kb reads, three in ten chimeric."""
    d = tmp_path_factory.mktemp('torch_timing')
    write_fastq(str(d / 'reads.fastq'),
                synth_reads(40, 1500, seed=3, chimera_rate=0.3))
    return d / 'reads.fastq'


def _run(main, workdir, src, args, **kw):
    """A CLI run in a fresh `workdir` on the input src, linked there as
    reads.fastq: (stdout with the directory as <dir>, stderr, output
    bytes)."""
    os.makedirs(workdir)
    os.symlink(src, os.path.join(workdir, 'reads.fastq'))
    old = os.getcwd()
    os.chdir(workdir)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(['-i', 'reads.fastq', '-o', 'out.fastq', '-t', '4'] + args,
                 **kw)
        with open('out.fastq', 'rb') as f:
            body = f.read()
    finally:
        os.chdir(old)
    return out.getvalue().replace(str(workdir), '<dir>'), err.getvalue(), body


def _jax_run(workdir, src, args, monkeypatch):
    monkeypatch.setattr(jax_cli, '_TIMING', True)
    monkeypatch.setattr(jax_dispatch, '_TIMING', True)
    return _run(jax_cli.main, workdir, src, args)


def _timing(err):
    return [ln for ln in err.splitlines() if ln.startswith('[timing] ')]


def _phases(err):
    return [ln.split()[2] for ln in _timing(err)
            if ln.startswith('[timing] phase ')]


def _masked(lines):
    """Timing lines with their seconds and rates masked."""
    return [re.sub(r'\d+\.\d+(e[+-]\d+)?', '#', ln) for ln in lines]


@pytest.mark.parametrize('v', ['0', '1'])
def test_phase_labels_and_prefilter_match_jax(reads_fastq, tmp_path,
                                              monkeypatch, v):
    """The same phase labels in the same order and text as the JAX CLI,
    and the same prefilter counts where both print one."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    want = _jax_run(tmp_path / 'jax', reads_fastq, ['-v', v], monkeypatch)
    got = _run(torch_cli.main, tmp_path / 'torch', reads_fastq, ['-v', v],
               device='cpu')
    assert _phases(want[1]) == _phases(got[1]) == PHASES
    for err in (want[1], got[1]):
        assert all(re.fullmatch(r'\[timing\] phase [a-z]{4,7} +\d+\.\d{3}s',
                                ln) for ln in _timing(err)
                   if ' phase ' in ln)
    prefilter = [[ln for ln in _timing(err) if 'score prefilter' in ln]
                 for err in (want[1], got[1])]
    assert prefilter[0] and prefilter[0] == prefilter[1]
    assert got[0] == want[0] and got[2] == want[2]


def test_forced_host_planner_lines_match_jax(reads_fastq, tmp_path,
                                             monkeypatch):
    """Under PORECHOP_TPU_FORCE_HOST=1 both packages run every job on the
    native engine: the same `[timing]` lines, native batches and
    prefilter alike, but for their seconds and rates."""
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    want = _jax_run(tmp_path / 'jax', reads_fastq, ['-v', '1'], monkeypatch)
    got = _run(torch_cli.main, tmp_path / 'torch', reads_fastq, ['-v', '1'])
    assert any('native batch P=' in ln for ln in _timing(got[1]))
    assert _masked(_timing(got[1])) == _masked(_timing(want[1]))
    assert got[0] == want[0] and got[2] == want[2]


def test_timing_is_read_when_main_runs(reads_fastq, tmp_path, monkeypatch):
    """No `[timing]` line without the variable, the phase lines with it,
    set after the package was imported; the output and stdout the same."""
    monkeypatch.delenv('PORECHOP_TPU_TIMING', raising=False)
    plain = _run(torch_cli.main, tmp_path / 'plain', reads_fastq,
                 ['-v', '1'], device='cpu')
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    timed = _run(torch_cli.main, tmp_path / 'timed', reads_fastq,
                 ['-v', '1'], device='cpu')
    assert not _timing(plain[1])
    assert _phases(timed[1]) == PHASES
    assert any('harvested' in ln for ln in _timing(timed[1]))
    assert timed[0] == plain[0] and timed[2] == plain[2]


@pytest.mark.parametrize('env', [{}, {'PORECHOP_TPU_FORCE_HOST': '1'}])
def test_profile_writes_a_trace(reads_fastq, tmp_path, monkeypatch, env):
    """PORECHOP_TPU_PROFILE=<dir>: one Chrome trace JSON in <dir> holding
    the run's torch operations (none under the forced host, whose jobs
    run in the native engine), with the output and stdout unchanged."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    plain = _run(torch_cli.main, tmp_path / 'plain', reads_fastq,
                 ['-v', '0'], device='cpu')
    monkeypatch.setenv('PORECHOP_TPU_PROFILE', str(tmp_path / 'trace'))
    profiled = _run(torch_cli.main, tmp_path / 'profiled', reads_fastq,
                    ['-v', '0'], device='cpu')
    assert profiled[0] == plain[0] == '' and profiled[2] == plain[2]
    (name,) = os.listdir(tmp_path / 'trace')
    assert name.startswith('trace.%d.' % os.getpid())
    with open(tmp_path / 'trace' / name) as f:
        events = json.load(f)['traceEvents']
    ops = {e.get('name') for e in events if e.get('cat') == 'cpu_op'}
    assert bool(ops) == (not env), sorted(ops)[:5]


def test_profile_is_written_when_the_run_fails(tmp_path, monkeypatch):
    """The trace is stopped and written in a `finally`, as the JAX CLI
    stops its trace: a run that fails still leaves one."""
    monkeypatch.setenv('PORECHOP_TPU_PROFILE', str(tmp_path / 'trace'))
    monkeypatch.setattr(torch_cli, '_run_pipeline', _raise)
    with pytest.raises(RuntimeError, match='phase failed'):
        torch_cli.main(['-i', 'missing.fastq', '-o', 'out.fastq'],
                       device='cpu')
    assert len(os.listdir(tmp_path / 'trace')) == 1


def _raise(*args):
    torch.zeros(1).add_(1)
    raise RuntimeError('phase failed')


_COUNT_READS = """\
import atexit, os
from porechop_tpu_torch.pipeline import stream
built = []
class Counted(stream.Read):
    def __init__(self, *a):
        built.append(1)
        super().__init__(*a)
stream.Read = Counted
def dump():
    with open('built.rank' + os.environ['PORECHOP_TPU_PROC_ID'], 'w') as f:
        f.write(str(len(built)))
atexit.register(dump)"""


@pytest.mark.parametrize('check_reads', [None, '6'])
def test_load_stats_on_two_ranks(reads_fastq, tmp_path, monkeypatch,
                                 check_reads):
    """PORECHOP_TPU_LOAD_STATS=<path>: each rank writes <path>.rank<r>
    with the reads it built (as many as a count of Read constructions
    says) out of the total, fewer than the total; the merged output is
    one process's.  With the sample inside the blocks (the default
    --check_reads), each rank builds only its block."""
    args = ['-i', str(reads_fastq), '-o', 'out.fastq', '-v', '0',
            '--device', 'cpu']
    args += ['--check_reads', check_reads] if check_reads else []
    single = _run(torch_cli.main, tmp_path / 'single', reads_fastq,
                  ['-v', '0'], device='cpu')
    monkeypatch.setenv('PORECHOP_TPU_LOAD_STATS', 'loadstats')
    _, files = _run_ranks(args, tmp_path / 'ranks', prelude=_COUNT_READS)
    assert files['out.fastq'] == single[2]
    for r in range(2):
        stats = json.loads(files['loadstats.rank%d' % r])
        assert stats['total'] == 40
        assert stats['materialized'] == int(files['built.rank%d' % r])
        assert stats['materialized'] < stats['total']
    if check_reads is None:
        assert [json.loads(files['loadstats.rank%d' % r])['materialized']
                for r in range(2)] == [20, 20]
