"""The PyTorch port's stat-carrying engine (porechop_tpu_torch/ops/engine_v1.py,
PORECHOP_TPU_ENGINE=v1) against the JAX package's
(porechop_tpu/ops/engine_jax.py), and the port's allocator tuning
(porechop_tpu_torch/utils/malloc_tune.py).  Tolerance: exact (integers
end to end)."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import porechop_tpu.cli as jax_cli
from porechop_tpu.ops import engine_jax
from porechop_tpu_torch import cli as torch_cli
from porechop_tpu_torch.ops import dispatch, engine_v1, kernels
from porechop_tpu_torch.utils import malloc_tune
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq
from porechop_tpu_torch.version import __version__

from .test_torch_cases import MODES, align_jobs, one_torch_thread, run_mode

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(seed, B, L, A):
    """B lanes at rungs (L, A), pad lanes included: random reads, reads
    made to tie (homopolymers against homopolymer adapters, repeats of
    the adapter, N codes), lengths from 0 to the rung."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    adps = rng.integers(0, 4, (B, A)).astype(np.int8)
    rl = rng.integers(1, L + 1, B).astype(np.int32)
    al = rng.integers(1, A + 1, B).astype(np.int32)
    for k in range(B):
        kind = k % 6
        if kind == 1:                       # homopolymers
            reads[k] = 0
            adps[k] = 0
        elif kind == 2:                     # adapter repeats
            n = int(al[k])
            rep = np.tile(adps[k, :n], L // n + 1)[:L]
            reads[k] = rep
        elif kind == 3:                     # N codes
            reads[k, rng.integers(0, L, L // 4)] = 4
            adps[k, rng.integers(0, A, A // 4)] = 4
        elif kind == 4:                     # a mutated copy of the adapter
            n = int(min(al[k], rl[k]))
            pos = int(rng.integers(0, rl[k] - n + 1))
            reads[k, pos:pos + n] = adps[k, :n]
            reads[k, pos + rng.integers(0, n, 2)] = rng.integers(0, 4, 2)
        elif kind == 5 and k % 12 == 5:     # a pad lane (1-bp dummy job)
            rl[k] = al[k] = 1
    reads[:, :][np.arange(L)[None, :] >= rl[:, None]] = 4
    adps[:, :][np.arange(A)[None, :] >= al[:, None]] = 4
    return reads, rl, adps, al


@pytest.mark.parametrize('B,L,A', [(96, 150, 24), (24, 10240, 32),
                                   (6, 24576, 48)])
def test_align_batch_matches_jax(B, L, A):
    x = _batch(B + L + A, B, L, A)
    got = engine_v1.align_batch(*x)
    want = engine_jax.align_batch(*x)
    assert set(got) == set(want)
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def test_stats_device_matches_jax():
    x = _batch(7, 64, 150, 24)
    core = engine_v1._align_core(*(torch.from_numpy(a) for a in x),
                                 3, -6, -5, -2)
    got = engine_v1.stats_device(*core[1:], torch.from_numpy(x[1]),
                                 torch.from_numpy(x[3]))
    jcore = engine_jax._align_core(*x, 3, -6, -5, -2)
    want = engine_jax.stats_device(*jcore[1:], x[1], x[3])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_running_max_keeps_the_smaller_index_on_ties():
    """The log-shift running max against a sequential scan, on rows full
    of ties."""
    rng = np.random.default_rng(3)
    f = rng.integers(-3, 3, (5, 77)).astype(np.int32)
    k = np.broadcast_to(np.arange(77, dtype=np.int32), f.shape)
    got_f, got_k = engine_v1._cummax_with_argmax(torch.from_numpy(f),
                                                 torch.from_numpy(k.copy()))
    for b in range(f.shape[0]):
        best, arg = f[b, 0], 0
        for j in range(f.shape[1]):
            if f[b, j] > best:
                best, arg = f[b, j], j
            assert got_f[b, j] == best and got_k[b, j] == arg


def test_refuses_schemes_it_cannot_align():
    with pytest.raises(ValueError, match='gap_open < gap_ext'):
        engine_v1.align_batch(*_batch(0, 4, 150, 24),
                              scoring=(3, -6, -2, -5))


@pytest.mark.parametrize('mode', MODES)
def test_planner_modes_under_v1_match_v2(monkeypatch, mode):
    """PORECHOP_TPU_ENGINE=v1 sends every chunk through the v1 engine (no
    kernel or plain version is called), bounded to LANE_COLS lane
    columns a launch, and every mode's result equals the default
    engine's."""
    jobs = align_jobs(14)
    want = run_mode(mode, jobs, 'cpu')
    monkeypatch.setenv('PORECHOP_TPU_ENGINE', 'v1')
    monkeypatch.setattr(engine_v1, 'LANE_COLS', 64 * 1025)
    launches = []
    core = engine_v1._align_core

    def spy(reads, *rest):
        launches.append(tuple(reads.shape))
        return core(reads, *rest)
    monkeypatch.setattr(engine_v1, '_align_core', spy)
    for name in ('forward_score', 'forward_stats', 'forward_tiled'):
        monkeypatch.setattr(kernels, name, None)
    got = run_mode(mode, jobs, 'cpu')
    assert launches
    assert all(b * (L + 1) <= 64 * 1025 or b == dispatch._MIN_LANES
               for b, L in launches)
    hit = want['full_pct'] >= 90.0 if mode == 'run_stats_prefilter' else ...
    if mode == 'run_stats_prefilter':
        # Under a prefilter only full_pct >= 90 and the passing lanes'
        # values are meaningful.
        assert np.array_equal(got['full_pct'] >= 90.0, hit)
    for f in want:
        assert np.array_equal(got[f][hit], want[f][hit], equal_nan=True), f


def _run(main, workdir, args, **kw):
    old = os.getcwd()
    os.chdir(workdir)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(args, **kw)
        with open(args[args.index('-o') + 1], 'rb') as f:
            return buf.getvalue().replace(str(workdir), '<dir>'), f.read()
    finally:
        os.chdir(old)


@pytest.mark.parametrize('verbosity', ['0', '1'])
def test_cli_under_v1_is_byte_identical(tmp_path, monkeypatch, verbosity):
    """The CLI under PORECHOP_TPU_ENGINE=v1 against the JAX CLI under the
    same variable: 16 reads of 1.5 kb, half of them chimeric."""
    monkeypatch.setenv('PORECHOP_TPU_ENGINE', 'v1')
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(16, 1500, seed=8, chimera_rate=0.5))
    for d in ('jax', 'torch'):
        os.makedirs(tmp_path / d)
    args = ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', verbosity]
    want = _run(jax_cli.main, tmp_path / 'jax', args)
    got = _run(torch_cli.main, tmp_path / 'torch', args, device='cpu')
    if verbosity == '1':
        assert 'Splitting' in want[0]
    assert got == want


def test_malloc_tune_applies_once(monkeypatch):
    """configure() succeeds on glibc and is idempotent; under the opt-out
    it does nothing (mallopt is not reached)."""
    monkeypatch.setattr(malloc_tune, '_done', False)
    monkeypatch.delenv('PORECHOP_TPU_NO_MALLOC_TUNE', raising=False)
    assert malloc_tune.configure() is True
    assert malloc_tune.configure() is True
    monkeypatch.setattr(malloc_tune, '_done', False)
    monkeypatch.setenv('PORECHOP_TPU_NO_MALLOC_TUNE', '1')

    def no_libc(*a, **k):
        raise AssertionError('mallopt reached under the opt-out')
    monkeypatch.setattr(malloc_tune.ctypes, 'CDLL', no_libc)
    assert malloc_tune.configure() is False
    assert malloc_tune._done is False


@pytest.mark.parametrize('opt_out', [False, True])
def test_importing_the_port_applies_the_tuning(opt_out):
    """Importing the port (its CLI module included) leaves glibc's
    allocator alone; cli.main applies the tuning, unless opted out."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop('PORECHOP_TPU_NO_MALLOC_TUNE', None)
    if opt_out:
        env['PORECHOP_TPU_NO_MALLOC_TUNE'] = '1'
    r = subprocess.run(
        [sys.executable, '-c', 'import porechop_tpu_torch.cli as cli\n'
         'from porechop_tpu_torch.utils import malloc_tune as m\n'
         'print(m._done)\n'
         'try:\n'
         '    cli.main(["--version"])\n'
         'except SystemExit:\n'
         '    pass\n'
         'print(m._done)'], env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ['False', __version__, str(not opt_out)]
