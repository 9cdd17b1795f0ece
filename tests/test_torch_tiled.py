"""The port's column-tiled forward (porechop_tpu_torch/ops/kernels.py
forward_tiled, its plain version on the CPU) and the long-window path that
runs it (dispatch.AlignJobs, middle.ReplayRunner, the CLI), against the
JAX package: the Pallas _tiled_kernel in interpret
mode (as tests/test_kernel_tiled.py runs it), its executable spec, its
AlignJobs and ReplayRunner, and its CLI.

Tolerance: exact.  Every output is an integer (percent identities are the
same float64 round trip of equal integers).  Trace bits are compared
through what the walker and finish_v2 make of them: the JAX kernel windows
the H prefix max, the port computes it exactly.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import porechop_tpu.cli as jax_cli
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu.ops import dispatch as jax_dispatch
from porechop_tpu.ops import engine_v2 as jax_engine
from porechop_tpu.ops import kernel_pallas, spec
from porechop_tpu.ops import middle as jax_middle
from porechop_tpu_torch.ops import dispatch, engine_v2, kernels, middle
from porechop_tpu_torch.utils.synth import synth_mixed, write_fastq

from .test_torch_cases import (FIELDS, SCHEME, decode, dp_batch,
                               one_torch_thread, to_torch)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _tiled_batch(seed, B, L, A):
    """dp_batch lanes, with read lengths at and around the port's and the
    JAX kernel's tile edges (256 and 2,048 columns)."""
    reads, rl, adps, al = dp_batch(seed, B, L, A)
    rl[0] = L
    for k, edge in enumerate((255, 256, 257, 2047, 2048, 2049, 1), 2):
        rl[k] = edge
    al[0] = A
    return reads, rl, adps, al


@pytest.fixture
def tiled_calls(monkeypatch):
    """Counts the calls of forward_tiled's plain version (on the CPU the
    launch counter stays at 0)."""
    calls = []
    plain = kernels.forward_tiled_plain

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return plain(*args)
    monkeypatch.setattr(kernels, 'forward_tiled_plain', spy)
    return calls


def _port_walk(batch):
    """The port's forward_tiled + walker + finish on host arrays."""
    reads, rl, adps, al = to_torch(*batch)
    bits, best, ci, cj, vf, hf = kernels.forward_tiled(reads, rl, adps, al,
                                                       *SCHEME)
    assert bits.shape == (adps.shape[1], reads.shape[0],
                          kernels.tiled_l1p(reads.shape[1]))
    assert bits.shape[2] % kernels.TILE_T == 0
    walk = kernels.walk(bits, ci, cj, vf, hf)
    res = engine_v2.finish_v2(walk.numpy(), best.numpy(), ci.numpy(),
                              cj.numpy(), batch[1], batch[3])
    return (best, ci, cj, vf, hf), walk.numpy(), res


@pytest.mark.parametrize('seed,L,A', [(21, 2100, 17), (22, 2100, 32),
                                      (23, 4200, 17), (24, 4200, 32)])
def test_forward_tiled_matches_pallas_tiled(seed, L, A):
    """K2 against the port: the elected cell and its flags, then the walk
    and finish_v2 of each side's own bits."""
    batch = _tiled_batch(seed, 32, L, A)
    with pltpu.force_tpu_interpret_mode():
        jbits, *jcell = kernel_pallas.forward_pallas_tiled(
            *(jnp.asarray(x) for x in batch), *SCHEME)
    cells, walk, res = _port_walk(batch)
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'vflag', 'hflag'),
                          cells, jcell):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    jwalk = np.asarray(jax_engine._traceback(jbits, *jcell[1:]))
    assert np.array_equal(walk, jwalk)
    jres = jax_engine.finish_v2(jwalk, *jcell[:3], batch[1], batch[3])
    for f in FIELDS:
        assert np.array_equal(res[f], jres[f]), f


def test_forward_tiled_matches_spec():
    batch = _tiled_batch(25, 32, 2080, 12)
    _, _, res = _port_walk(batch)
    reads, rl, adps, al = batch
    for k in range(len(rl)):
        want = spec.align_stats(decode(reads[k, :rl[k]]),
                                decode(adps[k, :al[k]]))
        got = {f: int(res[f][k]) for f in FIELDS}
        assert got == {f: getattr(want, f) for f in FIELDS}, k


@pytest.mark.parametrize('starts', [(1_040_000,), (600_000, 1_040_000)])
def test_last_row_key_holds_columns_past_2_20(starts):
    """The last-row leftmost-max key of the plain body holds columns past
    2^20 (a 20-bit column field wrapped there): one planted copy of the
    adapter past 2^20 is elected at its end, and of two exact copies the
    leftmost wins.  Reads are made of bases 0 and 1, the adapter of 2 and
    3, so only the planted copies match."""
    rng = np.random.default_rng(27)
    L, A = 1_050_000, 8
    reads = rng.integers(0, 2, (2, L)).astype(np.int8)
    adps = np.tile(np.array([2, 3, 3, 2, 2, 2, 3, 3], np.int8), (2, 1))
    for s in starts:
        reads[:, s:s + A] = adps[0]
    rl = np.array([L, L - 3], np.int32)
    al = np.full(2, A, np.int32)
    bits, best, ci, cj, vf, hf = kernels.forward_tiled(
        *to_torch(reads, rl, adps, al), *SCHEME)
    assert best.tolist() == [3 * A, 3 * A]
    assert ci.tolist() == [A, A]
    assert cj.tolist() == [starts[0] + A] * 2
    walk = kernels.walk(bits, ci, cj, vf, hf)
    res = engine_v2.finish_v2(walk.numpy(), best.numpy(), ci.numpy(),
                              cj.numpy(), rl, al)
    assert res['read_start'].tolist() == [starts[0]] * 2
    assert res['read_end'].tolist() == [starts[0] + A - 1] * 2


def _long_jobs(seed):
    """Windows of 16,400 and 30,000 bp (window rungs 24,576 and 32,768:
    the tiled forward) with mutated adapter copies, plus a 900 bp one."""
    rng = np.random.default_rng(seed)
    adapters = [rng.integers(0, 4, n).astype(np.int8) for n in (28, 24, 33)]
    windows = []
    for k, n in enumerate((16_400, 30_000, 16_400, 30_000, 900)):
        w = rng.integers(0, 4, n).astype(np.int8)
        for c in range(k % 3 + 1):
            a = adapters[(k + c) % len(adapters)].copy()
            a[rng.integers(0, len(a), 2)] = rng.integers(0, 4, 2)
            pos = int(rng.integers(0, n - len(a)))
            w[pos:pos + len(a)] = a
        windows.append(w)
    pairs = np.array([(w, a) for w in range(len(windows))
                      for a in range(len(adapters))], np.int64)
    return windows, adapters, pairs


@pytest.mark.parametrize('mode', ['run', 'run_stats', 'run_stats_prefilter',
                                  'run_group_score_max'])
def test_long_windows_match_jax(mode, tiled_calls):
    windows, adapters, pairs = _long_jobs(28)
    jobs = (dispatch.AlignJobs(windows, adapters, pairs, device='cpu'),
            jax_dispatch.AlignJobs(windows, adapters, pairs))
    if mode == 'run':
        got, want = (j.run() for j in jobs)
        for f in FIELDS + ('read_end_excl',):
            assert np.array_equal(got[f], want[f]), f
        assert (got['full_pct'] >= 90).any()
    elif mode == 'run_group_score_max':
        groups = pairs[:, 1] * 2 + pairs[:, 0] % 2
        got, want = (j.run_group_score_max(groups, 6) for j in jobs)
        assert np.array_equal(got, want)
    else:
        # Under a prefilter only full_pct >= threshold and the passing
        # lanes' values are specified: long rungs run the full walk here
        # (as on a TPU) and the JAX package's CPU path scores them first.
        prefilter = 90.0 if mode == 'run_stats_prefilter' else None
        got, want = (j.run_stats(prefilter=prefilter) for j in jobs)
        hit = want['full_pct'] >= 90.0
        assert hit.any()
        assert np.array_equal(got['full_pct'] >= 90.0, hit)
        for f in ('full_pct', 'matches', 'full_len'):
            assert np.array_equal(got[f][hit], want[f][hit]), f
            if prefilter is None:
                assert np.array_equal(got[f], want[f]), f
    # The 900 bp window (rung 1,024) takes the trace-bit forward only in
    # run mode; the stats and score modes keep it on their own kernels.
    long_rungs = [24_576, 32_768]
    assert sorted({shape[1] for shape in tiled_calls}) == (
        [1_024] + long_rungs if mode == 'run' else long_rungs)


def test_replay_rounds_at_rung_24576_match_jax(tiled_calls):
    """Two replay rounds of a replay set whose longest read sits at window
    rung 24,576, against the JAX ReplayRunner."""
    rng = np.random.default_rng(29)
    adapters = [rng.integers(0, 4, 28).astype(np.int8),
                rng.integers(0, 4, 22).astype(np.int8)]
    reads = [rng.integers(0, 4, n).astype(np.int8)
             for n in (20_000, 13_000, 700, 17_500)]
    for r in reads[:3]:
        for _ in range(2):
            pos = int(rng.integers(0, len(r) - 28))
            r[pos:pos + 28] = adapters[0]
    runner = middle.ReplayRunner(reads, adapters, device='cpu')
    jrunner = jax_middle.ReplayRunner(reads, adapters)
    assert runner.L == 24_576
    a_idx = np.zeros(len(reads), np.int32)
    ms = np.zeros(len(reads), np.int32)
    me = np.zeros(len(reads), np.int32)
    for _ in range(2):
        got = runner.round(a_idx, ms, me)
        want = jrunner.round(a_idx, ms, me)
        for f in FIELDS + ('read_end_excl', 'full_pct'):
            assert np.array_equal(got[f], want[f]), f
        assert (got['full_pct'] >= 90).any()
        ms = np.where(got['read_start'] >= 0, got['read_start'],
                      0).astype(np.int32)
        me = got['read_end_excl'].astype(np.int32)
    assert runner.h2d_read_bytes == jrunner.h2d_read_bytes
    assert runner.h2d_round_bytes == jrunner.h2d_round_bytes
    assert tiled_calls == [(32, 24_576)] * 2


def test_replay_rounds_split_under_the_bits_budget_match_jax(monkeypatch,
                                                           tiled_calls):
    """A replay set whose trace bits do not fit one launch runs in several,
    longest reads first, each at its own longest read's rung, and gives
    the JAX ReplayRunner's results (one launch) all the same."""
    monkeypatch.setattr(dispatch, '_CELL_BUDGET', 1)   # 32 lanes a launch
    rng = np.random.default_rng(31)
    adapters = [rng.integers(0, 4, 28).astype(np.int8),
                rng.integers(0, 4, 22).astype(np.int8)]
    reads = [rng.integers(0, 4, int(n)).astype(np.int8)
             for n in rng.integers(100, 1500, 40)]
    reads[5] = rng.integers(0, 4, 17_000).astype(np.int8)
    for r in reads[::3]:
        for _ in range(2):
            pos = int(rng.integers(0, len(r) - 28))
            r[pos:pos + 28] = adapters[0]
    runner = middle.ReplayRunner(reads, adapters, device='cpu')
    jrunner = jax_middle.ReplayRunner(reads, adapters)
    assert runner.L == 24_576
    lens = np.array([len(r) for r in reads])
    first, second = (g.lanes for g in runner._launches)
    assert len(first) == 32 and len(second) == 8
    assert lens[first].min() >= lens[second].max()
    a_idx = np.zeros(len(reads), np.int32)
    ms = np.zeros(len(reads), np.int32)
    me = np.zeros(len(reads), np.int32)
    for _ in range(2):
        got = runner.round(a_idx, ms, me)
        want = jrunner.round(a_idx, ms, me)
        for f in FIELDS + ('read_end_excl', 'full_pct'):
            assert np.array_equal(got[f], want[f]), f
        assert (got['full_pct'] >= 90).any()
        ms = np.where(got['read_start'] >= 0, got['read_start'],
                      0).astype(np.int32)
        me = got['read_end_excl'].astype(np.int32)
    second_rung = dispatch.bucket_len(int(lens[second].max()))
    assert tiled_calls == [(32, 24_576), (32, second_rung)] * 2


@pytest.fixture(scope='module')
def long_reads_fastq(tmp_path_factory):
    """16 reads of 13-40 kb, half of them chimeric (middle adapters)."""
    path = str(tmp_path_factory.mktemp('torch_tiled') / 'reads.fastq')
    write_fastq(path, synth_mixed([(6, 13_000), (5, 20_000), (3, 30_000),
                                   (2, 40_000)], chimera_rate=0.5))
    return path


def _cli(main, workdir, args, **kw):
    old = os.getcwd()
    os.chdir(workdir)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(args, **kw)
        with open(args[args.index('-o') + 1], 'rb') as f:
            return buf.getvalue(), f.read()
    finally:
        os.chdir(old)


@pytest.mark.parametrize('verbosity', ['0', '1'])
def test_cli_on_long_reads_is_byte_identical(long_reads_fastq, tmp_path,
                                             verbosity, tiled_calls):
    os.makedirs(tmp_path / 'jax')
    os.makedirs(tmp_path / 'torch')
    os.symlink(long_reads_fastq, tmp_path / 'reads.fastq')
    args = ['-i', '../reads.fastq', '-o', 'out.fastq', '-t', '4',
            '-v', verbosity]
    want = _cli(jax_cli.main, tmp_path / 'jax', args)
    got = _cli(torch_cli.main, tmp_path / 'torch', args, device='cpu')
    assert tiled_calls
    if verbosity == '1':
        assert 'Splitting' in want[0]
    assert got[1] == want[1]
    assert got[0].replace(str(tmp_path / 'torch'), '<dir>') == \
        want[0].replace(str(tmp_path / 'jax'), '<dir>')
