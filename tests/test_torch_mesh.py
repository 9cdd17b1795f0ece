"""Lanes split over several device entries in one process
(porechop_tpu_torch/parallel/mesh.py and the planner's shards), on the CPU
with entries that name the CPU more than once: every AlignJobs mode on 2,
3 and 4 entries against one entry, mesh.sharded_align and
mesh.detection_step against the JAX package's on the 8-device CPU mesh of
tests/conftest.py, and the CLI with --device cpu,cpu against
porechop_tpu.cli.main.  Tolerance: exact (integers; percent identities
are the same float64 round trip of equal integers; bytes)."""

import collections
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import porechop_tpu.cli as jax_cli
from porechop_tpu.parallel import mesh as jax_mesh
from porechop_tpu_torch import cli as torch_cli
from porechop_tpu_torch.ops import dispatch, engine_v2, kernels, middle
from porechop_tpu_torch.parallel import mesh
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import (FIELDS, MODES, align_jobs, one_torch_thread,
                               run_mode)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@contextlib.contextmanager
def counted_forwards():
    """Counts the calls of each DP forward wrapper made inside the block
    (on the CPU they run the plain versions, which LAUNCHES does not
    count)."""
    calls = collections.Counter()

    def counting(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call
    with pytest.MonkeyPatch.context() as mp:
        for name in kernels.LAUNCHES:
            mp.setattr(kernels, name, counting(name, getattr(kernels, name)))
        yield calls


def run_counted(mode, jobs, device):
    """run_mode, and its forward calls by kernel."""
    with counted_forwards() as calls:
        res = run_mode(mode, jobs, device)
    return res, calls


@pytest.fixture(scope='module')
def one_entry():
    """Every mode's result and forward calls on one entry.  The jobs hold
    windows on three rungs (one past the group max's rung guard), an
    empty window and three adapter rungs; a rung's 90 lanes pad to 128,
    so with four entries the last shard holds pad lanes only."""
    jobs = align_jobs(6)
    return jobs, {m: run_counted(m, jobs, 'cpu') for m in MODES}


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('entries', [2, 3, 4])
def test_entries_equal_one_entry(one_entry, entries, mode):
    """The same results, and every launch of the planner split into one
    forward per entry (every launch pads to at least 32 lanes)."""
    jobs, want = one_entry
    got, calls = run_counted(mode, jobs, ','.join(['cpu'] * entries))
    want, want_calls = want[mode]
    assert want_calls and calls == {k: entries * n
                                    for k, n in want_calls.items()}
    for f in want:
        assert np.array_equal(got[f], want[f], equal_nan=True), f


@pytest.mark.parametrize('n,parts,want', [
    (128, 2, [(0, 64), (64, 128)]),
    (32, 3, [(0, 11), (11, 22), (22, 32)]),
    (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)])])
def test_split_lanes_is_contiguous_and_even(n, parts, want):
    assert mesh.split_lanes(n, parts) == want


def test_device_entries_parse():
    cpu = torch.device('cpu')
    assert dispatch.resolve_devices('cpu,cpu') == [cpu, cpu]
    assert dispatch.resolve_devices(['cpu', cpu, 'cpu']) == [cpu] * 3
    assert dispatch.resolve_devices(cpu) == [cpu]
    with pytest.raises(ValueError):
        dispatch.resolve_devices([])


@pytest.mark.parametrize('cards,disabled,want', [
    (1, False, ['cuda']), (2, False, ['cuda:0', 'cuda:1']),
    (4, True, ['cuda'])])
def test_local_devices(monkeypatch, cards, disabled, want):
    """Every local card when there is more than one, unless
    PORECHOP_TPU_DISABLE_MESH is set (porechop_tpu/parallel/mesh.py:67)."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    monkeypatch.delenv('PORECHOP_TPU_DISABLE_MESH', raising=False)
    if disabled:
        monkeypatch.setenv('PORECHOP_TPU_DISABLE_MESH', '1')
    assert mesh.local_devices() == [torch.device(d) for d in want]


@pytest.mark.parametrize('parts', [2, 3, 5])
def test_merge_groupmax_equals_one_reduce(parts):
    """The exact merge of each part's group maxima equals the group max
    over all lanes, ties of equal fractions (small integers make many)
    and groups that some parts never reach included."""
    rng = np.random.default_rng(parts)
    B, G = 300, 7
    m = rng.integers(0, 6, B)
    ln = m + rng.integers(0, 6, B)
    ok = (ln > 0) & (rng.random(B) < 0.9)
    g = rng.integers(1, G, B)
    g[:40] = 0                              # group 0 only in the first part
    t = [torch.from_numpy(x) for x in (m, ln, ok, g)]
    want = engine_v2.groupmax_reduce(*t, G)
    got = engine_v2.merge_groupmax([
        tuple(x.numpy() for x in engine_v2.groupmax_reduce(
            *(x[lo:hi] for x in t), G))
        for lo, hi in mesh.split_lanes(B, parts)])
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


def _dense(seed, B, L, A):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    rl = rng.integers(1, L + 1, B).astype(np.int32)
    adps = rng.integers(0, 5, (B, A)).astype(np.int8)
    al = rng.integers(1, A + 1, B).astype(np.int32)
    for k in range(0, B, 3):
        if rl[k] > al[k]:
            pos = int(rng.integers(0, rl[k] - al[k]))
            reads[k, pos:pos + al[k]] = adps[k, :al[k]]
    return reads, rl, adps, al


@pytest.mark.parametrize('entries', [2, 3])
def test_sharded_align_matches_jax(entries):
    batch = _dense(17, 61, 120, 24)
    got = mesh.sharded_align(['cpu'] * entries, *batch)
    want = jax_mesh.sharded_align(jax_mesh.make_mesh(), *batch)
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize('entries', [2, 4])
def test_detection_step_matches_jax(entries):
    reads, rl, adps, al = _dense(3, 32, 64, 16)
    rl[:] = 64
    al[:] = 16
    set_ids = (np.arange(32) % 5).astype(np.int32)
    got = mesh.detection_step(['cpu'] * entries, reads, rl, adps, al,
                              set_ids, 6)
    want = jax_mesh.detection_step(jax_mesh.make_mesh(), reads, rl, adps, al,
                                   set_ids, 6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_replay_runs_on_the_first_entry():
    """ReplayRunner does not shard (the JAX replay does not): given
    device entries it runs on the first."""
    reads = [np.zeros(40, np.int8)]
    runner = middle.ReplayRunner(reads, [np.ones(20, np.int8)],
                                 device='cpu,cpu')
    assert runner.device == torch.device('cpu')


@pytest.mark.parametrize('verbosity', ['0', '1'])
def test_cli_device_entries_are_byte_identical(tmp_path, verbosity):
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(24, 2000, seed=8, chimera_rate=0.3))
    outs = []
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('torch', torch_cli.main,
                               ['--device', 'cpu,cpu'])):
        os.makedirs(tmp_path / name)
        old = os.getcwd()
        os.chdir(tmp_path / name)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                main(['-i', '../reads.fastq', '-o', 'out.fastq', '-v',
                      verbosity] + extra)
            with open('out.fastq', 'rb') as f:
                outs.append((buf.getvalue().replace(str(tmp_path / name),
                                                    '<dir>'), f.read()))
        finally:
            os.chdir(old)
    assert outs[0][1] and outs[0] == outs[1]
