"""The PyTorch port's hybrid host/device execution (ops/dispatch.py: the size
route to the native engine, the work-share model, the adapter-rung merge,
push-back; ops/middle.py's replay rule; PORECHOP_TPU_FORCE_HOST) on the
CPU, against the JAX package on the same seeded inputs.  Tolerance: exact
(the planner's decisions are integers and index lists; results are
integers, and percent identities the same float64 round trip of equal
integers)."""

import contextlib
import io
import os
import threading

import numpy as np
import pytest

import porechop_tpu.cli as jax_cli
from porechop_tpu.ops import dispatch as jax_dispatch
from porechop_tpu_torch import cli as torch_cli
from porechop_tpu_torch import native
from porechop_tpu_torch.ops import dispatch, middle
from porechop_tpu_torch.utils.synth import (synth_barcoded, synth_reads,
                                             write_fastq)

from .test_torch_cases import (FIELDS, MODES, align_jobs, one_torch_thread,
                               run_mode)
from .test_torch_multihost import _jax_single, _run_ranks

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# The share model's rates (host, device) in cells/s: equal ones divert
# much work, the port's card defaults little.
RATES = [(1e9, 1e9), (1e9, 4e9),
         (dispatch.AlignJobs._HOST_CELLS_S, dispatch.AlignJobs._DEV_CELLS_S)]


@pytest.fixture
def budgets(monkeypatch):
    """Small launch budgets, the same in both packages, so that a few
    hundred jobs make several chunks per bucket."""
    for mod in (dispatch, jax_dispatch):
        monkeypatch.setattr(mod, '_CELL_BUDGET', 64 * 1025 * 32)
        monkeypatch.setattr(mod, '_GM_CELL_BUDGET', 256 * 1025 * 32)


def _jobs(mode):
    """An empty AlignJobs of each package, set to the mode the share
    model prices ('bits', 'stats', 'group' or 'score')."""
    jobs = (dispatch.AlignJobs([], [], np.zeros((0, 2)), device='cpu'),
            jax_dispatch.AlignJobs([], [], np.zeros((0, 2))))
    for j in jobs:
        j._stats_only = mode == 'stats'
        j._score_only = mode == 'score'
        j._group = (np.zeros(0, np.int64), 1) if mode == 'group' else None
    return jobs


def _buckets(seed):
    rng = np.random.default_rng(seed)
    sizes = {(150, 24): 1000, (150, 32): 40, (1024, 32): 300,
             (1024, 48): 70, (2048, 64): 33}
    lo, out = 0, {}
    for key, n in sizes.items():
        n = int(rng.integers(n // 2, n + 1))
        out[key] = np.arange(lo, lo + n)
        lo += n
    return out


def _split(jobs, buckets, hybrid):
    small, dev = [], []
    for (lb, amax), idxs in sorted(buckets.items()):
        for chunk in jobs._chunk_split(idxs, lb, amax):
            cells = dispatch._pad_cells(lb, amax, len(chunk))
            (small if cells < hybrid else dev).append((lb, amax, chunk))
    return small, dev


def _same_work(a, b):
    assert [(lb, amax, c.tolist()) for lb, amax, c in a] == \
        [(lb, amax, c.tolist()) for lb, amax, c in b]


@pytest.mark.parametrize('rates', RATES)
@pytest.mark.parametrize('mode', ['bits', 'stats', 'group', 'score'])
def test_share_decides_as_jax(budgets, monkeypatch, mode, rates):
    """_share_with_native keeps and diverts exactly the slices the JAX
    package's does, on the same chunks, rates and mode."""
    rh, rd = rates
    for cls in (dispatch.AlignJobs, jax_dispatch.AlignJobs):
        monkeypatch.setattr(cls, '_HOST_CELLS_S', rh)
        for name in ('_DEV_CELLS_S', '_DEV_CELLS_S_STATS',
                     '_DEV_CELLS_S_SCORE'):
            monkeypatch.setattr(cls, name, rd)
    port, jax = _jobs(mode)
    diverted = 0
    for seed, hybrid in ((1, 0), (2, 3_000_000), (3, 40_000_000)):
        buckets = _buckets(seed)
        for (lb, amax), idxs in buckets.items():
            assert [c.tolist() for c in port._chunk_split(idxs, lb, amax)] \
                == [c.tolist() for c, _ in jax._chunk_split(idxs, lb, amax)]
        small, dev = _split(port, buckets, hybrid)
        want_small = list(small)
        want_dev = jax._share_with_native([c for _, _, c in small],
                                          want_small, list(dev))
        got_small = list(small)
        got_dev = port._share_with_native(got_small, list(dev))
        _same_work(got_dev, want_dev)
        _same_work(got_small, want_small)
        diverted += len(got_small) - len(small)
    if rates == (1e9, 1e9):
        assert diverted, 'equal rates must divert'


@pytest.mark.parametrize('hybrid,merge', [
    (32 * 257 * 24, 120_000_000), (0, 120_000_000), (32 * 257 * 24, 0),
    (0, 10 ** 12)])
def test_merge_decides_as_jax(monkeypatch, hybrid, merge):
    """_merge_adapter_rungs merges exactly the JAX package's buckets, and
    holds its post-split rule (the JAX package's
    test_merge_respects_post_split_routing): a job that the split before
    the merge routes to the native engine never lands in a wider adapter
    rung."""
    for mod in (dispatch, jax_dispatch):
        monkeypatch.setattr(mod, '_CELL_BUDGET', 32 * 257 * 64)
    monkeypatch.setattr(jax_dispatch, '_HYBRID_CELLS', hybrid)
    monkeypatch.setattr(jax_dispatch.AlignJobs, '_MERGE_CELLS_PER_LAUNCH',
                        merge)
    port, jax = _jobs('bits')
    lb = 256
    buckets = {(lb, 16): np.arange(0, 40), (lb, 24): np.arange(100, 180),
               (lb, 64): np.arange(200, 264), (1024, 24): np.arange(300, 340),
               (1024, 32): np.arange(400, 530)}
    got = {k: v.copy() for k, v in buckets.items()}
    want = {k: v.copy() for k, v in buckets.items()}
    port._merge_adapter_rungs(got, hybrid, merge)
    jax._merge_adapter_rungs(want, hybrid > 0)
    assert {k: v.tolist() for k, v in got.items()} == \
        {k: v.tolist() for k, v in want.items()}
    if merge == 10 ** 12:
        assert len(got) < len(buckets), 'a cheap launch price must merge'
    native_pre = {int(x) for (l, a), idxs in buckets.items()
                  for c in port._chunk_split(idxs, l, a)
                  if dispatch._pad_cells(l, a, len(c)) < hybrid for x in c}
    rung_of = {int(x): a for (_, a), idxs in buckets.items() for x in idxs}
    for (_, a), idxs in got.items():
        assert not [x for x in idxs if int(x) in native_pre
                    and a > rung_of[int(x)]]
    assert sorted(x for v in got.values() for x in v.tolist()) == \
        sorted(x for v in buckets.values() for x in v.tolist())


def _jax_mode(mode, jobs):
    """run_mode's counterpart on the JAX package's AlignJobs."""
    windows, adapters, pairs, groups, n_groups = jobs
    j = jax_dispatch.AlignJobs(windows, adapters, pairs)
    if mode == 'run_stats_prefilter':
        res = j.run_stats(prefilter=90.0)
    elif mode.startswith('run_group'):
        res = getattr(j, mode)(groups, n_groups)
    else:
        res = getattr(j, mode)()
    return res if isinstance(res, dict) else {'': res}


@pytest.fixture
def both_routes(monkeypatch):
    """A threshold under which align_jobs' rung-150 chunks run on the
    native engine and its longer windows on the device entries."""
    monkeypatch.setattr(dispatch, '_HYBRID_CELLS', 1_000_000)
    monkeypatch.setattr(native, '_FAILED', None)
    dispatch.reset_routes()
    yield
    dispatch.reset_routes()


@pytest.mark.parametrize('mode', MODES)
def test_modes_with_both_routes_match_jax_and_the_device(both_routes,
                                                         monkeypatch, mode):
    """Every AlignJobs mode with both routes engaged equals the JAX
    package's AlignJobs and the port with the threshold at 0."""
    jobs = align_jobs(11)
    got = run_mode(mode, jobs, 'cpu')
    assert dispatch.ROUTES['native'][0] > 0
    assert dispatch.ROUTES['device'][0] > 0
    monkeypatch.setattr(dispatch, '_HYBRID_CELLS', 0)
    dev = run_mode(mode, jobs, 'cpu')
    windows, adapters, pairs, groups, n_groups = jobs
    want = _jax_mode(mode, jobs)
    for ref in (want, dev):
        assert set(got) == set(ref)
        for f in got:
            if mode == 'run_stats_prefilter' and f != 'full_pct':
                # Sub-threshold lanes' stats are not meaningful.
                hit = ref['full_pct'] >= 90.0
                assert np.array_equal(got[f][hit], ref[f][hit]), f
            else:
                assert np.array_equal(got[f], ref[f], equal_nan=True), f


@pytest.mark.parametrize('failure', ['none', 'load', 'bug'])
def test_native_failure_pushback_rebuilds_tables(monkeypatch, capsys,
                                                 failure):
    """When the native batch returns nothing or its library fails to load
    after the rung's tables were built from the device chunks, its chunks
    run on the device entries, with a note on stderr, and the tables are
    rebuilt to cover their windows (the JAX package's
    test_native_failure_pushback_rebuilds_tables); any other error in the
    engine reaches the caller.  Bucket (150, 24) at 64 lanes a launch
    splits 96 jobs into a 64-lane device chunk and a 32-lane chunk for
    the native engine (115,968 cells < 200,000)."""
    monkeypatch.setattr(dispatch, '_CELL_BUDGET', 151 * 24 * 64)
    monkeypatch.setattr(dispatch, '_HYBRID_CELLS', 200_000)
    monkeypatch.setattr(native, 'available', lambda: True)

    def dead(*a, **k):
        if failure == 'load':
            raise OSError('the library went away')
        if failure == 'bug':
            raise RuntimeError('an engine fault')
        return None
    monkeypatch.setattr(native, 'align_batch', dead)
    rng = np.random.default_rng(17)
    n = 96
    windows = [rng.integers(0, 4, 150).astype(np.int8) for _ in range(n)]
    adapters = [rng.integers(0, 4, int(rng.integers(18, 25))).astype(np.int8)
                for _ in range(4)]
    # Job k uses window k: the last 32 windows are only in the pushed-back
    # chunk, which a stale table would send to the dummy row.
    pairs = np.column_stack([np.arange(n), rng.integers(0, 4, n)])
    dispatch.reset_routes()
    if failure == 'bug':
        with pytest.raises(RuntimeError, match='an engine fault'):
            dispatch.AlignJobs(windows, adapters, pairs, device='cpu').run()
        return
    got = dispatch.AlignJobs(windows, adapters, pairs, device='cpu').run()
    assert dispatch.ROUTES['native'] == [0, 0]
    assert dispatch.ROUTES['device'][0] == n
    assert 'its 32 jobs run on the device' in capsys.readouterr().err
    want = jax_dispatch.AlignJobs(windows, adapters, pairs).run()
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f


def test_native_batch_runs_beside_the_launches(both_routes, monkeypatch):
    """The native batch runs on a worker thread, started before the first
    device launch, and an exception there reaches the caller."""
    from porechop_tpu_torch.parallel import mesh
    events = []
    batch = dispatch.AlignJobs._native_batch
    launch = mesh.launch_shards

    def native_side(self, todo):
        events.append(('native', threading.get_ident()))
        return batch(self, todo)

    def device_side(*a, **k):
        events.append(('launch', threading.get_ident()))
        return launch(*a, **k)
    monkeypatch.setattr(dispatch.AlignJobs, '_native_batch', native_side)
    monkeypatch.setattr(mesh, 'launch_shards', device_side)
    windows, adapters, pairs, _, _ = align_jobs(12)
    dispatch.AlignJobs(windows, adapters, pairs, device='cpu').run()
    kinds = [k for k, _ in events]
    assert 'native' in kinds and 'launch' in kinds
    assert dict(events)['native'] != threading.get_ident()
    assert dict(events)['launch'] == threading.get_ident()

    def broken(*a, **k):
        raise ValueError('bad pairs')
    monkeypatch.setattr(native, 'align_batch', broken)
    with pytest.raises(ValueError, match='bad pairs'):
        dispatch.AlignJobs(windows, adapters, pairs, device='cpu').run()


def test_the_hybrid_is_off_by_default(monkeypatch):
    """With no variable set, the size route and the merge are off on every
    device, a run neither builds nor loads the native engine, and the
    host rate scales with the size route's threads."""
    for name in ('PORECHOP_TPU_HYBRID_CELLS', 'PORECHOP_TPU_MERGE_CELLS',
                 'PORECHOP_TPU_HOST_CELLS_S'):
        assert name not in os.environ
    assert dispatch._HYBRID_CELLS == 0 and dispatch._MERGE_CELLS == 0
    assert dispatch.AlignJobs._HOST_CELLS_S == pytest.approx(
        2.18e9 / 8 * max(1, native.threads() - 1))

    def probed():
        raise AssertionError('the native engine was probed')
    monkeypatch.setattr(native, 'available', probed)
    dispatch.reset_routes()
    windows, adapters, pairs, _, _ = align_jobs(15)
    dispatch.AlignJobs(windows, adapters, pairs, device='cpu').run()
    assert dispatch.ROUTES['native'] == [0, 0]
    assert dispatch.ROUTES['host'] == [0, 0]
    assert dispatch.ROUTES['device'][0] > 0


def test_should_use_device_rules(monkeypatch):
    """porechop_tpu/ops/middle.py's rules (its test_should_use_device_rules)
    at the H100's measured break-even, and the default."""
    monkeypatch.setenv('PORECHOP_TPU_MIDDLE_DEVICE', '1')
    assert middle.should_use_device(1, 100, 24)
    monkeypatch.setenv('PORECHOP_TPU_MIDDLE_DEVICE', '0')
    assert not middle.should_use_device(10 ** 6, 10 ** 5, 256)
    monkeypatch.delenv('PORECHOP_TPU_MIDDLE_DEVICE')
    # The size route off: every replay set on the device.
    assert middle.should_use_device(4, 500, 24)
    monkeypatch.setattr(dispatch, '_HYBRID_CELLS', 13_500_000)
    assert not middle.should_use_device(4, 500, 24)
    assert middle.should_use_device(4096, 10000, 32)
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    monkeypatch.setenv('PORECHOP_TPU_MIDDLE_DEVICE', '1')
    assert not middle.should_use_device(4096, 10000, 32)


@pytest.mark.parametrize('scheme', [(3, -6, -5, -2), (3, -6, -2, -5),
                                    (2, -3, -3, -3), (20, -30, -5, -2)])
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


@pytest.mark.parametrize('mode', MODES)
def test_forced_host_modes_match_jax(monkeypatch, mode):
    """Under PORECHOP_TPU_FORCE_HOST every mode runs on the host engine with
    no device named (this host has no card) and equals the JAX package's
    forced-host run."""
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    dispatch.reset_routes()
    jobs = align_jobs(13)
    got = run_mode(mode, jobs, None)
    assert dispatch.ROUTES['device'] == [0, 0]
    assert dispatch.ROUTES['host'][0] > 0
    want = _jax_mode(mode, jobs)
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


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """reads.fastq: 48 synthetic 2 kb reads, three in ten chimeric;
    barcoded.fastq: 24 natively barcoded 1 kb reads (barcodes 1-3)."""
    d = tmp_path_factory.mktemp('torch_hybrid')
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


def _both(inputs, tmp_path, args, torch_kw=None, jax_args=None):
    for d in ('jax', 'torch'):
        os.makedirs(tmp_path / d)
    for f in ('reads.fastq', 'barcoded.fastq'):
        os.symlink(inputs / f, tmp_path / f)
    want = _run(jax_cli.main, tmp_path / 'jax', jax_args or args)
    got = _run(torch_cli.main, tmp_path / 'torch', args, **(torch_kw or {}))
    return got, want


@pytest.mark.parametrize('flags', [
    ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '0'],
    ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '1'],
    ['-i', '../barcoded.fastq', '-b', 'bins', '-v', '1']])
def test_forced_host_cli_is_byte_identical(inputs, tmp_path, monkeypatch,
                                           flags):
    """PORECHOP_TPU_FORCE_HOST=1 with no device named (this host has no
    card): the whole run on the host engine, byte for byte the JAX
    package's forced-host run."""
    monkeypatch.setenv('PORECHOP_TPU_FORCE_HOST', '1')
    dispatch.reset_routes()
    got, want = _both(inputs, tmp_path, flags + ['-t', '4'])
    assert dispatch.ROUTES['device'] == [0, 0] and dispatch.ROUTES['host'][0]
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


class _NoReplayRunner:
    def __init__(self, *a, **k):
        raise AssertionError('the replay should run in host rounds')


@pytest.mark.parametrize('stream', [None, '16'])
def test_cli_with_both_routes_is_byte_identical(inputs, tmp_path,
                                                monkeypatch, stream):
    """A threshold of 4e6 padded cells puts phase 2 (rung 150) and the
    middle replay on the native engine and detection and the middle
    phase's round 0 on the CPU entries: byte for byte the JAX package's
    in-memory run, in memory and with --stream."""
    monkeypatch.setattr(dispatch, '_HYBRID_CELLS', 4_000_000)
    monkeypatch.setattr(native, '_FAILED', None)
    monkeypatch.setattr(middle, 'ReplayRunner', _NoReplayRunner)
    dispatch.reset_routes()
    args = ['-i', '../reads.fastq', '-o', 'out.fastq', '-v', '1', '-t', '4']
    got, want = _both(inputs, tmp_path,
                      args + (['--stream', stream] if stream else []),
                      torch_kw={'device': 'cpu'}, jax_args=args)
    assert 'Splitting' in want[0]
    assert dispatch.ROUTES['native'][0] > 0
    assert dispatch.ROUTES['device'][0] > 0
    assert got == want
