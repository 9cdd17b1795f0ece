"""The stretch path of the PyTorch port on the CPU: gzipped 1 kb reads
written by the pool (utils.synth.synth_fastq_gz) against
ensure_fastq_streamed's bytes, --stream on gzipped input in one process
and in two ranks against the JAX package's run, failures that surface and
memory that stays at one chunk on gzipped input, and stretch_torch.py's
records."""

import gc
import gzip
import hashlib
import json
import os
import threading

import pytest

import porechop_tpu.cli as jax_cli
import porechop_tpu.utils.synth as jax_synth
import porechop_tpu_torch.cli as torch_cli
import stretch_torch
from porechop_tpu_torch.pipeline import model, stream
from porechop_tpu_torch.utils import synth

from .test_torch_cases import one_torch_thread
from .test_torch_multihost import _run_ranks
from .test_torch_stream import _run

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _gunzip(path):
    with gzip.open(path, 'rb') as f:
        return f.read()


@pytest.mark.parametrize('n,chunk', [(250, 100), (120, 50_000)])
def test_pool_writes_ensure_fastq_streamed_bytes(tmp_path, n, chunk):
    """Parts of `chunk` reads, one a worker, concatenated: the bytes of
    ensure_fastq_streamed, the port's and the JAX package's."""
    synth.synth_fastq_gz(str(tmp_path / 'pool.fastq.gz'), n, 1000, seed=7,
                         chunk=chunk, workers=2)
    synth.ensure_fastq_streamed(str(tmp_path / 'port.fastq.gz'), n, 1000,
                                seed=7, chunk=chunk)
    jax_synth.ensure_fastq_streamed(str(tmp_path / 'jax.fastq.gz'), n, 1000,
                                    seed=7, chunk=chunk)
    got = _gunzip(tmp_path / 'pool.fastq.gz')
    assert got == _gunzip(tmp_path / 'port.fastq.gz')
    assert got == _gunzip(tmp_path / 'jax.fastq.gz')
    assert got.count(b'\n@read_') == n - 1
    assert sorted(os.listdir(tmp_path)) == ['jax.fastq.gz', 'pool.fastq.gz',
                                            'port.fastq.gz']


def test_pool_head_is_the_larger_inputs_head(tmp_path):
    """As the 200,000-read input is the 1M input's head: the same name
    width (three digits here), whole parts."""
    synth.synth_fastq_gz(str(tmp_path / 'a.fastq.gz'), 200, 300, seed=7,
                         chunk=50)
    synth.synth_fastq_gz(str(tmp_path / 'b.fastq.gz'), 350, 300, seed=7,
                         chunk=50)
    head = _gunzip(tmp_path / 'a.fastq.gz')
    assert _gunzip(tmp_path / 'b.fastq.gz')[:len(head)] == head


def test_pool_worker_error_propagates(tmp_path):
    """A worker's error reaches the caller; no part and no file is left."""
    with pytest.raises(ValueError):
        synth.synth_fastq_gz(str(tmp_path / 'bad.fastq.gz'), 100, -5,
                             seed=7, chunk=50, workers=2)
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope='module')
def gz_input(tmp_path_factory):
    """reads.fastq.gz: 160 of the pool's gzipped 1 kb reads (seed 7, as
    the stretch input), in parts of 64 reads."""
    d = tmp_path_factory.mktemp('torch_stretch')
    synth.synth_fastq_gz(str(d / 'reads.fastq.gz'), 160, 1000, seed=7,
                         chunk=64, workers=2)
    return d


@pytest.fixture(scope='module')
def jax_gz_run(gz_input, tmp_path_factory):
    """The JAX package's in-memory run of the gzipped input at -v v on its
    host engine (byte-identical to its device path), made once."""
    done = {}

    def run(v):
        if v not in done:
            os.environ['PORECHOP_TPU_FORCE_HOST'] = '1'
            try:
                done[v] = _run(jax_cli.main,
                               tmp_path_factory.mktemp('jax') / 'run',
                               ['-i', str(gz_input / 'reads.fastq.gz'),
                                '-o', 'out.fastq', '-v', v, '-t', '4'])
            finally:
                del os.environ['PORECHOP_TPU_FORCE_HOST']
        return done[v]
    return run


@pytest.mark.parametrize('v', ['0', '1'])
def test_gz_stream_matches_jax(gz_input, jax_gz_run, tmp_path, v):
    """Four chunks of 40 from the gzipped input: output and transcript
    byte for byte the JAX package's."""
    want = jax_gz_run(v)
    got = _run(torch_cli.main, tmp_path / 'w',
               ['-i', str(gz_input / 'reads.fastq.gz'), '-o', 'out.fastq',
                '-v', v, '-t', '4', '--stream', '40'], device='cpu')
    if v == '1':
        assert 'Splitting' in want[0]
    assert got == want


@pytest.mark.parametrize('v', ['0', '1'])
def test_gz_stream_two_ranks_match_jax(gz_input, jax_gz_run, tmp_path, v):
    """Two CPU ranks, each streaming its block of the gzipped input in
    chunks of 30: the merged output and rank 0's transcript are the JAX
    package's single-process run's."""
    want = jax_gz_run(v)
    ranks, files = _run_ranks(
        ['-i', str(gz_input / 'reads.fastq.gz'), '-o', 'out.fastq', '-v', v,
         '-t', '4', '--device', 'cpu', '--stream', '30'], tmp_path / 'port')
    assert files == want[2]
    assert ranks[0][0] == want[0]
    assert ranks[1][0] == ''


@pytest.fixture(scope='module')
def small_gz(tmp_path_factory):
    """60 gzipped 300 bp reads, three in ten chimeric."""
    d = tmp_path_factory.mktemp('small_gz')
    with gzip.open(d / 'reads.fastq.gz', 'wt') as f:
        for name, seq, quals in synth.synth_reads(60, 300, seed=4,
                                                  chimera_rate=0.3):
            f.write('@%s\n%s\n+\n%s\n' % (name, seq, quals))
    return d


def _stream_small(small_gz, workdir, chunk='10'):
    return _run(torch_cli.main, workdir,
                ['-i', str(small_gz / 'reads.fastq.gz'), '-o', 'out.fastq',
                 '-v', '0', '--check_reads', '10', '--stream', chunk],
                device='cpu')


def test_reader_error_surfaces(small_gz, tmp_path, monkeypatch):
    """A parse failure stops the run with that error, after the chunks
    before it."""
    real = stream._make_read
    made, computed = [0], []

    def failing(*rec):
        made[0] += 1
        if made[0] == 25:
            raise ValueError('bad record')
        return real(*rec)

    real_ends = stream.find_adapters_at_read_ends
    monkeypatch.setattr(stream, '_make_read', failing)
    monkeypatch.setattr(stream, 'find_adapters_at_read_ends',
                        lambda reads, *a, **k: computed.append(len(reads))
                        or real_ends(reads, *a, **k))
    with pytest.raises(ValueError, match='bad record'):
        _stream_small(small_gz, tmp_path / 'w')
    assert computed == [10, 10]


def test_compute_error_surfaces(small_gz, tmp_path, monkeypatch):
    real = stream.find_adapters_in_read_middles
    calls = []

    def failing(reads, *a, **k):
        calls.append(len(reads))
        if len(calls) == 2:
            raise RuntimeError('launch failed')
        return real(reads, *a, **k)

    monkeypatch.setattr(stream, 'find_adapters_in_read_middles', failing)
    with pytest.raises(RuntimeError, match='launch failed'):
        _stream_small(small_gz, tmp_path / 'w')
    assert calls == [10, 10]


def test_writer_error_surfaces(small_gz, tmp_path, monkeypatch):
    written = []
    real = model.Read.get_fastq

    def failing(self, *a):
        written.append(self.name)
        if len(written) == 15:
            raise OSError('disk full')
        return real(self, *a)

    monkeypatch.setattr(model.Read, 'get_fastq', failing)
    with pytest.raises(OSError, match='disk full'):
        _stream_small(small_gz, tmp_path / 'w')
    assert len(written) == 15


def test_live_reads_stay_within_one_chunk(small_gz, tmp_path, monkeypatch):
    """On gzipped input too, the live Read objects (counted as each is
    made and freed) stay within the 10 check reads and one chunk of 5."""
    lock = threading.Lock()
    live, peak = [0], [0]

    class Counted(model.Read):
        def __init__(self, *a):
            super().__init__(*a)
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])

        def __del__(self):
            with lock:
                live[0] -= 1

    monkeypatch.setattr(stream, 'Read', Counted)
    _stream_small(small_gz, tmp_path / 'w', chunk='5')
    gc.collect()
    assert live[0] == 0
    assert 10 < peak[0] <= 10 + 5


def _fake_child(body, walls):
    """A stand-in for stretch_torch.run_child: writes `body` as the
    output, returns the next of `walls` and stats for each rank."""
    calls = []

    def run_child(tree, argv, cwd, ranks=1, profile=False):
        calls.append((str(tree), ranks, argv))
        (cwd / 'out.fastq').write_bytes(body)
        stats = [{'run_s': 1.5, 'rss_mib': 900.0 + r, 'rss_from': 'VmHWM',
                  'ru_maxrss_mib': 950.0, 'detection_rss_mib': 800.0,
                  'device_mib': 250.0, 'cards': ['cuda:%d' % r],
                  'launches': {'forward_score': 3, 'forward_stats': 2,
                               'forward_walk': 7, 'forward_tiled': 0,
                               'walk': 0},
                  'busy_s': 0.1 if profile else None,
                  'parts_s': {'interpreter': 0.25, 'import_torch': 3.0,
                              'port_import': 0.5, 'cuda_context': 0.25,
                              'library_load': 0.125, 'run': 1.5,
                              'exit': 1.0}} for r in range(ranks)]
        return walls.pop(0), stats, [b''] * ranks
    return run_child, calls


@pytest.fixture()
def fake_stretch(tmp_path, monkeypatch, capsys):
    """stretch_torch with its input, kernel build and card stubbed, and
    JAX digests for (200,000, -v 0) set to `body`'s SHA-256."""
    body = b'@read_000000\nACGT\n+\n!!!!\n'
    (tmp_path / 'in.fastq.gz').write_bytes(b'')
    monkeypatch.setattr(stretch_torch, 'WORK', tmp_path / 'work')
    monkeypatch.setattr(stretch_torch, 'make_input',
                        lambda n: (tmp_path / 'in.fastq.gz', 0.5))
    monkeypatch.setattr(stretch_torch, 'build_kernels', lambda tree: None)
    monkeypatch.setattr(stretch_torch, 'card',
                        lambda: 'NVIDIA H100 80GB HBM3, 700.00 W')
    monkeypatch.setattr(stretch_torch, 'JAX_SHA', {(200_000, 0): (
        hashlib.sha256(body).hexdigest(), stretch_torch.EMPTY_SHA)})

    def main(argv, out=body, walls=None):
        child, calls = _fake_child(out, walls or [10.0] * 8)
        monkeypatch.setattr(stretch_torch, 'run_child', child)
        rc = stretch_torch.main(argv)
        lines = capsys.readouterr().out.splitlines()
        return rc, [json.loads(ln) for ln in lines if ln.startswith('{')], \
            calls
    return main


RECORD_KEYS = {
    'config', 'tree', 'card', 'reads', 'read_len', 'chunk', 'verbosity',
    'ranks', 'device', 'wall_s', 'reads_per_s', 'run_s', 'run_s_with_setup',
    'parts_s_by_rank', 'peak_rss_mib',
    'peak_rss_mib_by_rank', 'peak_rss_from', 'ru_maxrss_mib_by_rank',
    'peak_rss_mib_after_detection_by_rank',
    'peak_device_mib',
    'peak_device_mib_by_rank',
    'launches', 'launches_by_rank', 'cards_by_rank', 'output_bytes',
    'output_sha256',
    'transcript_sha256', 'jax_output_sha256', 'jax_equal', 'pair'}


def test_stretch_records_keep_their_fields(fake_stretch):
    rc, records, calls = fake_stretch(['--reads', '200000', '--multihost',
                                       '--profile'])
    assert rc == 0
    assert [r['ranks'] for r in records] == [1, 2, 1]
    for r in records[:2]:
        assert set(r) == RECORD_KEYS
        assert r['jax_equal'] is True
        assert r['card'] == 'NVIDIA H100 80GB HBM3, 700.00 W'
        assert r['reads_per_s'] == 200_000 / 10.0
        assert r['launches']['forward_walk'] == 7 * r['ranks']
    assert records[1]['peak_rss_mib_by_rank'] == [900.0, 901.0]
    assert records[1]['cards_by_rank'] == [['cuda:0'], ['cuda:1']]
    assert records[0]['run_s_with_setup'] == 1.5 + 0.25 + 0.125
    assert records[2]['device_idle_share'] == pytest.approx(1 - 0.1 / 1.5)
    assert calls[0][2] == ['-i', 'reads.fastq.gz', '-o', 'out.fastq', '-v',
                           '0', '-t', '4', '--stream', '20000']


def test_stretch_digest_mismatch_exits_non_zero(fake_stretch):
    rc, records, _ = fake_stretch(['--reads', '200000'], out=b'@other\n')
    assert rc != 0
    assert records[0]['jax_equal'] is False


def test_stretch_pairs_alternate_trees(fake_stretch, tmp_path):
    other = tmp_path / 'parent'
    other.mkdir()
    other = other.resolve()
    walls = [10.0, 11.0, 12.0, 9.0, 8.0, 9.5]
    rc, records, calls = fake_stretch(['--reads', '200000', '--root',
                                       str(other), '--pairs', '3'],
                                      walls=walls)
    assert rc == 0
    assert [c[0] for c in calls] == [str(stretch_torch.ROOT), str(other),
                                     str(other), str(stretch_torch.ROOT),
                                     str(stretch_torch.ROOT), str(other)]
    summary = {s['tree']: s for s in records[-1]['summary']}
    assert summary['this']['walls_s'] == [10.0, 9.0, 8.0]
    assert summary['this']['pairs_won'] == 3
    assert summary[str(other)]['median_wall_s'] == 11.0


def test_stretch_runs_the_cli_in_fresh_processes(tmp_path, monkeypatch,
                                                 capsys):
    """The real children on the CPU (--device cpu), one process and two
    ranks, on 40 pool reads: equal outputs, no launches, the process's own
    numbers."""
    monkeypatch.setattr(stretch_torch, 'WORK', tmp_path)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    rc = stretch_torch.main(['--reads', '40', '--device', 'cpu',
                             '--multihost'])
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{')]
    assert rc == 0
    assert [r['ranks'] for r in records] == [1, 2]
    assert records[0]['output_sha256'] == records[1]['output_sha256']
    for r in records:
        assert r['jax_equal'] is None and r['output_bytes'] > 40 * 1000
        assert r['peak_rss_mib'] > 0 and r['peak_device_mib'] == 0
        assert not any(r['launches'].values())
        for parts in r['parts_s_by_rank']:
            assert list(parts) == [p for p, *_ in stretch_torch.PARTS]
            assert all(t >= 0 for t in parts.values())
            assert parts['cuda_context'] < 0.5     # no card on CPU entries
            assert sum(parts.values()) <= r['wall_s']
