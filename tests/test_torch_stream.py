"""The PyTorch port's --stream runs (porechop_tpu_torch.pipeline.stream, on
the CPU) against the JAX package's in-memory runs
(porechop_tpu.cli.main) on small synthetic inputs: output files, bins and
transcripts must be byte-identical, memory must stay at one chunk, and
a failure while writing must surface."""

import contextlib
import gc
import gzip
import io
import os
import shutil

import pytest
import torch

import porechop_tpu.cli as jax_cli
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.pipeline import model, stream
from porechop_tpu_torch.utils.synth import (synth_barcoded, synth_reads,
                                             write_fastq)

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """reads.fastq: 32 synthetic 1.5 kb reads, three in ten chimeric;
    barcoded.fastq: 24 natively barcoded 1 kb reads (barcodes 1-3);
    albacore/: barcoded.fastq split over barcode01/, barcode02/ and
    unclassified/ as Albacore writes them."""
    d = tmp_path_factory.mktemp('torch_stream')
    write_fastq(str(d / 'reads.fastq'),
                synth_reads(32, 1500, seed=3, chimera_rate=0.3))
    barcoded = synth_barcoded(24, 1000, seed=5, barcodes=range(1, 4),
                              chimera_rate=0.3)
    write_fastq(str(d / 'barcoded.fastq'), barcoded)
    for sub, part in (('barcode01', barcoded[:10]),
                      ('barcode02', barcoded[10:19]),
                      ('unclassified', barcoded[19:])):
        os.makedirs(d / 'albacore' / sub)
        write_fastq(str(d / 'albacore' / sub / 'reads.fastq'), part)
    return d


def _snapshot(root):
    """{relative path: bytes} of every file under root, gz decompressed."""
    out = {}
    for dir_path, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dir_path, f)
            opener = gzip.open if f.endswith('.gz') else open
            with opener(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _run(main, workdir, args, **kw):
    """Runs a CLI in a fresh `workdir` with relative paths; returns
    (stdout, stderr, {file: bytes} it wrote), with workdir's path in the
    text replaced by <dir>."""
    os.makedirs(workdir)
    old = os.getcwd()
    os.chdir(workdir)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(args, **kw)
    finally:
        os.chdir(old)
    return (out.getvalue().replace(str(workdir), '<dir>'),
            err.getvalue().replace(str(workdir), '<dir>'),
            _snapshot(workdir))


@pytest.fixture(scope='module')
def jax_run(inputs, tmp_path_factory):
    """The JAX package's in-memory run of some flags, made once per module."""
    done = {}

    def run(args):
        key = tuple(args)
        if key not in done:
            work = tmp_path_factory.mktemp('jax') / 'run'
            done[key] = _run(jax_cli.main, work,
                             [a.replace('@', str(inputs) + '/')
                              for a in args])
        return done[key]
    return run


def _port(inputs, workdir, args, **kw):
    return _run(torch_cli.main, workdir,
                [a.replace('@', str(inputs) + '/') for a in args],
                device='cpu', **kw)


@pytest.mark.parametrize('chunk', ['7', '1000'])
@pytest.mark.parametrize('v', ['0', '1'])
def test_streamed_output_matches_jax(inputs, jax_run, tmp_path, v, chunk):
    """Chunks of 7 leave an uneven last chunk; 1,000 is one chunk."""
    args = ['-i', '@reads.fastq', '-o', 'out.fastq', '-v', v, '-t', '4']
    want = jax_run(args)
    got = _port(inputs, tmp_path / 'w', args + ['--stream', chunk])
    if v == '1':
        assert 'Splitting' in want[0]
    assert got == want


def test_streamed_stdout_matches_jax(inputs, jax_run, tmp_path):
    """Reads to stdout, the transcript to stderr."""
    args = ['-i', '@reads.fastq', '-v', '1', '-t', '4']
    want = jax_run(args)
    got = _port(inputs, tmp_path / 'w', args + ['--stream', '5'])
    assert want[0].startswith('@read_') and 'Done' in want[1]
    assert got == want


def test_streamed_gz_output_matches_jax(inputs, jax_run, tmp_path):
    args = ['-i', '@reads.fastq', '-o', 'out.fastq.gz', '-v', '1', '-t', '4']
    want = jax_run(args)
    got = _port(inputs, tmp_path / 'w', args + ['--stream', '6'])
    assert list(want[2]) == ['out.fastq.gz']
    assert got == want


def test_streamed_barcode_bins_match_jax(inputs, jax_run, tmp_path):
    args = ['-i', '@barcoded.fastq', '-b', 'bins', '-v', '1', '-t', '4']
    want = jax_run(args)
    got = _port(inputs, tmp_path / 'w', args + ['--stream', '10'])
    assert {'bins/BC01.fastq', 'bins/none.fastq'} <= set(want[2])
    assert got == want


def test_streamed_barcode_bins_at_v0_match_jax_v1(inputs, jax_run, tmp_path):
    """The JAX package's -b -v 0 prefilters detection, which may zero the
    sub-threshold side's score that choose_barcoding_kit sums (a known
    fault, ROADMAP Queue 3); the port keeps exact scores for -b, so its
    -v 0 bins are held against the JAX package's -v 1 bins."""
    base = ['-i', '@barcoded.fastq', '-b', 'bins', '-t', '4']
    want = jax_run(base + ['-v', '1'])
    got = _port(inputs, tmp_path / 'w', base + ['-v', '0', '--stream', '10'])
    assert got[2] == want[2]
    assert got[0] == got[1] == ''


def test_stream_flag_equals_environment(inputs, tmp_path, monkeypatch):
    calls = []
    real = stream.run_streaming
    monkeypatch.setattr(stream, 'run_streaming',
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    args = ['-i', '@reads.fastq', '-o', 'out.fastq', '-v', '1']
    by_flag = _port(inputs, tmp_path / 'flag', args + ['--stream', '16'])
    monkeypatch.setenv('PORECHOP_TPU_STREAM', '16')
    by_env = _port(inputs, tmp_path / 'env', args)
    assert calls == [16, 16]
    assert by_flag == by_env


def test_v2_runs_in_memory(inputs, jax_run, tmp_path, monkeypatch):
    """-v 2 prints per-read dumps in input order, so --stream does not
    apply: the run takes the in-memory path on the same device."""
    calls = []
    monkeypatch.setattr(stream, 'run_streaming',
                        lambda *a, **k: calls.append(a))
    args = ['-i', '@reads.fastq', '-o', 'out.fastq', '-v', '2', '-t', '4']
    want = jax_run(args)
    got = _port(inputs, tmp_path / 'w', args + ['--stream', '5'])
    assert calls == []
    assert got == want


def test_streamed_albacore_directory_matches_jax(inputs, jax_run, tmp_path):
    """Directory input: sorted files, per-file check-read heads and the
    Albacore barcode calls from the barcodeNN/ and unclassified/ paths."""
    args = ['-i', '@albacore', '-b', 'bins', '-v', '1', '-t', '4',
            '--check_reads', '9']
    want = jax_run(args)
    got = _port(inputs, tmp_path / 'w', args + ['--stream', '8'])
    assert 'Searching for FASTQ files' in want[0]
    assert got == want


@pytest.mark.parametrize('source', ['reads.fastq', 'albacore'])
def test_record_ranges_partition_the_input(inputs, source):
    """Consecutive record ranges (the multi-process blocks) give the whole
    input in order, for a file and for a directory, with the directory's
    Albacore barcode calls."""
    path = str(inputs / source)
    whole = [(r.name, r.seq, r.albacore_barcode_call)
             for r in stream.iter_input_reads(path)]
    n = stream.count_records(path)
    assert len(whole) == n > 20
    cuts = [0, 0, 7, n // 2, n - 1, n, n]
    parts = [(r.name, r.seq, r.albacore_barcode_call)
             for lo, hi in zip(cuts, cuts[1:])
             for r in stream.iter_input_reads(path, (lo, hi))]
    assert parts == whole
    if source == 'albacore':
        assert {c for _, _, c in whole} == {'BC01', 'BC02', 'none'}


def test_writer_exception_surfaces(inputs, tmp_path, monkeypatch):
    """A failure while a chunk is written stops the run with that
    exception: no later chunk is computed."""
    written = []
    computed = []
    real = model.Read.get_fastq
    real_ends = stream.find_adapters_at_read_ends

    def failing(self, *a):
        written.append(self.name)
        if len(written) == 9:
            raise OSError('disk full')
        return real(self, *a)

    monkeypatch.setattr(model.Read, 'get_fastq', failing)
    monkeypatch.setattr(stream, 'find_adapters_at_read_ends',
                        lambda reads, *a, **k: computed.append(len(reads))
                        or real_ends(reads, *a, **k))
    with pytest.raises(OSError, match='disk full'):
        _port(inputs, tmp_path / 'w',
              ['-i', '@reads.fastq', '-o', 'out.fastq', '-v', '0',
               '--stream', '4'])
    assert len(written) == 9          # the first read of the third chunk
    assert computed == [4, 4, 4]


def test_memory_stays_at_a_few_chunks(tmp_path, monkeypatch):
    """120 short reads in chunks of 5 (24 chunks): at every chunk's phase 2
    the live Read objects are the 10 check reads and the chunk, never the
    whole input."""
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(120, 300, seed=4, chimera_rate=0.3))
    live = []
    real = stream.find_adapters_at_read_ends

    def counting(reads, *a, **k):
        gc.collect()
        live.append(sum(type(o) is model.Read for o in gc.get_objects()))
        return real(reads, *a, **k)

    monkeypatch.setattr(stream, 'find_adapters_at_read_ends', counting)
    _port(tmp_path, tmp_path / 'w',
          ['-i', '@reads.fastq', '-o', 'out.fastq', '-v', '0',
           '--check_reads', '10', '--stream', '5'])
    assert len(live) == 24
    assert max(live) <= 10 + 5


def test_streamed_run_without_a_card_raises(inputs, tmp_path, monkeypatch):
    """No device named and no card: the streamed run raises; there is no
    CPU fallback."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _run(torch_cli.main, tmp_path / 'w',
             ['-i', str(inputs / 'reads.fastq'), '-o', 'out.fastq',
              '-v', '0', '--stream', '5'])
    shutil.rmtree(tmp_path / 'w')
