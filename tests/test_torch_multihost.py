"""The PyTorch port's multi-process runs (porechop_tpu_torch.parallel
.multihost): two gloo ranks as subprocesses on 127.0.0.1, on the CPU,
against the JAX package's single-process in-memory run
(porechop_tpu.cli.main): the merged output, bins and rank 0's transcript
must be byte-identical, whatever the blocks hold."""

import contextlib
import gzip
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import porechop_tpu.cli as jax_cli
from porechop_tpu_torch.parallel import multihost
from porechop_tpu_torch.utils.synth import (synth_barcoded, synth_reads,
                                             write_fastq)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """reads.fastq: 40 synthetic 1.5 kb reads, three in ten chimeric;
    barcoded.fastq: 24 natively barcoded 1 kb reads (barcodes 1-3);
    one.fastq: a single chimeric read with exact adapters on both ends."""
    d = tmp_path_factory.mktemp('torch_multihost')
    write_fastq(str(d / 'reads.fastq'),
                synth_reads(40, 1500, seed=3, chimera_rate=0.3))
    write_fastq(str(d / 'barcoded.fastq'),
                synth_barcoded(24, 1000, seed=5, barcodes=range(1, 4),
                               chimera_rate=0.3))
    write_fastq(str(d / 'one.fastq'),
                synth_reads(1, 1500, seed=3, adapter_rate=1.0,
                            chimera_rate=1.0, error_rate=0.0))
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


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _run_ranks(args, workdir, n=2, prelude=None):
    """The port's CLI in n rank processes in a fresh `workdir`; returns
    [(stdout, stderr)] by rank and the files they wrote, with workdir's
    path in the text replaced by <dir>.  Every rank must exit 0.  prelude:
    Python statements that each rank runs before the CLI."""
    os.makedirs(workdir)
    port = _free_port()
    command = [sys.executable, '-m', 'porechop_tpu_torch']
    if prelude:
        command = [sys.executable, '-c', 'import sys\n' + prelude + '\n'
                   'from porechop_tpu_torch.cli import main\n'
                   'main(sys.argv[1:])\n']
    procs = []
    for r in range(n):
        penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                    PORECHOP_TPU_COORDINATOR='127.0.0.1:%d' % port,
                    PORECHOP_TPU_NUM_PROCS=str(n),
                    PORECHOP_TPU_PROC_ID=str(r))
        procs.append(subprocess.Popen(
            command + args,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=penv,
            cwd=workdir))
    outs = []
    try:
        for p in procs:
            # Bytes, not text mode: the progress lines' carriage returns
            # must survive.
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return ([(out.replace(str(workdir), '<dir>'), err)
             for _, out, err in outs], _snapshot(workdir))


def _jax_single(args, workdir):
    """The JAX package's single-process run: (stdout, files)."""
    os.makedirs(workdir)
    old = os.getcwd()
    os.chdir(workdir)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_cli.main(args)
    finally:
        os.chdir(old)
    return out.getvalue().replace(str(workdir), '<dir>'), _snapshot(workdir)


@pytest.mark.parametrize('v,out', [('0', 'out.fastq'), ('1', 'out.fastq'),
                                   ('1', 'out.fastq.gz')])
def test_two_ranks_match_jax(inputs, tmp_path, v, out):
    args = ['-i', str(inputs / 'reads.fastq'), '-o', out, '-v', v, '-t', '4']
    want = _jax_single(args, tmp_path / 'jax')
    ranks, files = _run_ranks(args + ['--device', 'cpu'], tmp_path / 'port')
    assert files == want[1] and list(files) == [out]
    assert ranks[0][0] == want[0]
    assert ranks[1][0] == ''
    if v == '1':
        assert 'Splitting' in want[0]


def test_two_ranks_stdout_output_matches_jax(inputs, tmp_path):
    """Reads to rank 0's stdout, merged from the ranks' parts; no part
    file is left behind."""
    args = ['-i', str(inputs / 'reads.fastq'), '-v', '0']
    want = _jax_single(args, tmp_path / 'jax')
    ranks, files = _run_ranks(args + ['--device', 'cpu'], tmp_path / 'port')
    assert want[0].startswith('@read_')
    assert ranks[0][0] == want[0] and ranks[1][0] == ''
    assert files == {}


def test_two_ranks_barcode_bins_match_jax(inputs, tmp_path):
    args = ['-i', str(inputs / 'barcoded.fastq'), '-b', 'bins', '-v', '1',
            '-t', '4']
    want = _jax_single(args, tmp_path / 'jax')
    ranks, files = _run_ranks(args + ['--device', 'cpu'], tmp_path / 'port')
    assert {'bins/BC01.fastq', 'bins/none.fastq'} <= set(want[1])
    assert files == want[1]
    assert ranks[0][0] == want[0]


def test_two_ranks_v2_gather_in_rounds(inputs, tmp_path):
    """-v 2: every rank's per-read dumps reach rank 0 in read order, here
    in rounds of 256 bytes (multihost.GATHER_CHUNK)."""
    args = ['-i', str(inputs / 'reads.fastq'), '-o', 'out.fastq', '-v', '2',
            '-t', '4']
    want = _jax_single(args, tmp_path / 'jax')
    ranks, files = _run_ranks(
        args + ['--device', 'cpu'], tmp_path / 'port',
        prelude='from porechop_tpu_torch.parallel import multihost\n'
                'multihost.GATHER_CHUNK = 256')
    assert len(want[0]) > 20 * 256
    assert files == want[1]
    assert ranks[0][0] == want[0]


def test_two_ranks_streamed_match_jax(inputs, tmp_path):
    """--stream composed with two ranks: each streams its own block."""
    args = ['-i', str(inputs / 'reads.fastq'), '-o', 'out.fastq', '-v', '1',
            '-t', '4']
    want = _jax_single(args, tmp_path / 'jax')
    ranks, files = _run_ranks(args + ['--device', 'cpu', '--stream', '5'],
                              tmp_path / 'port')
    assert files == want[1]
    assert ranks[0][0] == want[0]


@pytest.mark.parametrize('stream', [[], ['--stream', '5']])
def test_rank_with_an_empty_block(inputs, tmp_path, stream):
    """Two ranks, one read: rank 0's block and check slice are empty, yet
    it makes every collective, in memory and streamed."""
    args = ['-i', str(inputs / 'one.fastq'), '-o', 'out.fastq', '-v', '1']
    want = _jax_single(args, tmp_path / 'jax')
    ranks, files = _run_ranks(args + ['--device', 'cpu'] + stream,
                              tmp_path / 'port')
    assert '1 / 1 reads were split' in want[0]
    assert files == want[1]
    assert ranks[0][0] == want[0]


# Each rank counts the reads that the input parse builds and writes the
# count to loadstats.rank<r> in its working directory as it exits.
_COUNT_READS = """import atexit, os
from porechop_tpu_torch.pipeline import stream
built = []
class Counted(stream.Read):
    def __init__(self, *a):
        built.append(1)
        super().__init__(*a)
stream.Read = Counted
def dump():
    with open('loadstats.rank' + os.environ['PORECHOP_TPU_PROC_ID'],
              'w') as f:
        f.write(str(len(built)))
atexit.register(dump)"""


def test_each_rank_materialises_only_its_block(inputs, tmp_path):
    args = ['-i', str(inputs / 'reads.fastq'), '-o', 'out.fastq', '-v', '0',
            '--check_reads', '6', '--device', 'cpu']
    _, files = _run_ranks(args, tmp_path / 'port', prelude=_COUNT_READS)
    # Rank 0 builds reads 0-19, whose first three are its check reads 0-2,
    # rank 1 reads 20-39 and check reads 3-5: 20 and 23, where one process
    # builds all 40.
    assert files['loadstats.rank0'] == b'20'
    assert files['loadstats.rank1'] == b'23'


def test_two_ranks_without_a_card_raise(inputs, tmp_path):
    """No device named and no card: every rank raises before it joins the
    group; there is no CPU fallback."""
    os.makedirs(tmp_path / 'port')
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'porechop_tpu_torch', '-i',
         str(inputs / 'reads.fastq'), '-o', 'out.fastq', '-v', '0'],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=tmp_path / 'port',
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='',
                 PORECHOP_TPU_COORDINATOR='127.0.0.1:%d' % port,
                 PORECHOP_TPU_NUM_PROCS='2', PORECHOP_TPU_PROC_ID=str(r)))
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=RANK_TIMEOUT)
        assert p.returncode != 0
        assert 'no CUDA device' in err
    assert os.listdir(tmp_path / 'port') == []


def test_fold_matches_brute_force():
    """The detection merge's fold against a brute force over Python
    fractions: per entry the best matches / full_len over all ranks (a
    full_len of 0 counts as 1), with ties giving an equal fraction."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    for world in (1, 2, 3, 5):
        allv = rng.integers(0, 40, (world, 64, 2)).astype(np.int64)
        allv[..., 1] = rng.integers(0, 60, (world, 64))
        allv[:, ::9] = allv[:1, ::9]            # ties across every rank
        m, l = multihost.fold_detection_stats(allv)
        assert m.dtype == l.dtype == np.int64 and (l >= 1).all()
        for e in range(64):
            best = max(Fraction(int(allv[k, e, 0]), max(int(allv[k, e, 1]), 1))
                       for k in range(world))
            assert Fraction(int(m[e]), int(l[e])) == best
