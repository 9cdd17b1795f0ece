"""The PyTorch port's CLI (porechop_tpu_torch.cli.main, on the CPU) against
the JAX package's (porechop_tpu.cli.main) on one synthetic FASTQ: output
files and stdout must be byte-identical."""

import contextlib
import io
import os

import pytest

import porechop_tpu.cli as jax_cli
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture(scope='module')
def reads_fastq(tmp_path_factory):
    """48 synthetic 2 kb reads, three in ten chimeric (middle adapters),
    as reads.fastq and the same records as reads.fasta beside it."""
    d = tmp_path_factory.mktemp('torch_cli')
    path = str(d / 'reads.fastq')
    reads = synth_reads(48, 2000, seed=3, chimera_rate=0.3)
    write_fastq(path, reads)
    with open(d / 'reads.fasta', 'w') as f:
        f.writelines('>%s\n%s\n' % (name, seq) for name, seq, _ in reads)
    return path


def _run(main, workdir, args, **kw):
    """Runs a CLI in `workdir` with relative paths (the -v 1 transcript
    prints the output's absolute path); returns (stdout, output bytes)."""
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


@pytest.mark.parametrize('flags,out_name', [
    (['-v', '0'], 'out.fastq'),
    (['-v', '1'], 'out.fastq'),
    (['-v', '1', '--discard_middle'], 'out.fastq'),
    (['-v', '1', '--middle_threshold', '85'], 'out.fasta'),
    (['-v', '1', '--no_split'], 'out.fastq'),
    (['-v', '1', '--check_reads', '12'], 'out.fastq'),
    (['-v', '1', '--end_size', '100'], 'out.fastq'),
    (['-v', '1', '-i', '../reads.fasta'], 'out.fasta'),
])
def test_cli_output_is_byte_identical(reads_fastq, tmp_path, flags,
                                      out_name):
    os.makedirs(tmp_path / 'jax')
    os.makedirs(tmp_path / 'torch')
    os.symlink(reads_fastq, tmp_path / 'reads.fastq')
    os.symlink(os.path.splitext(reads_fastq)[0] + '.fasta',
               tmp_path / 'reads.fasta')
    # A later -i names the input (argparse keeps the last one).
    args = ['-i', '../reads.fastq', '-o', out_name, '-t', '4'] + flags
    want = _run(jax_cli.main, tmp_path / 'jax', args)
    got = _run(torch_cli.main, tmp_path / 'torch', args, device='cpu')
    if flags[1] == '1' and '--no_split' not in flags:
        assert 'Splitting' in want[0] or 'Discarding' in want[0]
    assert got[1] == want[1]
    assert got[0].replace(str(tmp_path / 'torch'), '<dir>') == \
        want[0].replace(str(tmp_path / 'jax'), '<dir>')


def test_help_is_byte_identical(capsys):
    """The hidden --device flag keeps --help as the reference prints it."""
    texts = []
    for main in (jax_cli.main, torch_cli.main):
        with pytest.raises(SystemExit):
            main(['--help'])
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and 'Porechop' in texts[0]


def test_device_flag_selects_the_cpu(reads_fastq, tmp_path):
    """`--device cpu` runs the same path as main(device='cpu')."""
    os.symlink(reads_fastq, tmp_path / 'reads.fastq')
    a = _run(torch_cli.main, tmp_path,
             ['-i', 'reads.fastq', '-o', 'a.fastq', '-v', '0',
              '--device', 'cpu'])
    b = _run(torch_cli.main, tmp_path,
             ['-i', 'reads.fastq', '-o', 'b.fastq', '-v', '0'],
             device='cpu')
    assert a == b
