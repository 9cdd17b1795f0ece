"""The PyTorch port's CLI (on the CPU) against the JAX package's on a
natively barcoded input binned with -b, in memory, for the barcode
surfaces: output bins and stdout must be byte-identical.  The runs are at
-v >= 1: the JAX package's -b -v 0 prefilters detection and may zero the
side scores that choose the barcode orientation, a known fault of the
reference that the port does not copy, so -v 1 is the arbiter there."""

import contextlib
import io
import os

import pytest

import porechop_tpu.cli as jax_cli
import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.utils.synth import synth_barcoded, write_fastq

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture(scope='module')
def barcoded_fastq(tmp_path_factory):
    """24 reads of 1.5 kb carrying barcodes 1-4 (one in ten none)."""
    path = tmp_path_factory.mktemp('torch_cli_bc') / 'reads.fastq'
    write_fastq(str(path), synth_barcoded(24, 1500, seed=2,
                                          barcodes=range(1, 5)))
    return path


def _run(main, workdir, args, **kw):
    """Runs a CLI in `workdir`; returns (stdout with the directory as
    <dir>, {bin file: bytes})."""
    old = os.getcwd()
    os.chdir(workdir)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(args, **kw)
        bins = {f: (workdir / 'bins' / f).read_bytes()
                for f in sorted(os.listdir(workdir / 'bins'))}
        return buf.getvalue().replace(str(workdir), '<dir>'), bins
    finally:
        os.chdir(old)


@pytest.mark.parametrize('flags', [
    ['-v', '1'],
    ['-v', '1', '--untrimmed'],
    ['-v', '1', '--discard_unassigned'],
    ['-v', '1', '--require_two_barcodes'],
    ['-v', '1', '--barcode_threshold', '70', '--barcode_diff', '3'],
    ['-v', '2'],
    ['-v', '3'],
], ids=lambda f: ' '.join(f))
def test_barcoded_cli_is_byte_identical(barcoded_fastq, tmp_path, flags):
    os.symlink(barcoded_fastq, tmp_path / 'reads.fastq')
    args = ['-i', '../reads.fastq', '-b', 'bins', '-t', '4'] + flags
    runs = []
    for name, main, kw in (('jax', jax_cli.main, {}),
                           ('torch', torch_cli.main, {'device': 'cpu'})):
        os.makedirs(tmp_path / name)
        runs.append(_run(main, tmp_path / name, args, **kw))
    want, got = runs
    assert len(want[1]) >= 3 and 'Barcode' in want[0]
    assert got[1] == want[1]
    assert got[0] == want[0]
