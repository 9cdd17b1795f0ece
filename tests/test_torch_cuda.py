"""Card tests for the PyTorch port: each CUDA kernel against its plain
PyTorch version on the card (exact: every output is an integer, and the
bits are compared in the region the walker reads), and the CLI on the card
against the CPU run.  They skip without a CUDA device; on a machine with
one run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up jax, which this file does not
use).  """

import contextlib
import io
import os

import pytest
import torch

from porechop_tpu_torch import cli
from porechop_tpu_torch.ops import kernels
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import SCHEME, dp_batch, gap_run_batch, to_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.parametrize('seed,B,L,A', [(5, 32, 60, 12), (6, 128, 150, 24),
                                        (7, 32, 700, 32), (8, 64, 150, 48),
                                        (9, 33, 300, 100), (0, 128, 120, 24)])
def test_kernels_match_plain(card, seed, B, L, A):
    batch = gap_run_batch() if seed == 0 else dp_batch(seed, B, L, A)
    cpu = to_torch(*batch)
    dev = [t.to(card) for t in cpu]
    kernels.reset_launches()

    assert torch.equal(kernels.forward_score(*dev, *SCHEME).cpu(),
                       kernels.forward_score(*cpu, *SCHEME))
    for g, w in zip(kernels.forward_stats(*dev, *SCHEME),
                    kernels.forward_stats(*cpu, *SCHEME)):
        assert torch.equal(g.cpu(), w)
    got = kernels.forward_bitmap(*dev, *SCHEME)
    want = kernels.forward_bitmap(*cpu, *SCHEME)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)
    bits = got[0].cpu()
    rl, al = batch[1], batch[3]
    for k in range(len(rl)):
        rows, cols = int(al[k]), int(rl[k]) + 1
        assert torch.equal(bits[:rows, k, :cols], want[0][:rows, k, :cols]), k
    assert kernels.LAUNCHES == {'forward_score': 1, 'forward_stats': 1,
                                'forward_bitmap': 1}


def test_cli_on_card_matches_cpu(card, tmp_path):
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(24, 2000, seed=5, chimera_rate=0.3))
    outs = []
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for device in ('cpu', 'cuda'):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(['-i', 'reads.fastq', '-o', device + '.fastq',
                          '-v', '1'], device=device)
            with open(device + '.fastq', 'rb') as f:
                outs.append((buf.getvalue().replace(device + '.fastq', ''),
                             f.read()))
    finally:
        os.chdir(old)
    assert outs[0] == outs[1]
