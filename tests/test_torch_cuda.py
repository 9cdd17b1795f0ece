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

from .test_torch_cases import (H100_WARPS, SCHEME, call_tiled, dp_batch,
                               gap_run_batch, plan_warm, plant, split_batch,
                               tiled_diffs, to_torch)

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
    got = kernels.forward_tiled(*dev, *SCHEME)
    want = kernels.forward_tiled(*cpu, *SCHEME)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)
    bits = got[0].cpu()
    rl, al = batch[1], batch[3]
    for k in range(len(rl)):
        rows, cols = int(al[k]), int(rl[k]) + 1
        assert torch.equal(bits[:rows, k, :cols], want[0][:rows, k, :cols]), k
    assert kernels.LAUNCHES == {'forward_score': 1, 'forward_stats': 1,
                                'forward_tiled': 1}


@pytest.mark.parametrize('A', [24, 48, 100])        # AMAX 32, 64 and 128
@pytest.mark.parametrize('ntiles', [1, 2, 3])
def test_forward_tiled_matches_plain(card, A, ntiles):
    """The column-tiled kernel against its plain version over 1, 2 and 3
    tiles, with lanes whose reads end inside, at and past a tile edge."""
    T = kernels.TILE_T
    L = ntiles * T - 1                               # L + 1 = ntiles tiles
    reads, rl, adps, al = dp_batch(30 + ntiles, 40, L, A)
    for k, edge in enumerate((T - 2, T - 1, T, T + 1, 2 * T - 1, 2 * T,
                              2 * T + 1, 1, L)):
        if edge <= L:
            rl[k] = edge
    al[0] = A
    cpu = to_torch(reads, rl, adps, al)
    dev = [t.to(card) for t in cpu]
    kernels.reset_launches()
    got = kernels.forward_tiled(*dev, *SCHEME)
    want = kernels.forward_tiled(*cpu, *SCHEME)
    assert kernels.LAUNCHES['forward_tiled'] == 1
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)
    bits = got[0].cpu()
    assert bits.shape == want[0].shape == (A, 40, ntiles * T)
    for k in range(len(rl)):
        rows, cols = int(al[k]), int(rl[k]) + 1
        assert torch.equal(bits[:rows, k, :cols], want[0][:rows, k, :cols]), k


@pytest.mark.parametrize('A', [24, 48, 100])        # AMAX 32, 64 and 128
@pytest.mark.parametrize('ntiles', [1, 2, 3])
def test_score_and_stats_match_plain(card, A, ntiles):
    """The wavefront score and stats kernels against their plain versions
    over 1, 2 and 3 of their SCAN_T-column tiles: lanes ending inside, at
    and past a tile edge, four to a block with different lengths (41 lanes:
    the last block holds one), and degenerate lanes (read length 0 and 1,
    adapter length 0 and 1)."""
    S = kernels.SCAN_T
    L = ntiles * S - 1
    reads, rl, adps, al = dp_batch(50 + ntiles, 41, L, A)
    for k, edge in enumerate((S - 2, S - 1, S, S + 1, 2 * S - 1, 2 * S,
                              2 * S + 1, 1, L, 0)):
        if edge <= L:
            rl[k] = edge
    al[0], al[10], al[11] = A, 0, 1
    cpu = to_torch(reads, rl, adps, al)
    dev = [t.to(card) for t in cpu]
    kernels.reset_launches()
    assert torch.equal(kernels.forward_score(*dev, *SCHEME).cpu(),
                       kernels.forward_score(*cpu, *SCHEME))
    for g, w in zip(kernels.forward_stats(*dev, *SCHEME),
                    kernels.forward_stats(*cpu, *SCHEME)):
        assert torch.equal(g.cpu(), w)
    assert kernels.LAUNCHES == {'forward_score': 1, 'forward_stats': 1,
                                'forward_tiled': 0}


@pytest.mark.parametrize('A', [24, 48, 100])        # AMAX 32, 64 and 128
def test_forward_tiled_splits_few_lanes(card, A):
    """Eight lanes of a 40 kb window: the wrapper cuts each into the column
    chunks of split_plan (its shape record says how many), and the result
    equals the plain version.  Lanes end on and beside chunk edges, with
    perfect adapter copies just before and across them."""
    L = 40000
    chunk, warm = kernels.split_plan(8, L, A, SCHEME, kernels.card_warps(A))
    nch = L // chunk + 1
    assert nch > 1 and warm >= kernels.warm_bound(A, SCHEME)
    reads, rl, adps, al = dp_batch(70 + A, 8, L, A)
    rl[:6] = L, L - 1, chunk, chunk - 1, 2 * chunk + 1, 3 * chunk
    al[:4] = A
    plant(reads, adps, al, 0, chunk - 1)
    plant(reads, adps, al, 1, 2 * chunk + A // 2)
    plant(reads, adps, al, 2, chunk - 2)
    reads[3, chunk - 30:chunk + 30] = 4
    cpu = to_torch(reads, rl, adps, al)
    dev = [t.to(card) for t in cpu]
    kernels.reset_launches()
    got = kernels.forward_tiled(*dev, *SCHEME)
    assert kernels.TILED_CALLS == {(8, L, A, nch): 1}
    assert kernels.LAUNCHES['forward_tiled'] == 1
    assert tiled_diffs([g.cpu() for g in got],
                       kernels.forward_tiled(*cpu, *SCHEME), cpu) == []


def test_card_warps_from_the_occupancy_query(card):
    """The trace-bit kernel's resident warps, from the runtime: whole SMs'
    worth, fewer for wider instantiations (more trace bytes a warp), and
    on an H100 the 24, 13 and 6 warps per SM that its 228 KB of shared
    memory per SM allow."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    got = {amax: kernels.card_warps(amax, card.index) for amax in H100_WARPS}
    assert all(n > 0 and n % sms == 0 for n in got.values()), got
    assert got[32] >= got[64] >= got[128], got
    if 'H100' in torch.cuda.get_device_name(card):
        assert got == H100_WARPS


@pytest.mark.parametrize('C', [256, 512])
@pytest.mark.parametrize('A', [24, 48, 100])        # AMAX 32, 64 and 128
def test_forced_chunks_match_plain(card, A, C):
    """The built kernel with chunks of 256 and 512 columns and the plan's
    warm-up (tests/test_torch_csrc_host.py's lanes, on the card, where
    warps run in no order)."""
    cpu = split_batch(A, C)
    dev = [t.to(card) for t in cpu]
    got = call_tiled(kernels._lib('forward_tiled'), dev, SCHEME, C,
                     plan_warm(A, SCHEME),
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert tiled_diffs([g.cpu() for g in got],
                       kernels.forward_tiled_plain(*cpu, *SCHEME), cpu) == []


def test_forward_tiled_raises_past_128_rows_on_the_card(card):
    """A CUDA tensor launches the kernel or raises: no fallback to the
    plain version for adapters the kernel does not take."""
    dev = [t.to(card) for t in to_torch(*dp_batch(3, 4, 300, 129))]
    kernels.reset_launches()
    with pytest.raises(NotImplementedError, match='128'):
        kernels.forward_tiled(*dev, *SCHEME)
    assert kernels.LAUNCHES['forward_tiled'] == 0


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
