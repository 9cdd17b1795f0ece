"""Card tests for the PyTorch port: each CUDA kernel against its plain
PyTorch version on the card (exact: every output is an integer, and the
bits are compared in the region the walker reads), the trace-bit call
with its walk (forward_walk) and the standalone walk enqueued with no host
synchronisation, the CLI on the card against the CPU run, and
bench_torch.py at a small size; on a host with two or more cards, lanes
split over two cards, dryrun_multichip on the cards, every kernel on
cuda:1 and two CLI ranks on two cards.  They skip without a CUDA device
(the multi-card ones with fewer than two); on a machine with one run them
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up jax, which this file does not
use).  """

import collections
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from porechop_tpu_torch import cli
from porechop_tpu_torch.ops import dispatch, engine_v2, kernels
from porechop_tpu_torch.utils.synth import synth_reads, write_fastq

from .test_torch_cases import (H100_WARPS, MODES, SCHEME, align_jobs,
                               call_tiled, call_walk, dp_batch,
                               gap_run_batch, plan_warm, plant, run_mode,
                               split_batch, tiled_diffs, to_torch)

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
    _kernels_match_plain(card, batch)
    assert kernels.LAUNCHES == {'forward_score': 1, 'forward_stats': 1,
                                'forward_tiled': 1, 'forward_walk': 0,
                                'walk': 0}


def _kernels_match_plain(card, batch):
    """Score, stats and the trace-bit forward on `card` against their plain
    versions on the CPU, after kernels.reset_launches()."""
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
    return got, want


@pytest.mark.parametrize('A', [20, 24, 40, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
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


@pytest.mark.parametrize('A', [20, 24, 40, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
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
                                'forward_tiled': 0, 'forward_walk': 0,
                                'walk': 0}


@pytest.mark.parametrize('where', ['below', 'above'])
@pytest.mark.parametrize('A', [20, 24, 40, 48])
def test_score_and_stats_layouts_match_plain(card, A, where):
    """Adapter rungs 24 and 48 in every layout on the card: ragged lanes
    of two SCAN_T tiles (read lengths 0 to L, adapter lengths 0 to A), B
    just below lane_group's threshold (kernels.NARROW_FROM of the card's
    one-lane-a-warp warps of each kernel) or 3 above those warps (a
    multiple of neither 2 nor 4); forward_score and forward_stats
    with one lane a warp, with four (A <= 24) or two lanes a warp, and with
    lane_group's choice, which is the narrow layout above and one lane
    below; each exact against the plain version, computed on the card."""
    narrow = 4 if A <= 24 else 2
    for name in ('forward_score', 'forward_stats'):
        warps = kernels.card_warps(A, card.index, name)
        least = math.ceil(kernels.NARROW_FROM * warps)
        B = least - 1 if where == 'below' else warps + 3
        assert kernels.lane_group(name, B, A, card) == (
            narrow if where == 'above' else 1)
        L = 1100
        reads, rl, adps, al = dp_batch(90 + A, B, L, A)
        rng = np.random.default_rng(A)
        rl[:] = rng.integers(0, L + 1, B)
        rl[:8] = 0, 1, 37, 150, L, 1030, 0, 1
        al[:] = rng.integers(0, A + 1, B)
        dev = [t.to(card) for t in to_torch(reads, rl, adps, al)]
        want = getattr(kernels, name + '_plain')(*dev, *SCHEME)
        kern = getattr(kernels, name)
        kernels.reset_launches()
        for group in (1, narrow, None):
            got = kern(*dev, *SCHEME, group=group)
            if name == 'forward_score':
                assert torch.equal(got, want), group
            else:
                for g, w in zip(got, want):
                    assert torch.equal(g, w), group
        assert kernels.LAUNCHES[name] == 3


@pytest.mark.parametrize('A', [20, 24, 40, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
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
    on an H100 the 24, 13, 9 and 6 warps per SM that its 228 KB of shared
    memory per SM allow."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    got = {amax: kernels.card_warps(amax, card.index) for amax in H100_WARPS}
    assert all(n > 0 and n % sms == 0 for n in got.values()), got
    assert got[32] >= got[64] >= got[96] >= got[128], got
    if 'H100' in torch.cuda.get_device_name(card):
        assert got == H100_WARPS


def test_barcoded_rung96_launch_splits_on_an_h100(card):
    """The barcoded middle's trace-bit launch, 512 lanes x 10,240 x 96 with
    adapters of 65, 80 and 96 bases, through kernels.forward_walk: on an
    H100 (1,188 resident warps at AMAX 96) the plan cuts each lane into two
    chunks, and the result equals forward_walk_plain on the same lanes."""
    B, L, A = 512, 10240, 96
    reads, rl, adps, al = dp_batch(15, B, L, A)
    al[:] = np.resize([65, 80, 96], B)
    for k in range(0, B, 7):
        plant(reads, adps, al, k, 6144 + 40 * (k % 3) - 60)
    dev = [t.to(card) for t in to_torch(reads, rl, adps, al)]
    nch = L // kernels.split_plan(B, L, A, SCHEME,
                                  kernels.card_warps(A, card.index))[0] + 1
    if 'H100' in torch.cuda.get_device_name(card):
        assert nch == 2
    kernels.reset_launches()
    got = kernels.forward_walk(*dev, *SCHEME)
    assert kernels.TILED_CALLS == {(B, L, A, nch): 1}
    assert kernels.LAUNCHES['forward_walk'] == 1
    for g, w in zip(got, kernels.forward_walk_plain(*dev, *SCHEME)):
        assert torch.equal(g, w)


@pytest.mark.parametrize('C', [256, 512])
@pytest.mark.parametrize('A', [24, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
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


def _walk_shards(card, A, chunk):
    """Two shards of split_batch(A, chunk or 256) lanes on the card, their
    bits from the kernel cut into `chunk`-column chunks (None: the
    wrapper's own plan), as kernels.walk takes them, with their CPU
    copies."""
    cpu = split_batch(A, chunk or 256)
    shards = []
    for half in (slice(0, 6), slice(6, None)):
        dev = [t[half].contiguous().to(card) for t in cpu]
        if chunk is None:
            out = kernels.forward_tiled(*dev, *SCHEME)
        else:
            out = call_tiled(kernels._lib('forward_tiled'), dev, SCHEME,
                             chunk, plan_warm(A, SCHEME),
                             torch.cuda.current_stream().cuda_stream)
        shards.append((out[0], *out[2:]))
    torch.cuda.synchronize()
    return shards, [tuple(t.cpu() for t in shard) for shard in shards]


@pytest.mark.parametrize('chunk', [None, 256, 512], ids=['unsplit', '256',
                                                          '512'])
@pytest.mark.parametrize('A', [24, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
def test_walk_matches_plain(card, A, chunk):
    """The walk kernel on two cuda:0 entries' shards against walk_plain on
    the same bits: one launch per shard, exact."""
    shards, cpu = _walk_shards(card, A, chunk)
    kernels.reset_launches()
    got = [kernels.walk(*shard) for shard in shards]
    assert kernels.LAUNCHES['walk'] == 2
    assert kernels.DEVICE_LAUNCHES[('walk', 'cuda:0')] == 2
    for g, shard in zip(got, cpu):
        assert torch.equal(g.cpu(), kernels.walk_plain(*shard))


def test_walk_does_not_synchronise(card, monkeypatch):
    """kernels.walk enqueues one walk per shard and returns: no call that
    waits for the card (torch's sync debug mode raises on one), and the
    plain walker never runs; the harvest then equals walk_plain."""
    shards, cpu = _walk_shards(card, 48, None)
    kernels._lib('walk')                # built before the checked span
    plain = kernels.walk_plain

    def refused(*args):
        raise AssertionError('the plain walker ran on the card')
    monkeypatch.setattr(kernels, 'walk_plain', refused)
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = [kernels.walk(*shard) for shard in shards]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    for g, shard in zip(got, cpu):
        assert torch.equal(g.cpu(), plain(*shard))


def test_walk_raises_for_a_bad_input_on_the_card(card):
    """A CUDA tensor launches the kernel or raises: flags of another type,
    or inputs on two devices, never reach the plain version."""
    shards, _ = _walk_shards(card, 24, None)
    bits, ci, cj, vf, hf = shards[0]
    kernels.reset_launches()
    with pytest.raises(TypeError):
        kernels.walk(bits, ci, cj, vf.int(), hf)
    with pytest.raises(ValueError, match='one device'):
        kernels.walk(bits, ci.cpu(), cj, vf, hf)
    assert kernels.LAUNCHES['walk'] == 0


def _route_batch(route, A):
    """tests/test_torch_csrc_host.py's lanes of one forward_walk route:
    'one tile' (200 bp), 'unsplit' (700 bp) or 'split' (split_batch in
    256-column chunks), with their chunks and warm-up."""
    if route == 'split':
        return split_batch(A, 256), 256, plan_warm(A, SCHEME)
    L = 200 if route == 'one tile' else 700
    reads, rl, adps, al = dp_batch(80 + A, 40, L, A)
    rl[0], al[0] = L, A
    plant(reads, adps, al, 0, L - 7)
    rl[1] = al[1] = 0
    return to_torch(reads, rl, adps, al), None, 0


@pytest.mark.parametrize('route', ['one tile', 'unsplit', 'split'])
@pytest.mark.parametrize('A', [24, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
def test_forward_walk_matches_plain(card, A, route):
    """The built pdp_forward_walk on each route against forward_walk_plain,
    its best, cells and flags against pdp_forward_tiled's on the same
    lanes, bit for bit; a one-tile launch gets no bits buffer at all (a
    null pointer: touching it would fault)."""
    cpu, chunk, warm = _route_batch(route, A)
    dev = [t.to(card) for t in cpu]
    stream = torch.cuda.current_stream().cuda_stream
    got = call_walk(kernels._lib('forward_walk'), dev, SCHEME, chunk, warm,
                    stream, bits=route != 'one tile')
    tiled = call_tiled(kernels._lib('forward_tiled'), dev, SCHEME, chunk,
                       warm, stream)
    torch.cuda.synchronize()
    for name, g, w in zip(('walk', 'best', 'cell_i', 'cell_j'), got,
                          kernels.forward_walk_plain(*cpu, *SCHEME)):
        assert torch.equal(g.cpu(), w), name
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'vflag', 'hflag'),
                          got[1:4] + tuple(f != 0 for f in got[4:6]),
                          tiled[1:]):
        assert torch.equal(g, w), name


def test_forward_walk_wrapper_on_the_card(card):
    """kernels.forward_walk at phase 2's end-window shape (16,384 x 150 x
    32, one tile) and a split shape: one launch counted a call, no
    standalone walk, results equal to the plain version's; the one-tile
    call allocates no trace bits (its peak stays below the 128 MiB they
    would take)."""
    x = [t.to(card) for t in to_torch(*dp_batch(12, 16384, 150, 32))]
    torch.cuda.synchronize()
    kernels.forward_walk(*(t[:8] for t in x), *SCHEME)     # built, warm
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    kernels.reset_launches()
    got = kernels.forward_walk(*x, *SCHEME)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) - base < 16 * 2 ** 20
    L, A = 40000, 48
    chunk, _ = kernels.split_plan(8, L, A, SCHEME, kernels.card_warps(A))
    reads, rl, adps, al = dp_batch(14, 8, L, A)
    rl[0], al[0] = L, A
    plant(reads, adps, al, 0, chunk + A // 2)        # across a chunk edge
    split_cpu = to_torch(reads, rl, adps, al)
    got_split = kernels.forward_walk(*(t.to(card) for t in split_cpu),
                                     *SCHEME)
    assert kernels.LAUNCHES == {'forward_score': 0, 'forward_stats': 0,
                                'forward_tiled': 0, 'forward_walk': 2,
                                'walk': 0}
    assert kernels.TILED_CALLS == {(16384, 150, 32, 1): 1,
                                   (8, L, A, L // chunk + 1): 1}
    assert L // chunk + 1 > 1
    for g, w in zip(got, kernels.forward_walk_plain(*(t.cpu() for t in x),
                                                    *SCHEME)):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got_split, kernels.forward_walk_plain(*split_cpu,
                                                          *SCHEME)):
        assert torch.equal(g.cpu(), w)


def test_gather_forward_does_not_synchronise(card, monkeypatch):
    """engine_v2.gather_forward, the trace-bit path of every planner
    launch (mesh.launch_shards 'res'), on two shards of lane indices
    already on the card: each call enqueues its gather and forward_walk
    and returns, with no call that waits for the card (torch's sync debug
    mode raises on one) and no plain version; the harvest then equals
    forward_walk_plain on each shard's lanes."""
    cpu = to_torch(*dp_batch(13, 64, 700, 48))
    tabs = [t.to(card) for t in cpu]
    idx = [torch.arange(lo, hi, device=card) for lo, hi in ((0, 32),
                                                           (32, 64))]
    kernels._lib('forward_walk')        # built before the checked span
    kernels.card_warps(48, tabs[0].device.index)
    torch.cuda.synchronize()
    want = [kernels.forward_walk_plain(*(t[lo:hi] for t in cpu), *SCHEME)
            for lo, hi in ((0, 32), (32, 64))]

    def refused(*args):
        raise AssertionError('a plain version ran on the card')
    monkeypatch.setattr(kernels, 'forward_walk_plain', refused)
    monkeypatch.setattr(kernels, 'walk_plain', refused)
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode('error')
    try:
        shards = [engine_v2.gather_forward(*tabs, i, i, SCHEME) for i in idx]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert kernels.LAUNCHES['forward_walk'] == 2
    assert kernels.LAUNCHES['walk'] == 0
    for shard, plain in zip(shards, want):
        for g, w in zip(shard, plain):
            assert torch.equal(g.cpu(), w)


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


def test_port_kernels_start_inside_their_enqueue_spans(card, tmp_path,
                                                       monkeypatch):
    """A CLI run on the card under PORECHOP_TPU_TIMING and
    PORECHOP_TPU_PROFILE (after one unprofiled run): the call that
    launched each port kernel lies in one `enqueue` range of the trace,
    and the kernel starts after that range's start.  The profiler's
    kernel times may lead the host's clock: no kernel can start before
    its own launch call, so the largest such lead in the trace is the
    offset between the two clocks, and it is taken out (a few hundred
    microseconds in some sessions on an H100)."""
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(24, 2000, seed=5, chimera_rate=0.3))
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    monkeypatch.chdir(tmp_path)
    argv = ['-i', 'reads.fastq', '-o', 'out.fastq', '-v', '0']
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(argv, device='cuda')
        monkeypatch.setenv('PORECHOP_TPU_PROFILE', str(tmp_path / 'trace'))
        cli.main(argv, device='cuda')
    (name,) = os.listdir(tmp_path / 'trace')
    with open(tmp_path / 'trace' / name) as f:
        events = json.load(f)['traceEvents']
    enqueue = [(e['ts'], e['ts'] + e['dur']) for e in events
               if e.get('cat') == 'user_annotation'
               and e['name'] == 'enqueue']
    calls = collections.defaultdict(list)
    for e in events:
        if e.get('cat') in ('cuda_runtime', 'cuda_driver') and \
                'LaunchKernel' in e['name']:
            calls[e['args']['correlation']].append(e['ts'])
    kernel_events = [e for e in events if e.get('cat') == 'kernel']
    lead = max([0.0] + [t - k['ts'] for k in kernel_events
                        for t in calls[k['args']['correlation']]])
    assert lead < 5000, lead
    port = [k for k in kernel_events if any(
        n in k['name'] for n in ('dp_wave_kernel', 'bits_fold_kernel',
                                 'dp_walk_kernel'))]
    assert port and enqueue
    for k in port:
        (t,) = calls[k['args']['correlation']]
        (start,) = [s for s, e in enqueue if s <= t <= e]
        assert k['ts'] + lead >= start, (k['name'], k['ts'], lead, start)


def test_bench_on_the_card(card):
    """bench_torch.py at 512 x 10 kb, one run a side: the card's and the
    forced host's outputs agree, every phase is timed and the card held
    memory."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, 'bench_torch.py', '--runs', '1',
                        '--reads', '512'], cwd=root, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line['correct'] is True and line['device'] == 'card'
    assert line['value'] > 0 and line['baseline_value'] > 0
    assert list(line['phases_s']) == ['load', 'detect', 'endtrim', 'middle',
                                      'output']
    assert line['peak_device_mib'] > 0


def _entries_equal_one_entry(entries):
    """Every AlignJobs mode on the device entries equals the one-entry run
    on the card, and each launch of the one-entry run becomes one launch
    per entry (every launch pads to at least 32 lanes).  Returns the
    launches by (kernel, device)."""
    jobs = align_jobs(6)
    n = len(entries.split(','))
    by_device = collections.Counter()
    for mode in MODES:
        kernels.reset_launches()
        want = run_mode(mode, jobs, 'cuda:0')
        one = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        got = run_mode(mode, jobs, entries)
        torch.cuda.synchronize()
        for f in want:
            assert np.array_equal(got[f], want[f], equal_nan=True), (mode, f)
        assert sum(one.values()) > 0, mode
        assert kernels.LAUNCHES == {k: n * v for k, v in one.items()}, mode
        by_device.update(kernels.DEVICE_LAUNCHES)
    return by_device


def test_two_entries_on_one_card_equal_one_entry(card):
    by_device = _entries_equal_one_entry('cuda:0,cuda:0')
    assert {d for _, d in by_device} == {'cuda:0'}


def test_two_cards_equal_one_card(cards):
    """Each card launches its share: the same launches on both."""
    by_device = _entries_equal_one_entry('cuda:0,cuda:1')
    assert {d for _, d in by_device} == {'cuda:0', 'cuda:1'}
    for k in kernels.LAUNCHES:
        assert by_device[(k, 'cuda:0')] == by_device[(k, 'cuda:1')], k


@pytest.fixture
def cards(card):
    """The number of cards, when there are two or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two NVIDIA GPUs')
    return torch.cuda.device_count()


def test_dryrun_multichip_on_the_cards(cards):
    """dryrun_multichip with no device runs on the host's cards (it checks
    its own results), each card launching every kernel of the path."""
    from porechop_tpu_torch import entry
    kernels.reset_launches()
    entry.dryrun_multichip(cards)
    for k in ('forward_score', 'forward_stats', 'forward_walk'):
        for c in range(cards):
            assert kernels.DEVICE_LAUNCHES[(k, 'cuda:%d' % c)] > 0, (k, c)


@pytest.mark.parametrize('seed,B,L,A', [(6, 128, 150, 24), (7, 32, 700, 32),
                                        (8, 64, 150, 48), (9, 33, 300, 100)])
def test_kernels_on_a_second_card_match_plain(cards, seed, B, L, A):
    """Every kernel launched on cuda:1, and only there, against its plain
    version: score, stats, the trace-bit forward, the standalone walk on
    its bits and the forward with its walk (one tile at L = 150)."""
    card = torch.device('cuda', 1)
    batch = dp_batch(seed, B, L, A)
    got, want = _kernels_match_plain(card, batch)
    walked = kernels.walk(*got[:1], *got[2:6])
    assert torch.equal(walked.cpu(), kernels.walk_plain(*want[:1],
                                                        *want[2:6]))
    cpu = to_torch(*batch)
    for g, w in zip(kernels.forward_walk(*(t.to(card) for t in cpu),
                                         *SCHEME),
                    kernels.forward_walk_plain(*cpu, *SCHEME)):
        assert torch.equal(g.cpu(), w)
    assert {d for (_, d), n in kernels.DEVICE_LAUNCHES.items() if n} \
        == {'cuda:1'}
    assert all(kernels.LAUNCHES.values()), kernels.LAUNCHES


# A rank of the CLI: the card multihost.rank_device() gave it and the cards
# it launched on, as JSON on stderr.
RANK_CODE = """\
import json, sys
from porechop_tpu_torch import cli
from porechop_tpu_torch.ops import kernels
from porechop_tpu_torch.parallel import multihost
given = []
rank_device = multihost.rank_device
def recording():
    given.append(str(rank_device()))
    return rank_device()
multihost.rank_device = recording
cli.main(sys.argv[1:])
print(json.dumps({'rank_device': given, 'cards': sorted(
    {d for (_, d), n in kernels.DEVICE_LAUNCHES.items() if n})}),
      file=sys.stderr)
"""


def test_two_ranks_run_on_two_cards(cards, tmp_path):
    """Two gloo ranks of the CLI with no --device: rank r takes cuda:r
    (multihost.rank_device) and launches there alone, and the merged
    output and rank 0's transcript are those of one process on cuda:0."""
    import socket
    write_fastq(str(tmp_path / 'reads.fastq'),
                synth_reads(24, 2000, seed=5, chimera_rate=0.3))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ['-i', 'reads.fastq', '-o', 'ranks.fastq', '-v', '1']
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, '-c', RANK_CODE] + args, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=root,
                 PORECHOP_TPU_COORDINATOR='127.0.0.1:%d' % port,
                 PORECHOP_TPU_NUM_PROCS='2', PORECHOP_TPU_PROC_ID=str(r)))
        for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    ranks = [json.loads(err.decode().splitlines()[-1]) for _, err in outs]
    assert ranks == [{'rank_device': ['cuda:%d' % r], 'cards': ['cuda:%d' % r]}
                     for r in range(2)]
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(['-i', 'reads.fastq', '-o', 'one.fastq', '-v', '1'],
                     device='cuda:0')
    finally:
        os.chdir(old)
    assert (tmp_path / 'ranks.fastq').read_bytes() \
        == (tmp_path / 'one.fastq').read_bytes()
    assert outs[0][0].decode().replace('ranks.fastq', '') \
        == buf.getvalue().replace('one.fastq', '')
    assert outs[1][0] == b''


@pytest.mark.parametrize('scheme', [(3, -6, -2, -5), (2, -3, -3, -3)])
def test_refused_scheme_launches_nothing_on_the_card(card, scheme):
    """Schemes the kernels refuse run on the host whatever the device:
    the same results as on the CPU, and no kernel launch."""
    windows, adapters, pairs, _, _ = align_jobs(3)
    pairs = pairs[:40]                  # the linear route is Python
    kernels.reset_launches()
    got = dispatch.AlignJobs(windows, adapters, pairs, scheme,
                             device='cuda').run()
    assert sum(kernels.LAUNCHES.values()) == 0
    want = dispatch.AlignJobs(windows, adapters, pairs, scheme,
                              device='cpu').run()
    for f in want:
        assert np.array_equal(got[f], want[f], equal_nan=True), f
