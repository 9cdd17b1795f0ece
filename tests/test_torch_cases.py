"""Inputs shared by the PyTorch port's tests (tests/test_torch_*.py): DP
batches made from numpy seeds, in the layout both packages take.  Free of
jax, so the card tests (tests/test_torch_cuda.py) can use it on a machine
without it."""

import numpy as np
import pytest
import torch

from porechop_tpu_torch.ops import kernels

SCHEME = (3, -6, -5, -2)
# Warps of the trace-bit kernel an H100 SXM holds at once, by AMAX: 132 SMs
# x 24, 13 and 6 one-warp blocks, bounded by the trace-byte buffer
# (kernels.card_warps on the card; chip_smoke.py prints it).
H100_WARPS = {32: 132 * 24, 64: 132 * 13, 128: 132 * 6}


@pytest.fixture(scope='module')
def one_torch_thread():
    """Run a module's torch CPU work on one intra-op thread.  The suite
    runs in several worker processes at once; with more OpenMP threads
    than free cores, the plain versions' many small ops spend their time
    in spinning barriers (a CLI run measured 117 s instead of 7 s beside
    six busy processes on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.usefixtures('one_torch_thread')
FIELDS = ('read_start', 'read_end', 'adapter_start', 'adapter_end',
          'raw_score', 'matches', 'aligned_len', 'full_len')


def dp_batch(seed, B, L, A):
    """(reads (B, L) int8, read_lens (B,) int32, adapters (B, A) int8,
    adapter_lens (B,) int32): random lanes, every 4th lane low-entropy
    (two symbols, forcing score ties), every 3rd with its adapter embedded
    in the read (realistic hits)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    rl = rng.integers(1, L + 1, B).astype(np.int32)
    adps = rng.integers(0, 5, (B, A)).astype(np.int8)
    al = rng.integers(1, A + 1, B).astype(np.int32)
    for k in range(0, B, 4):
        reads[k] = rng.integers(0, 2, L)
        adps[k] = rng.integers(0, 2, A)
    for k in range(1, B, 3):
        a = adps[k, :al[k]]
        if rl[k] > al[k]:
            pos = int(rng.integers(0, rl[k] - al[k]))
            reads[k, pos:pos + al[k]] = a
    return reads, rl, adps, al


def gap_run_batch(A=24, B=128):
    """Reads built as adapter-prefix + g junk bases + adapter-suffix, which
    force a best path with a horizontal run of ~g columns, g swept through
    and past the JAX kernels' H window (tests/test_kernel_pallas.py
    test_gap_run_window_bound_adversarial); each with a low-entropy
    twin."""
    gaps = [1, 5, 16, 30, 38, 40, 42, 64, 120]
    rng = np.random.default_rng(99)
    lanes = []
    for g in gaps:
        adapter = rng.integers(0, 4, A).astype(np.int8)
        cut = A // 2
        junk = rng.integers(0, 4, g).astype(np.int8)
        lanes.append((np.concatenate([adapter[:cut], junk, adapter[cut:]]),
                      adapter))
        lanes.append((np.concatenate([adapter[:cut], junk % 2,
                                      adapter[cut:]]), adapter))
    L = max(len(r) for r, _ in lanes)
    reads = np.full((B, L), 4, np.int8)
    rl = np.ones(B, np.int32)
    adps = np.full((B, A), 4, np.int8)
    al = np.full(B, A, np.int32)
    for k, (r, a) in enumerate(lanes):
        reads[k, :len(r)] = r
        rl[k] = len(r)
        adps[k] = a
    return reads, rl, adps, al


def to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def decode(codes):
    return ''.join('ACGTN'[c] for c in codes)


def plan_warm(A, scheme):
    """The warm-up split_plan passes: the proven bound rounded up to
    TILE_T."""
    T = kernels.TILE_T
    return -(-kernels.warm_bound(A, scheme) // T) * T


def plant(reads, adps, al, k, last_col):
    """Lane k's adapter, copied perfectly into the columns ending at
    last_col (column j holds read[j - 1])."""
    n = int(al[k])
    reads[k, last_col - n:last_col] = adps[k, :n]


def split_batch(A, C):
    """Lanes around the chunk edges of C columns: read lengths ending in the
    first chunk, on a chunk's first column, inside a later chunk's warm-up
    and just before a chunk starts (0 and 1 too); perfect adapter copies
    ending just before a chunk edge and straddling one, the same copy on
    both sides of an edge (a tie the leftmost column must win), and N runs
    straddling every edge."""
    L = 1300
    lens = [L, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1, 3 * C - 1, 0,
            1, 700, L]
    reads, rl, adps, al = dp_batch(60 + A + C, len(lens), L, A)
    rl[:] = [min(x, L) for x in lens]
    al[0], al[4], al[10], al[11] = A, A // 2, A, A
    plant(reads, adps, al, 0, 2 * C - 1)
    plant(reads, adps, al, 3, C + 1)
    plant(reads, adps, al, 4, C - 1)
    plant(reads, adps, al, 4, 2 * C - 1)
    plant(reads, adps, al, 10, C - 1)
    plant(reads, adps, al, 11, C + A // 2)
    for c in range(C, L, C):
        reads[7, c - 20:c + 20] = 4
        reads[11, c + A:c + A + 10] = 4
    return to_torch(reads, rl, adps, al)


def call_tiled(fn, batch, scheme, chunk=None, warm=0, stream=None):
    """A built pdp_forward_tiled (kernels.bind) on the batch's device, in
    the wrapper's output form, with each lane cut into chunks of `chunk`
    columns after `warm` columns of warm-up (one chunk by default).  The
    bits start as junk, so a byte of the walker's region that no chunk
    writes shows."""
    reads, rl, adps, al = batch
    B, L = reads.shape
    A = adps.shape[1]
    L1p = kernels.tiled_l1p(L)
    chunk = chunk or L1p
    nch = L // chunk + 1
    dev = dict(device=reads.device)
    bits = torch.full((A, B, L1p), 0xa5, dtype=torch.uint8, **dev)
    cells = [torch.empty(B, dtype=torch.int32, **dev) for _ in range(3)]
    flags = [torch.empty(B, dtype=torch.uint8, **dev) for _ in range(2)]
    part = (torch.empty((nch, B, kernels.PART_INTS), dtype=torch.int32,
                        **dev) if nch > 1 else None)
    rc = fn(*(x.data_ptr() for x in batch), B, L, A, L1p, *scheme, chunk,
            warm, *(x.data_ptr() for x in (bits, *cells, *flags)),
            None if part is None else part.data_ptr(), stream)
    assert rc == 0, rc
    return bits, *cells, flags[0] != 0, flags[1] != 0


def tiled_diffs(got, want, batch):
    """Names of the trace-bit outputs that differ, the bits compared in the
    walker's region (rows < adapter_len, columns <= read_len) lane by
    lane."""
    diffs = [name for name, g, w in zip(('best', 'cell_i', 'cell_j',
                                          'vflag', 'hflag'), got[1:],
                                         want[1:]) if not torch.equal(g, w)]
    rl, al = batch[1], batch[3]
    for k in range(len(rl)):
        rows, cols = int(al[k]), int(rl[k]) + 1
        if not torch.equal(got[0][:rows, k, :cols], want[0][:rows, k, :cols]):
            diffs.append('bits of lane %d' % k)
    return diffs


@pytest.mark.parametrize('seed,B,L,A', [(5, 32, 60, 12), (7, 32, 700, 32)])
def test_dp_batch_exercises_ties_and_hits(seed, B, L, A):
    """The batches hold what the parity tests rely on: lengths in range,
    two-symbol lanes (score ties) and lanes carrying their adapter."""
    reads, rl, adps, al = dp_batch(seed, B, L, A)
    assert reads.shape == (B, L) and adps.shape == (B, A)
    assert (1 <= rl).all() and (rl <= L).all()
    assert (1 <= al).all() and (al <= A).all()
    assert (reads[::4] < 2).all() and (adps[::4] < 2).all()
    hits = [k for k in range(1, B, 3) if rl[k] > al[k]]
    assert hits
    for k in hits:
        a = adps[k, :al[k]].tobytes()
        assert a in reads[k].tobytes()


def test_gap_run_batch_spans_the_window():
    reads, rl, adps, al = gap_run_batch()
    assert rl[:18].min() == 24 + 1 and rl[:18].max() == 24 + 120
    assert (rl[18:] == 1).all()
