"""Inputs shared by the PyTorch port's tests (tests/test_torch_*.py): DP
batches made from numpy seeds, in the layout both packages take.  Free of
jax, so the card tests (tests/test_torch_cuda.py) can use it on a machine
without it."""

import numpy as np
import pytest
import torch

SCHEME = (3, -6, -5, -2)


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
