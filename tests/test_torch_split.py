"""The column split of the trace-bit forward (ops/kernels.py split_plan,
csrc/dp_tiled.cu): the plan function, and the warm-up bound it rests on,
checked by a brute-force Gotoh DP in numpy, independent of the port's code.

The bound: a sweep started at column w0 from the lower-bound boundary (rows
>= 1 at M = V = H = NEG, row 0 at M = 0) holds the exact M, V and H of every
cell from column w0 + D - 1 on, D = kernels.warm_bound(A, scheme).
Tolerance: exact (integers).
"""

import numpy as np
import pytest

from porechop_tpu_torch.ops import kernels

from .test_torch_cases import H100_WARPS, SCHEME, dp_batch

NEG = -(1 << 30)
SCHEMES = [SCHEME, (20, -30, -5, -2), (1, -1, -2, -1), (5, -4, -8, -6)]
T = kernels.TILE_T


def _warps(A):
    """An H100's warps of the instantiation that serves A."""
    return H100_WARPS[32 if A <= 32 else 64 if A <= 64 else 128]


def _gotoh(reads, rl, adps, al, scheme, w0=0):
    """(M, V, H), each (B, A + 1, L + 1) int64, of the semi-global Gotoh DP
    with free end gaps (M(i, 0) = 0, M(0, j) = 0), textbook recurrences,
    swept from column w0: from the true column 0 when w0 = 0, else from the
    lower bound at column w0 - 1.  Lanes past their lengths hold junk; rows
    are compared only up to the adapter's length, columns up to the read's.
    """
    match, mismatch, go, ge = scheme
    B, L = reads.shape
    A = adps.shape[1]
    shape = (B, A + 1, L + 1)
    M = np.full(shape, NEG, np.int64)
    V = np.full(shape, NEG, np.int64)
    H = np.full(shape, NEG, np.int64)
    M[:, 0, :] = 0
    if w0 == 0:
        M[:, :, 0] = 0
    for j in range(max(w0, 1), L + 1):
        rc = reads[:, j - 1]
        for i in range(1, A + 1):
            V[:, i, j] = np.maximum(V[:, i - 1, j] + ge, M[:, i - 1, j] + go)
            H[:, i, j] = np.maximum(H[:, i, j - 1] + ge, M[:, i, j - 1] + go)
            sub = np.where(rc == adps[:, i - 1], match, mismatch)
            M[:, i, j] = np.maximum.reduce([M[:, i - 1, j - 1] + sub,
                                            V[:, i, j], H[:, i, j]])
    return M, V, H


def _planted_lanes(seed, A, L, w0):
    """dp_batch lanes at full read length, with perfect adapter copies and
    N runs just before and across column w0."""
    reads, rl, adps, al = dp_batch(seed, 6, L, A)
    rl[:] = L
    al[:3] = A
    for k, end in ((0, w0 - 1), (1, w0 + A // 2), (2, w0 - 2)):
        reads[k, end - A:end] = adps[k, :A]
    reads[3, w0 - 10:w0 + 10] = 4
    return reads, rl, adps, al


def _exact_from(scheme, A, w0, D, seed):
    """Whether the sweep cold-started at w0 equals the true DP on every
    lane's rows <= adapter_len and columns w0 + D - 1 .. read_len."""
    L = w0 + D + 40
    batch = _planted_lanes(seed, A, L, w0)
    true = _gotoh(*batch, scheme)
    cold = _gotoh(*batch, scheme, w0=w0)
    rl, al = batch[1], batch[3]
    for t, c in zip(true, cold):
        for k in range(len(rl)):
            a, r = int(al[k]), int(rl[k])
            if not np.array_equal(t[k, 1:a + 1, w0 + D - 1:r + 1],
                                  c[k, 1:a + 1, w0 + D - 1:r + 1]):
                return False
    return True


@pytest.mark.parametrize('scheme', SCHEMES,
                         ids=['3,-6,-5,-2', '20,-30,-5,-2', '1,-1,-2,-1',
                              '5,-4,-8,-6'])
@pytest.mark.parametrize('A', [5, 12, 24])
def test_warm_bound_gives_exact_values(scheme, A):
    """The proven D holds under four schemes at several chunk starts."""
    D = kernels.warm_bound(A, scheme)
    for n, w0 in enumerate((A + 3, 2 * A + 17, 150)):
        assert _exact_from(scheme, A, w0, D, seed=n + A), w0


def test_short_warm_up_is_wrong():
    """The bound is needed: after a perfect adapter copy ending just before
    the start, 4, 8 and 16 columns of warm-up give wrong values."""
    for D in (4, 8, 16):
        assert not _exact_from(SCHEME, 24, 60, D, seed=3), D


def test_warm_bound_values():
    """D = A + 2 + ceil(A (s_hi - s_lo) / |gap_ext|): the default scheme's
    D for A = 32, 64, 128 takes 1, 2 and 3 tiles; gap_ext >= 0 has none."""
    assert [kernels.warm_bound(A, SCHEME) for A in (32, 64, 128)] == [
        178, 354, 706]
    assert kernels.warm_bound(32, (3, -6, -5, 0)) is None
    assert kernels.warm_bound(32, (3, -6, -5, 1)) is None


@pytest.mark.parametrize('B,L,A,scheme', [
    (16384, 150, 32, SCHEME), (2048, 16384, 32, SCHEME),
    (1024, 10240, 64, SCHEME), (1024, 24576, 64, SCHEME), (8, 300, 32, SCHEME),
    (64, 1000, 128, SCHEME), (8, 262144, 32, (3, -6, -5, 0))])
def test_plan_keeps_one_chunk(B, L, A, scheme):
    """One chunk (today's launch) when B fills the card, the window is too
    short to pay the warm-up, or gap_ext >= 0 gives no bound."""
    assert kernels.split_plan(B, L, A, scheme, _warps(A)) == (
        kernels.tiled_l1p(L), 0)


@pytest.mark.parametrize('scheme', SCHEMES[:2], ids=['default', '20,-30'])
@pytest.mark.parametrize('B,L,A', [(128, 262144, 32), (64, 262144, 32),
                                   (256, 131072, 32), (32, 131072, 128),
                                   (1024, 10240, 32), (8, 40000, 48),
                                   (1, 65536, 100), (32, 262144, 32),
                                   (32, 131072, 32), (128, 131072, 32)])
def test_plan_splits_few_lanes(B, L, A, scheme):
    """Few long lanes split: the warm-up at least D and a TILE_T multiple,
    chunks TILE_T multiples of at least MIN_CHUNK_WARMS warm-ups, and no
    more warps than the card holds."""
    chunk, warm = kernels.split_plan(B, L, A, scheme, _warps(A))
    nch = L // chunk + 1
    assert nch > 1
    assert warm >= kernels.warm_bound(A, scheme) and warm % T == 0
    assert chunk % T == 0 and chunk >= kernels.MIN_CHUNK_WARMS * warm
    assert B * nch <= _warps(A)


def test_plan_fills_the_card_at_the_long_replay_shape():
    """128 x 262,144 x 32 (a replay round of 200 kb reads): 24 chunks of
    11,008 columns, 3,072 warps for the 3,168 an H100 holds."""
    assert kernels.split_plan(128, 262144, 32, SCHEME, 3168) == (11008, 256)


@pytest.mark.parametrize('B,L,chunks', [(32, 262144, (2816, 5376)),
                                        (32, 131072, (2048, 2816)),
                                        (128, 131072, (5632, 11008))])
def test_plan_follows_the_card_warps(B, L, chunks):
    """The long-read run's split launches (A = 32): on a card holding half
    an H100's warps the chunks grow to fill it in one wave, and where the
    card's share per lane would cut chunks shorter than MIN_CHUNK_WARMS
    warm-ups (32 lanes at 131,072), the least chunk holds."""
    for warps, chunk in zip((3168, 1584), chunks):
        assert kernels.split_plan(B, L, 32, SCHEME, warps) == (chunk, 256)
        assert B * (L // chunk + 1) <= warps
