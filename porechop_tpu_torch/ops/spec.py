"""The pieces of the reference aligner's specification that the pipeline
uses: Dna5 encoding, the percent-identity round trip, the DP's
minus-infinity, the executable specification of linear schemes
(gap_open == gap_ext), which is how they are aligned (align_linear), and
that of Gotoh schemes (align_affine), which the dry run checks against.

The full executable specification (both host aligners and the derivation of
SeqAn's tie rules) lives with the JAX package in porechop_tpu/ops/spec.py;
this package keeps its own copy of only what it runs.
"""

from __future__ import annotations

import numpy as np

# MinValue<int>/2 (SeqAn dp_cell.h:117-124): the DP's minus-infinity.
NEG = -(2 ** 30)

# Dna5 encoding: everything that is not ACGTU (including '-') is N; SeqAn's
# char->Dna5 translation maps 'U'/'u' to T.
_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate('ACGT'):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
_CODE[ord('U')] = _CODE[ord('u')] = 3


def encode(seq: str) -> np.ndarray:
    """Encode a sequence string to Dna5 codes A,C,G,T,N -> 0..4."""
    return _CODE[np.frombuffer(seq.encode('ascii'), dtype=np.uint8)]


def encode_many(seqs) -> list:
    """Bulk twin of encode: one join + one table lookup for a whole list.
    Returns a list of per-sequence views into one freshly-allocated code
    array; the views are writable and disjoint, so callers (the middle
    phase masks hits in place) may mutate them safely."""
    if not seqs:
        return []
    codes = _CODE[np.frombuffer(''.join(seqs).encode('ascii'),
                                dtype=np.uint8)]
    ends = np.cumsum([len(s) for s in seqs]).tolist()
    return [codes[a:b] for a, b in zip([0] + ends[:-1], ends)]


def seqan_pct(matches: int, length: int) -> float:
    """Percent identity with the reference's round trip through
    C++ std::to_string (6 decimals) and Python float()."""
    if length <= 0:
        return float('nan')
    return float('%.6f' % (100.0 * matches / length))


# ---------------------------------------------------------------------------
# The linear route (porechop_tpu/ops/spec.py:137-433): schemes with
# gap_open == gap_ext, which SeqAn aligns under its LinearGaps profile and
# neither the kernels nor the native Gotoh engine take.
# ---------------------------------------------------------------------------

# Trace bit flags (values arbitrary; semantics mirror SeqAn's TraceBitMap_).
H_EXT, H_OPEN, V_EXT, V_OPEN, DIAG, MAX_V, MAX_H = 1, 2, 4, 8, 16, 32, 64


class AlignResult:
    """The 7-tuple of src/alignment.cpp plus the integer stats behind it."""

    __slots__ = ('read_start', 'read_end', 'adapter_start', 'adapter_end',
                 'raw_score', 'matches', 'aligned_len', 'full_len')

    def __init__(self, read_start, read_end, adapter_start, adapter_end,
                 raw_score, matches, aligned_len, full_len):
        self.read_start = int(read_start)
        self.read_end = int(read_end)
        self.adapter_start = int(adapter_start)
        self.adapter_end = int(adapter_end)
        self.raw_score = int(raw_score)
        self.matches = int(matches)
        self.aligned_len = int(aligned_len)
        self.full_len = int(full_len)


def align_linear(window, adapter, scoring) -> AlignResult:
    """One job of the linear route: window and adapter as Dna5 codes,
    scoring (match, mismatch, gap, gap).  Empty inputs give SeqAn's
    failure (read_start -1)."""
    match, mismatch, gap_open, gap_ext = (int(x) for x in scoring)
    if gap_open != gap_ext:
        raise ValueError('scoring scheme %s is not linear' % (tuple(scoring),))
    r = np.asarray(window, dtype=np.int64)
    a = np.asarray(adapter, dtype=np.int64)
    if len(r) == 0 or len(a) == 0:
        return AlignResult(-1, -1, -1, -1, 0, 0, 0, 0)
    return _align_traceback_linear(r, a, match, mismatch, gap_open)


def align_affine(window, adapter, scoring=(3, -6, -5, -2)) -> AlignResult:
    """One job under a Gotoh scheme (gap_open != gap_ext) by the full
    trace-bit matrix and SeqAn's walk, step for step: the executable
    specification (porechop_tpu/ops/spec.py align_traceback), O(Lr La) in
    Python, which the dry run (entry.py) holds one lane against.  Inputs
    as align_linear's."""
    match, mismatch, open_, ext = (int(x) for x in scoring)
    if open_ == ext:
        raise ValueError('scoring scheme %s is linear' % (tuple(scoring),))
    r = np.asarray(window, dtype=np.int64)
    a = np.asarray(adapter, dtype=np.int64)
    lr, la = len(r), len(a)
    if lr == 0 or la == 0:
        return AlignResult(-1, -1, -1, -1, 0, 0, 0, 0)
    m = np.zeros((la + 1, lr + 1), dtype=np.int64)
    v = np.full((la + 1, lr + 1), NEG, dtype=np.int64)
    h = np.full((la + 1, lr + 1), NEG, dtype=np.int64)
    bits = np.zeros((la + 1, lr + 1), dtype=np.uint8)
    for i in range(1, la + 1):
        sub = np.where(r == a[i - 1], match, mismatch)
        for j in range(1, lr + 1):
            h_ext, h_open = h[i, j - 1] + ext, m[i, j - 1] + open_
            hval, hbit = (h_ext, H_EXT) if h_ext >= h_open else (h_open,
                                                                  H_OPEN)
            v_ext, v_open = v[i - 1, j] + ext, m[i - 1, j] + open_
            vval, vbit = (v_ext, V_EXT) if v_ext >= v_open else (v_open,
                                                                  V_OPEN)
            gap, mbit = (vval, MAX_V) if vval >= hval else (hval, MAX_H)
            diag = m[i - 1, j - 1] + sub[j - 1]
            if diag >= gap:
                m[i, j], bits[i, j] = diag, DIAG | hbit | vbit
            else:
                m[i, j], bits[i, j] = gap, mbit | hbit | vbit
            v[i, j], h[i, j] = vval, hval
    best = m[la, 0]
    bi, bj = la, 0
    for j in range(1, lr):
        if m[la, j] > best:
            best, bi, bj = m[la, j], la, j
    for i in range(0, la + 1):
        if m[i, lr] > best:
            best, bi, bj = m[i, lr], i, lr
    # At the best cell SeqAn prefers ending in a gap, vertical first
    # (dp_algorithm_impl.h:1354-1369), and then keeps only that gap's bits.
    tv = int(bits[bi, bj])
    if v[bi, bj] == best:
        tv = (tv & ~DIAG) | MAX_V
    elif h[bi, bj] == best:
        tv = (tv & ~DIAG) | MAX_H
    if tv & MAX_V:
        tv &= V_EXT | V_OPEN | MAX_V
    elif tv & MAX_H:
        tv &= H_EXT | H_OPEN | MAX_H
    moves = _traceback_moves_affine(bits, bi, bj, tv)
    read_s = ''.join(chr(b) for b in _decode_bytes(r))
    adapter_s = ''.join(chr(b) for b in _decode_bytes(a))
    return _assemble(read_s, adapter_s, moves, bi, bj, lr, la, int(best))


def _traceback_moves_affine(bits, i, j, tv):
    """SeqAn's GapsLeft walk (dp_traceback_impl.h) from cell (i, j) whose
    trace value is tv; the move list in traceback (end-first) order."""
    moves = []
    while i > 0 and j > 0 and tv != 0:
        if tv & DIAG:
            moves.append('D')
            i, j = i - 1, j - 1
        elif tv & MAX_V and tv & V_EXT:
            while (not tv & V_OPEN or tv & V_EXT) and i != 1:
                moves.append('V')
                i -= 1
                tv = int(bits[i, j])
            moves.append('V')
            i -= 1
        elif tv & MAX_V and tv & V_OPEN:
            moves.append('V')
            i -= 1
        elif tv & MAX_H and tv & H_EXT:
            while (not tv & H_OPEN or tv & H_EXT) and j != 1:
                moves.append('H')
                j -= 1
                tv = int(bits[i, j])
            moves.append('H')
            j -= 1
        elif tv & MAX_H and tv & H_OPEN:
            moves.append('H')
            j -= 1
        else:
            break
        tv = int(bits[i, j])
    moves.append(('END', i, j))
    return moves


def _stats_from_gapped(read_row: list, adapter_row: list,
                       raw_score: int) -> AlignResult:
    """Direct re-expression of alignment.cpp:26-121 over gapped char rows."""
    n = len(read_row)
    first_r = first_a = -1
    last_r = last_a = -1
    for idx in range(n):
        if read_row[idx] != '-' and first_r < 0:
            first_r = idx
        if adapter_row[idx] != '-' and first_a < 0:
            first_a = idx
    for idx in range(n - 1, -1, -1):
        if read_row[idx] != '-' and last_r < 0:
            last_r = idx
        if adapter_row[idx] != '-' and last_a < 0:
            last_a = idx
    if first_r < 0 or first_a < 0:
        return AlignResult(-1, -1, -1, -1, raw_score, 0, 0, 0)
    aln_start = max(first_r, first_a)
    aln_end = min(last_r, last_a)
    matches = sum(1 for idx in range(aln_start, aln_end + 1)
                  if read_row[idx] == adapter_row[idx])
    aligned_len = aln_end - aln_start + 1
    full_len = last_a - first_a + 1
    read_start = sum(1 for idx in range(aln_start) if read_row[idx] != '-')
    adapter_start = sum(1 for idx in range(aln_start)
                        if adapter_row[idx] != '-')
    read_end = sum(1 for idx in range(aln_end) if read_row[idx] != '-')
    adapter_end = sum(1 for idx in range(aln_end) if adapter_row[idx] != '-')
    return AlignResult(read_start, read_end, adapter_start, adapter_end,
                       raw_score, matches, aligned_len, full_len)


def _align_traceback_linear(r, a, match, mismatch, gap) -> AlignResult:
    """LinearGaps profile (NeedlemanWunsch dispatch when open == ext).
    dp_formula_linear.h SingleTrace tie-breaks: diagonal beats vertical beats
    horizontal; PreferGapsAtEnd_ is False for LinearGaps+GapsLeft."""
    lr, la = len(r), len(a)
    m = np.zeros((la + 1, lr + 1), dtype=np.int64)
    bits = np.zeros((la + 1, lr + 1), dtype=np.uint8)
    for i in range(1, la + 1):
        sub = np.where(r == a[i - 1], match, mismatch)
        for j in range(1, lr + 1):
            diag = m[i - 1, j - 1] + sub[j - 1]
            vert = m[i - 1, j] + gap
            horiz = m[i, j - 1] + gap
            # dp_formula_linear.h SingleTrace: horizontal computed first,
            # vertical replaces on >= (pinned against SeqAn by the JAX
            # package's oracle fuzzing).
            if vert >= horiz:
                gbest, gbit = vert, V_EXT | MAX_V
            else:
                gbest, gbit = horiz, H_EXT | MAX_H
            if diag >= gbest:
                m[i, j] = diag
                bits[i, j] = DIAG
            else:
                m[i, j] = gbest
                bits[i, j] = gbit
    best = m[la, 0]
    bi, bj = la, 0
    for j in range(1, lr):
        if m[la, j] > best:
            best, bi, bj = m[la, j], la, j
    for i in range(0, la + 1):
        if m[i, lr] > best:
            best, bi, bj = m[i, lr], i, lr
    moves = _traceback_moves_linear(bits, bi, bj)
    read_s = ''.join(chr(b) for b in _decode_bytes(r))
    adapter_s = ''.join(chr(b) for b in _decode_bytes(a))
    return _assemble(read_s, adapter_s, moves, bi, bj, lr, la, int(best))


def _decode_bytes(codes):
    return [b'ACGTN'[c] for c in codes]


def _traceback_moves_linear(bits, i, j):
    """Walk the trace bits exactly as dp_traceback_impl.h does under
    LinearGaps (the linear=True, prefer_gaps_at_end=False path of the JAX
    package's _traceback_moves); returns the move list in traceback
    (end-first) order."""
    moves = []
    tv = int(bits[i, j])
    while i > 0 and j > 0 and tv != 0:
        if tv & DIAG:
            moves.append('D')
            i -= 1
            j -= 1
        elif tv & MAX_V:
            moves.append('V')
            i -= 1
        elif tv & MAX_H:
            moves.append('H')
            j -= 1
        else:
            break
        tv = int(bits[i, j])
    moves.append(('END', i, j))
    return moves


def _assemble(read, adapter, moves, bi, bj, lr, la, raw_score) -> AlignResult:
    """Build gapped rows: [head][path][read tail][adapter tail]."""
    end = moves[-1]
    i0, j0 = end[1], end[2]
    path = [mv for mv in moves[:-1]][::-1]
    read_row, adapter_row = [], []
    # Head: leading free gaps (only one of i0/j0 can be nonzero).
    for k in range(i0):
        read_row.append('-')
        adapter_row.append(_dna5(adapter[k]))
    for k in range(j0):
        read_row.append(_dna5(read[k]))
        adapter_row.append('-')
    ri, ai = j0, i0
    for mv in path:
        if mv == 'D':
            read_row.append(_dna5(read[ri]))
            adapter_row.append(_dna5(adapter[ai]))
            ri += 1
            ai += 1
        elif mv == 'H':
            read_row.append(_dna5(read[ri]))
            adapter_row.append('-')
            ri += 1
        else:
            read_row.append('-')
            adapter_row.append(_dna5(adapter[ai]))
            ai += 1
    assert ri == bj and ai == bi, (ri, bj, ai, bi)
    # Tail: read tail first, adapter tail last (dp_traceback_impl.h:528-536).
    for k in range(bj, lr):
        read_row.append(_dna5(read[k]))
        adapter_row.append('-')
    for k in range(bi, la):
        read_row.append('-')
        adapter_row.append(_dna5(adapter[k]))
    return _stats_from_gapped(read_row, adapter_row, raw_score)


def _dna5(ch: str) -> str:
    up = ch.upper()
    return up if up in 'ACGT' else 'N'
