"""Porechop's one alignment, in plain PyTorch, batched over lanes.

Porechop v0.2.4 aligns an adapter (rows) against a read window (columns)
with SeqAn's `globalAlignment` under `AlignConfig<true, true, true, true>`:
free end gaps on all four sides, affine gaps (a gap of k costs
open + (k - 1) ext), Dna5 codes (every non-ACGT base, and the '-' that the
middle pass masks with, is N, and N == N is a match), and the traceback
`TracebackConfig_<SingleTrace, GapsLeft>`.  The rules, cell by cell:

    H[i][j] = max(H[i][j-1] + ext, M[i][j-1] + open)      (gap in adapter)
    V[i][j] = max(V[i-1][j] + ext, M[i-1][j] + open)      (gap in read)
    M[i][j] = max(M[i-1][j-1] + sub, V[i][j], H[i][j])
    M[0][j] = M[i][0] = 0, V and H there -inf

Ties: the diagonal beats a gap, V beats H, extension beats opening.  The
best cell is the first maximum in the order: last row left to right
(columns 0 .. Lr-1), then last column top to bottom.  At that cell the
walk prefers to end in a gap (V if V == M, else H if H == M).  A gap run
is walked while the cell's bits say "extend" (or say neither), and one
step more.  From the walk, SeqAn's alignment.cpp reads the read and
adapter positions and the percent identities over the aligned region and
over the whole adapter span.

The rows are computed one at a time, vectorised over lanes and columns.
The horizontal recurrence is a running maximum along the row:
H[i][j] = open + (j-1) ext + max_{k<j}(M'[i][k] - k ext), with M' the
cell's best without H; this is exact when open <= ext, because a term
that starts from an H cell is never above the term from where that gap
opened.  Nothing here comes from the program under test.
"""

from __future__ import annotations

import torch

NEG = -(2 ** 30)
H_EXT, H_OPEN, V_EXT, V_OPEN, DIAG, MAX_V, MAX_H = 1, 2, 4, 8, 16, 32, 64
N_CODE = 4

_TABLE = torch.full((256,), N_CODE, dtype=torch.int8)
for _i, _b in enumerate(b'ACGT'):
    _TABLE[_b] = _i
    _TABLE[_b + 32] = _i
_TABLE[ord('U')] = _TABLE[ord('u')] = 3


def encode(seq: str) -> torch.Tensor:
    """Dna5 codes of a sequence (int8, 0..4)."""
    if not seq:
        return torch.zeros(0, dtype=torch.int8)
    raw = torch.frombuffer(bytearray(seq.encode('ascii')), dtype=torch.uint8)
    return _TABLE[raw.long()]


def pack(seqs, device, pad=N_CODE + 1):
    """(codes (B, Lmax) int8 on device, lengths (B,) int64): the sequences
    (strings or code tensors) padded to the longest with a code that
    matches nothing."""
    codes = [encode(s) if isinstance(s, str) else s for s in seqs]
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int64)
    width = max(int(lens.max()) if len(codes) else 0, 1)
    out = torch.full((len(codes), width), pad, dtype=torch.int8)
    if codes:
        flat = torch.cat(codes)
        rows = torch.repeat_interleave(torch.arange(len(codes)), lens)
        cols = torch.arange(len(flat)) - torch.repeat_interleave(
            torch.cumsum(lens, 0) - lens, lens)
        out[rows, cols] = flat
    return out.to(device), lens.to(device)


class Result:
    """Per lane: raw score, read_start, read_end (exclusive), matches,
    aligned_len, full_len (int64 tensors on the host); read_start is -1
    where the read or the adapter is empty (Porechop's failed alignment)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _dtype(L, A, scheme):
    """int16 where every value of the pass fits (scores, the running
    maximum's ramp of L gap extensions, and -inf as -2**14), else int32."""
    match, mismatch, gap_open, gap_ext = scheme
    span = abs(match) * A + abs(gap_ext) * (L + 1) + abs(gap_open)
    if span < 2 ** 15 - 2 ** 11 and max(-mismatch, -gap_open) * A < 2 ** 12:
        return torch.int16, -(2 ** 14)
    return torch.int32, NEG


def _dp(reads, rlens, adps, alens, scheme, want_bits, diag_ties=True,
        same_adapter=False):
    """The forward pass.  Returns (best, bi, bj, vbest, hbest, bits): the
    elected cell of each lane, its score, V and H there, and the trace
    bits (B, A+1, L+1) uint8 when want_bits.  diag_ties=False gives a tie
    between the diagonal and a gap to the gap (a control, not SeqAn).
    same_adapter: every lane has the same adapter, so a row's substitution
    scores are one precomputed row for all lanes."""
    match, mismatch, gap_open, gap_ext = scheme
    if gap_open > gap_ext:
        raise ValueError('the running-maximum form needs gap open <= '
                         'gap extend')
    dev = reads.device
    B, L = reads.shape
    A = adps.shape[1]
    dt, neg = _dtype(L, A, scheme)
    i64 = dict(dtype=torch.int64, device=dev)
    iv = dict(dtype=dt, device=dev)
    cols = torch.arange(L + 1, **i64)
    # ramp[k] = k * ext, so M'[k] - k ext = M'[k] - ramp[k].
    ramp = (cols * gap_ext).to(dt)
    h_off = (ramp[1:] + (gap_open - gap_ext)).to(dt)
    # Substitution scores by adapter code: sub_by[c][b, j-1] for column j.
    sub_by = torch.stack([torch.where(reads == c, match, mismatch).to(dt)
                          for c in range(5)] + [torch.full_like(
                              reads, mismatch, dtype=dt)])
    lane = torch.arange(B, **i64)
    m_prev = torch.zeros((B, L + 1), **iv)
    v = torch.full((B, L + 1), neg, **iv)
    tmp = torch.empty_like(m_prev)
    diag = torch.empty_like(m_prev)
    diag[:, 0] = neg
    rl = rlens.to(torch.int64)
    al = alens.to(torch.int64)
    # Last-column candidates: M, V, H at (i, rl) for i = 0..A.
    col_m = torch.full((B, A + 1), neg, **iv)
    col_v = torch.full((B, A + 1), neg, **iv)
    col_h = torch.full((B, A + 1), neg, **iv)
    col_m[:, 0] = 0
    # Last-row candidates, filled when row i == al.
    row_best = torch.full((B,), neg, **iv)
    row_j = torch.zeros((B,), **i64)
    row_v = torch.full((B,), neg, **iv)
    row_h = torch.full((B,), neg, **iv)
    # An empty adapter's last row is row 0: M = 0 over columns < rl.
    row_best = torch.where(al == 0, torch.zeros_like(row_best), row_best)
    bits = (torch.zeros((B, A + 1, L + 1), dtype=torch.uint8, device=dev)
            if want_bits else None)
    in_read = cols[None, :] < rl[:, None]          # columns 0 .. rl-1
    codes = adps.to(torch.int64).clamp(max=5)
    first = codes[0].tolist() if same_adapter and B else None
    at = rl[:, None]
    for i in range(1, A + 1):
        sub = (sub_by[first[i - 1]] if first is not None
               else sub_by[codes[:, i - 1], lane])
        if want_bits:
            v_ext = v + gap_ext
            v_open = m_prev + gap_open
            torch.maximum(v_ext, v_open, out=v)
        else:
            v.add_(gap_ext)
            torch.maximum(v, m_prev + gap_open, out=v)
        v[:, 0] = neg
        torch.add(m_prev[:, :-1], sub, out=diag[:, 1:])
        mp = torch.maximum(diag, v)
        mp[:, 0] = 0
        torch.sub(mp, ramp, out=tmp)
        run = torch.cummax(tmp, dim=1).values
        h = tmp
        h[:, 0] = neg
        torch.add(run[:, :-1], h_off, out=h[:, 1:])
        del run
        m = torch.maximum(mp, h)
        m[:, 0] = 0
        if want_bits:
            h_ext = torch.empty_like(h)
            h_ext[:, 0] = neg
            torch.add(h[:, :-1], gap_ext, out=h_ext[:, 1:])
            h_open = torch.empty_like(h)
            h_open[:, 0] = neg
            torch.add(m[:, :-1], gap_open, out=h_open[:, 1:])
            gap = torch.maximum(v, h)
            b = torch.where(h_ext >= h_open, H_EXT, H_OPEN)
            b = b | torch.where(v_ext >= v_open, V_EXT, V_OPEN)
            take_diag = diag >= gap if diag_ties else diag > gap
            b = b | torch.where(take_diag, DIAG,
                                torch.where(v >= h, MAX_V, MAX_H))
            b[:, 0] = 0
            bits[:, i] = b.to(torch.uint8)
            del h_ext, h_open, gap, b, v_ext, v_open
        # Last column (j = rl) of this row.
        col_m[:, i] = m.gather(1, at)[:, 0]
        col_v[:, i] = v.gather(1, at)[:, 0]
        col_h[:, i] = h.gather(1, at)[:, 0]
        # Last row (i = al): the first maximum over columns 0 .. rl-1.
        last = al == i
        if bool(last.any()):
            masked = torch.where(in_read, m, neg)
            best = masked.max(dim=1).values
            j = _first_max(masked, best)
            row_best = torch.where(last, best, row_best)
            row_j = torch.where(last, j, row_j)
            row_v = torch.where(last, v.gather(1, j[:, None])[:, 0], row_v)
            row_h = torch.where(last, h.gather(1, j[:, None])[:, 0], row_h)
        tmp = mp
        m_prev = m
    # Column candidates only for rows 0 .. al.
    rows = torch.arange(A + 1, **i64)
    col_ok = rows[None, :] <= al[:, None]
    col_masked = torch.where(col_ok, col_m, neg)
    col_best = col_masked.max(dim=1).values
    col_i = _first_max(col_masked, col_best)
    take_col = col_best > row_best
    best = torch.where(take_col, col_best, row_best).to(torch.int64)
    bi = torch.where(take_col, col_i, al)
    bj = torch.where(take_col, rl, row_j)
    vbest = torch.where(take_col, col_v.gather(1, col_i[:, None])[:, 0],
                        row_v).to(torch.int64)
    hbest = torch.where(take_col, col_h.gather(1, col_i[:, None])[:, 0],
                        row_h).to(torch.int64)
    return best, bi, bj, vbest, hbest, bits


def _first_max(x, best):
    """Index of the first element of each row equal to its maximum."""
    hit = x == best[:, None]
    idx = torch.arange(x.shape[1], device=x.device).expand_as(x)
    return torch.where(hit, idx, x.shape[1]).min(dim=1).values


def score(reads, rlens, adps, alens, scheme, same_adapter=False):
    """The best score of each lane (int64, on the lanes' device)."""
    best = _dp(reads, rlens, adps, alens, scheme, False,
               same_adapter=same_adapter)[0]
    return best.to(torch.int64)


def align(reads, rlens, adps, alens, scheme, variant='seqan'):
    """Full alignment with SeqAn's traceback and alignment.cpp's numbers,
    as a Result on the host.  variant='gap_beats_diagonal' breaks a tie
    between the diagonal and a gap towards the gap in every cell: the
    control, which breaks the guarantee of SeqAn's traceback and so of
    Porechop's exact positions."""
    B = reads.shape[0]
    if B == 0:
        z = torch.zeros(0, dtype=torch.int64)
        return Result(score=z, read_start=z, read_end=z, matches=z,
                      aligned_len=z, full_len=z)
    if variant not in ('seqan', 'gap_beats_diagonal'):
        raise ValueError(variant)
    best, bi, bj, vbest, hbest, bits = _dp(reads, rlens, adps, alens,
                                           scheme, True,
                                           variant == 'seqan')
    dev = reads.device
    B, A1, L1 = bits.shape
    flat = bits.reshape(-1)
    lane_base = torch.arange(B, device=dev, dtype=torch.int64) * (A1 * L1)
    i = bi.clone()
    j = bj.clone()
    tv = flat[lane_base + i * L1 + j].to(torch.int32)
    pref_v = vbest == best
    pref_h = ~pref_v & (hbest == best)
    tv = torch.where(pref_v, (tv & ~DIAG) | MAX_V, tv)
    tv = torch.where(pref_h, (tv & ~DIAG) | MAX_H, tv)
    # prefer_gaps_at_end: keep only the gap's own bits.
    tv = torch.where((tv & MAX_V) != 0, tv & (V_EXT | V_OPEN | MAX_V),
                     torch.where((tv & MAX_H) != 0,
                                 tv & (H_EXT | H_OPEN | MAX_H), tv))
    rcodes = reads.to(torch.int64)
    acodes = adps.to(torch.int64)
    mode = torch.zeros(B, dtype=torch.int64, device=dev)  # 0, 1 V run, 2 H
    done = (rlens == 0) | (alens == 0)
    moves = []      # per step: 0 none, 1 diag, 2 vertical, 3 horizontal
    eqs = []
    while True:
        normal = (mode == 0) & ~done
        stop = normal & ((i == 0) | (j == 0) | (tv == 0))
        done = done | stop
        active = ~done
        if not bool(active.any()):
            break
        normal = normal & active
        has = lambda f: (tv & f) != 0                      # noqa: E731
        d = normal & has(DIAG)
        enter_v = normal & ~d & has(MAX_V) & has(V_EXT)
        single_v = normal & ~d & ~enter_v & has(MAX_V) & has(V_OPEN)
        rest = normal & ~d & ~enter_v & ~single_v
        enter_h = rest & has(MAX_H) & has(H_EXT)
        single_h = rest & ~enter_h & has(MAX_H) & has(H_OPEN)
        dead = rest & ~enter_h & ~single_h
        in_v = (mode == 1) & active | enter_v
        in_h = (mode == 2) & active | enter_h
        keep_v = in_v & ((~has(V_OPEN)) | has(V_EXT)) & (i != 1)
        keep_h = in_h & ((~has(H_OPEN)) | has(H_EXT)) & (j != 1)
        vmove = in_v | single_v
        hmove = in_h | single_h
        done = done | dead
        mv = torch.zeros(B, dtype=torch.int8, device=dev)
        mv = torch.where(d, 1, mv)
        mv = torch.where(vmove, 2, mv)
        mv = torch.where(hmove, 3, mv).to(torch.int8)
        # A diagonal step consumes read[j-1] and adapter[i-1].
        jr = (j - 1).clamp(min=0)
        ia = (i - 1).clamp(min=0)
        eq = d & (rcodes.gather(1, jr[:, None])[:, 0]
                  == acodes.gather(1, ia[:, None])[:, 0])
        moves.append(mv)
        eqs.append(eq)
        i = i - (d | vmove).to(torch.int64)
        j = j - (d | hmove).to(torch.int64)
        mode = torch.where(keep_v, 1, torch.where(keep_h, 2, 0))
        tv = flat[lane_base + i * L1 + j].to(torch.int32)
    return _stats(moves, eqs, i, j, bi, bj, rlens, alens, best)


def _stats(moves, eqs, i0, j0, bi, bj, rlens, alens, best):
    """alignment.cpp's numbers from the walk.  The gapped layout is
    [head][path][read tail][adapter tail]: a head of i0 adapter bases
    (or j0 read bases), the path forwards, the read's bases after bj, the
    adapter's after bi."""
    dev = bi.device
    B = bi.shape[0]
    if moves:
        rec = torch.stack(moves, 1).to(torch.int64)     # recorded: end first
        eq = torch.stack(eqs, 1)
    else:
        rec = torch.zeros((B, 0), dtype=torch.int64, device=dev)
        eq = torch.zeros((B, 0), dtype=torch.bool, device=dev)
    T = rec.shape[1]
    P = (rec != 0).sum(1)
    # Forward order: the path's k-th move is recorded move P-1-k.
    k = torch.arange(T, device=dev)[None, :]
    src = (P[:, None] - 1 - k).clamp(min=0)
    fwd = torch.where(k < P[:, None], rec.gather(1, src), 0)
    is_r = (fwd == 1) | (fwd == 3)          # column holds a read base
    is_a = (fwd == 1) | (fwd == 2)          # column holds an adapter base
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    cum_r = torch.cat([zero, is_r.long().cumsum(1)], 1)     # (B, T+1)
    cum_a = torch.cat([zero, is_a.long().cumsum(1)], 1)
    rl = rlens.to(torch.int64)
    al = alens.to(torch.int64)
    h = torch.maximum(i0, j0)
    rt = rl - bj                            # read tail
    at = al - bi                            # adapter tail
    total = h + P + rt + at
    big = torch.full_like(P, 1 << 40)

    def first(mask):
        idx = torch.where(mask, k.expand(B, -1), T)
        return idx.min(1).values if T else torch.full_like(P, T)

    def last(mask):
        idx = torch.where(mask, k.expand(B, -1), -1)
        return idx.max(1).values if T else torch.full_like(P, -1)

    fr, fa = first(is_r), first(is_a)
    lr_, la_ = last(is_r), last(is_a)
    first_r = torch.where(j0 > 0, 0, torch.where(fr < P, h + fr,
                          torch.where(rt > 0, h + P, big)))
    first_a = torch.where(i0 > 0, 0, torch.where(fa < P, h + fa,
                          torch.where(at > 0, h + P + rt, big)))
    last_r = torch.where(rt > 0, h + P + rt - 1,
                         torch.where(lr_ >= 0, h + lr_, j0 - 1))
    last_a = torch.where(at > 0, total - 1,
                         torch.where(la_ >= 0, h + la_, i0 - 1))
    aln_start = torch.maximum(first_r, first_a)
    aln_end = torch.minimum(last_r, last_a)

    def before(c, head, cum, after_path):
        """Bases of one sequence in columns [0, c)."""
        q = (c - h).clamp(min=0, max=T)
        in_path = cum.gather(1, q[:, None])[:, 0] + head
        out = torch.where(c <= h, torch.minimum(c, head), in_path)
        return torch.where(c > h + P, after_path, out)

    def read_before(c):
        return before(c, j0, cum_r, torch.minimum(bj + (c - h - P), rl))

    ok = (rl > 0) & (al > 0)
    read_start = torch.where(ok, read_before(aln_start), -1)
    read_end = torch.where(ok, read_before(aln_end), 0)
    matches = (eq & (rec == 1)).sum(1)
    aligned_len = aln_end - aln_start + 1
    full_len = last_a - first_a + 1
    cpu = lambda t: t.to('cpu', torch.int64)          # noqa: E731
    return Result(score=cpu(best), read_start=cpu(read_start),
                  read_end=cpu(torch.where(ok, read_end + 1, 0)),
                  matches=cpu(torch.where(ok, matches, 0)),
                  aligned_len=cpu(torch.where(ok, aligned_len, 0)),
                  full_len=cpu(torch.where(ok, full_len, 0)))


def pct(matches: int, length: int) -> float:
    """Percent identity as Porechop reads it: C++ std::to_string (six
    decimals) parsed back by Python; nan for an empty span."""
    if length <= 0:
        return float('nan')
    return float('%.6f' % (100.0 * matches / length))
