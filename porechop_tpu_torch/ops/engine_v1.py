"""The stat-carrying alignment engine (counterpart of
porechop_tpu/ops/engine_jax.py), selected by PORECHOP_TPU_ENGINE=v1.

The JAX package's second opinion on the bitmap engine: a forward pass in
which eight statistics channels ride through the DP beside the scores, so
that the elected cell arrives with everything the 7-tuple needs: no trace
bits and no walk.  Plain functions on tensors, on the launch's device (the
card when asked, the CPU in the tests); it is the counterpart of the JAX
package's XLA engine, not a kernel's plain version, and the planner uses it
only under the variable (ops/dispatch.py).

* the DP steps over the ADAPTER axis (the short one), every step vectorised
  over (lanes, read columns);
* the in-row horizontal-gap recurrence is a running max over opening
  points, by log-shift passes with the smaller-index tie rule of the JAX
  package's _cummax_with_argmax (SeqAn prefers the longest gap run); valid
  for affine schemes with gap_open < gap_ext (supports);
* variable read and adapter lengths are masked per lane.

Memory: the carried state is 27 int32 per (lane, column) (three scores and
three 8-channel stats), and one row step holds about as much again in
temporaries, so run_jobs bounds a launch's lanes x (L + 1) (LANE_COLS).

A debugging second opinion, chosen only by the variable; it goes when the
JAX reference does (ROADMAP.md).

Reference behaviour: porechop/src/adapter_align.cpp:11-31 plus the SeqAn
Gotoh kernel; integer arithmetic end to end.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .spec import NEG

BIG = 2 ** 30
# Stats channels (porechop_tpu/ops/spec.py's order).
S_COLS, S_MATCH, S_FRC, S_FAC, S_LRC, S_LAC, S_RA, S_AR = range(8)
N_STATS = 8
_I32 = torch.int32
# A launch's lanes x (L + 1): 2^25 peaked at 5.8 GB on the 10 kb run on
# the H100 (PERF.md); a round-0 chunk of 16,384 lanes at rung 10,240
# unbounded would need ~60 GB.
LANE_COLS = 1 << 25
_MIN_LANES = 32


def selected() -> bool:
    """PORECHOP_TPU_ENGINE=v1: the planner runs its device chunks here."""
    return os.environ.get('PORECHOP_TPU_ENGINE', 'v2') == 'v1'


def _shift_right(x, sh, fill):
    """x shifted sh columns to the right along its last axis, the first sh
    columns filled with `fill`."""
    sh = min(sh, x.shape[-1])
    out = torch.full_like(x, fill)
    out[..., sh:] = x[..., :x.shape[-1] - sh]
    return out


def _cummax_with_argmax(f, k):
    """Running (max, argmax) along axis 1 by log-shift passes:
    combine((f1, k1), (f2, k2)) keeps the strictly larger f and, on ties,
    the SMALLER index (SeqAn's preference for the longest gap run)."""
    L1 = f.shape[1]
    for p in range(max(1, (L1 - 1).bit_length())):
        sh = 1 << p
        fr = _shift_right(f, sh, NEG)
        kr = _shift_right(k, sh, 0)
        take = (fr > f) | ((fr == f) & (kr < k))
        f = torch.where(take, fr, f)
        k = torch.where(take, kr, k)
    return f, k


def _gather_cols(st, idx):
    """st (B, S, L1), idx (B, L1) -> st[b, :, idx[b, j]] as (B, S, L1)."""
    return torch.gather(st, 2, idx.long()[:, None, :].expand_as(st))


def _gather_one(arr, idx):
    """arr (B, L1) or (B, S, L1), idx (B,) -> (B,) or (B, S)."""
    idx = idx.long()
    if arr.dim() == 2:
        return torch.gather(arr, 1, idx[:, None])[:, 0]
    return torch.gather(arr, 2, idx[:, None, None].expand(
        arr.shape[0], arr.shape[1], 1))[:, :, 0]


def _choose_stats(m_score, v_score, v_stats, h_score, h_stats, m_stats):
    """The start-cell rule (_correctTraceValue): V == M -> V's stats, elif
    H == M -> H's, else M's.  Scores (B,), stats (B, 8)."""
    use_v = v_score == m_score
    use_h = ~use_v & (h_score == m_score)
    return torch.where(use_v[:, None], v_stats,
                       torch.where(use_h[:, None], h_stats, m_stats))


def _align_core(reads, read_lens, adapters, adapter_lens,
                match, mismatch, gap_open, gap_ext):
    """The batched DP: reads (B, L) int8, adapters (B, A) int8, lengths
    (B,), all on one device.  Returns (best score (B,), best stats (B, 8),
    cell_i (B,), cell_j (B,)), int32.  Requires gap_open < gap_ext."""
    B, L = reads.shape
    A = adapters.shape[1]
    L1 = L + 1
    dev = reads.device
    reads = reads.to(_I32)
    rl = read_lens.to(_I32)
    al = adapter_lens.to(_I32)
    jc = torch.arange(L1, dtype=_I32, device=dev).expand(B, L1)

    # Row 0: M(0, j) = 0, its path j horizontal columns.
    m_sc = torch.zeros(B, L1, dtype=_I32, device=dev)
    m_st = torch.zeros(B, N_STATS, L1, dtype=_I32, device=dev)
    m_st[:, S_COLS] = jc
    m_st[:, S_FRC] = torch.where(jc > 0, 0, BIG)
    m_st[:, S_FAC] = BIG
    m_st[:, S_LRC] = jc - 1
    m_st[:, S_LAC] = -1
    v_sc = torch.full((B, L1), NEG, dtype=_I32, device=dev)
    v_st = torch.zeros(B, N_STATS, L1, dtype=_I32, device=dev)
    h_sc = torch.full((B, L1), NEG, dtype=_I32, device=dev)
    h_st = torch.zeros(B, N_STATS, L1, dtype=_I32, device=dev)

    # The final-column (j = read_len) candidate from row 0.
    col_best_sc = torch.zeros(B, dtype=_I32, device=dev)
    col_best_st = _gather_one(m_st, rl)
    col_best_i = torch.zeros(B, dtype=_I32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=_I32, device=dev)
    zero_col = torch.zeros(B, 1, dtype=_I32, device=dev)

    for row in range(1, A + 1):
        active = row <= al
        # V (from the previous row only).
        v_ext = v_sc + gap_ext
        v_open = m_sc + gap_open
        take_ext = v_ext >= v_open
        nv_sc = torch.where(take_ext, v_ext, v_open)
        nv_st = torch.where(take_ext[:, None, :], v_st, m_st)
        c0 = nv_st[:, S_COLS].clone()
        nv_st[:, S_FAC] = torch.minimum(nv_st[:, S_FAC], c0)
        nv_st[:, S_LAC] = c0
        nv_st[:, S_RA] = jc
        nv_st[:, S_COLS] = c0 + 1
        nv_sc[:, 0] = NEG
        del v_ext, v_open, take_ext

        # Diagonal candidates.
        eq = (reads == adapters[:, row - 1].to(_I32)[:, None]).to(_I32)
        d_sc = torch.cat([neg_col, m_sc[:, :-1] + eq * (match - mismatch)
                          + mismatch], dim=1)
        d_st = torch.cat([torch.zeros(B, N_STATS, 1, dtype=_I32, device=dev),
                          m_st[:, :, :-1]], dim=2)
        c0 = d_st[:, S_COLS].clone()
        d_st[:, S_MATCH] += torch.cat([zero_col, eq], dim=1)
        d_st[:, S_FRC] = torch.minimum(d_st[:, S_FRC], c0)
        d_st[:, S_FAC] = torch.minimum(d_st[:, S_FAC], c0)
        d_st[:, S_LRC] = c0
        d_st[:, S_LAC] = c0
        d_st[:, S_RA] = jc - 1
        d_st[:, S_AR] = row - 1
        d_st[:, S_COLS] = c0 + 1
        del eq

        # Boundary M(i, 0) = 0 with its vertical-head path.
        st0 = torch.tensor([row, 0, BIG, 0, -1, row - 1, 0, 0], dtype=_I32,
                           device=dev)

        # pre = max(diag, V), the diagonal winning ties.
        use_d = d_sc >= nv_sc
        pre_sc = torch.where(use_d, d_sc, nv_sc)
        pre_st = torch.where(use_d[:, None, :], d_st, nv_st)
        pre_sc[:, 0] = 0
        pre_st[:, :, 0] = st0
        del use_d, d_sc, d_st

        # H(i, j) = max_{k<j} pre(i, k) + open + (j - k - 1) ext
        #         = cummax_k [pre(k) + open - (k + 1) ext] + j ext.
        f = pre_sc + gap_open - (jc + 1) * gap_ext
        cum_f, cum_k = _cummax_with_argmax(f, jc)
        nh_sc = torch.cat([neg_col, cum_f[:, :-1] + jc[:, 1:] * gap_ext],
                          dim=1)
        k_star = torch.cat([zero_col, cum_k[:, :-1]], dim=1)
        nh_st = _gather_cols(pre_st, k_star)
        rlen = jc - k_star
        c0 = nh_st[:, S_COLS].clone()
        nh_st[:, S_FRC] = torch.minimum(nh_st[:, S_FRC], c0)
        nh_st[:, S_LRC] = c0 + rlen - 1
        nh_st[:, S_AR] = row
        nh_st[:, S_COLS] = c0 + rlen
        del f, cum_f, cum_k, k_star, rlen, c0

        # M = diag >= max(V, H) ? diag : (V >= H ? V : H); pre folds V.
        use_v_gap = nv_sc >= nh_sc
        use_diag = pre_sc >= nh_sc
        nm_sc = torch.where(use_diag, pre_sc,
                            torch.where(use_v_gap, nv_sc, nh_sc))
        nm_st = torch.where(use_diag[:, None, :], pre_st,
                            torch.where(use_v_gap[:, None, :], nv_st, nh_st))
        nm_sc[:, 0] = 0
        nm_st[:, :, 0] = st0
        del use_v_gap, use_diag, pre_sc, pre_st

        # The final-column candidate at (row, read_len).
        cand_m = _gather_one(nm_sc, rl)
        cand_st = _choose_stats(cand_m, _gather_one(nv_sc, rl),
                                _gather_one(nv_st, rl),
                                _gather_one(nh_sc, rl),
                                _gather_one(nh_st, rl),
                                _gather_one(nm_st, rl))
        better = active & (cand_m > col_best_sc)
        col_best_sc = torch.where(better, cand_m, col_best_sc)
        col_best_st = torch.where(better[:, None], cand_st, col_best_st)
        col_best_i = torch.where(better, row, col_best_i)

        # Lanes whose adapter has ended keep their last row.
        act2 = active[:, None]
        act3 = active[:, None, None]
        m_sc = torch.where(act2, nm_sc, m_sc)
        m_st = torch.where(act3, nm_st, m_st)
        v_sc = torch.where(act2, nv_sc, v_sc)
        v_st = torch.where(act3, nv_st, v_st)
        h_sc = torch.where(act2, nh_sc, h_sc)
        h_st = torch.where(act3, nh_st, h_st)
        del nm_sc, nm_st, nv_sc, nv_st, nh_sc, nh_st

    # Last-row candidates: the first max over j in [0, read_len).
    masked = torch.where(jc < rl[:, None], m_sc, NEG - 1)
    j_star = torch.argmax(masked, dim=1).to(_I32)     # the first max
    row_sc = _gather_one(m_sc, j_star)
    row_st = _choose_stats(row_sc, _gather_one(v_sc, j_star),
                           _gather_one(v_st, j_star),
                           _gather_one(h_sc, j_star),
                           _gather_one(h_st, j_star),
                           _gather_one(m_st, j_star))

    # Last-row candidates come first in the scout's order: the column
    # wins only with a strictly greater score.
    col_wins = col_best_sc > row_sc
    best_sc = torch.where(col_wins, col_best_sc, row_sc)
    best_st = torch.where(col_wins[:, None], col_best_st, row_st)
    cell_i = torch.where(col_wins, col_best_i, al)
    cell_j = torch.where(col_wins, rl, j_star)
    return best_sc, best_st, cell_i, cell_j


def stats_device(best_st, cell_i, cell_j, read_lens, adapter_lens):
    """The (matches, full_len) fragment of finish_batch on the device
    (the JAX package's detection group max consumes only these two):
    returns (matches, full_len, ok), int32, int32 and bool tensors."""
    cell_i = cell_i.to(_I32)
    cell_j = cell_j.to(_I32)
    lr = read_lens.to(_I32)
    la = adapter_lens.to(_I32)
    cols = best_st[:, S_COLS]
    matches = best_st[:, S_MATCH]
    fac = best_st[:, S_FAC]
    lac = best_st[:, S_LAC]
    cols = cols + torch.where(cell_j < lr, lr - cell_j, 0)
    has_atail = cell_i < la
    fac = torch.where(has_atail, torch.minimum(fac, cols), fac)
    lac = torch.where(has_atail, cols + (la - cell_i) - 1, lac)
    full_len = lac - fac + 1
    ok = (lr > 0) & (la > 0) & (full_len > 0)
    return matches, full_len, ok


def finish_batch(best_sc, best_st, cell_i, cell_j, read_lens, adapter_lens):
    """Host tail/head resolution (numpy): appends the free tail segments
    and derives the 7-tuple fields (porechop_tpu/ops/spec.py
    _finish_stats).  Returns a dict of int64 arrays."""
    best_sc = np.asarray(best_sc).astype(np.int64)
    st = np.asarray(best_st).astype(np.int64)
    cell_i = np.asarray(cell_i).astype(np.int64)
    cell_j = np.asarray(cell_j).astype(np.int64)
    lr = np.asarray(read_lens).astype(np.int64)
    la = np.asarray(adapter_lens).astype(np.int64)

    cols = st[:, S_COLS].copy()
    matches = st[:, S_MATCH].copy()
    frc = st[:, S_FRC].copy()
    fac = st[:, S_FAC].copy()
    lrc = st[:, S_LRC].copy()
    lac = st[:, S_LAC].copy()
    s_ra = st[:, S_RA].copy()
    s_ar = st[:, S_AR].copy()

    has_rtail = cell_j < lr
    frc = np.where(has_rtail, np.minimum(frc, cols), frc)
    lrc = np.where(has_rtail, cols + (lr - cell_j) - 1, lrc)
    s_ar = np.where(has_rtail, cell_i, s_ar)
    cols = cols + np.where(has_rtail, lr - cell_j, 0)

    has_atail = cell_i < la
    fac = np.where(has_atail, np.minimum(fac, cols), fac)
    lac = np.where(has_atail, cols + (la - cell_i) - 1, lac)
    s_ra = np.where(has_atail, lr, s_ra)

    aln_start = np.maximum(frc, fac)
    aln_end = np.minimum(lrc, lac)
    read_start = np.where(fac >= frc, fac, 0)
    adapter_start = np.where(frc >= fac, frc, 0)
    read_end = np.where(lrc <= lac, lr - 1, s_ra)
    adapter_end = np.where(lac <= lrc, la - 1, s_ar)
    aligned_len = aln_end - aln_start + 1
    matches = np.where(aligned_len <= 0, 0, matches)
    aligned_len = np.maximum(aligned_len, 0)
    full_len = lac - fac + 1

    failed = (lr == 0) | (la == 0)
    read_start = np.where(failed, -1, read_start)
    return dict(read_start=read_start, read_end=read_end,
                adapter_start=adapter_start, adapter_end=adapter_end,
                raw_score=np.where(failed, -(2 ** 31), best_sc),
                matches=np.where(failed, 0, matches),
                aligned_len=np.where(failed, 0, aligned_len),
                full_len=np.where(failed, 0, full_len))


def supports(scoring) -> bool:
    """The running-max formulation needs affine gaps with open < extend."""
    _, _, gap_open, gap_ext = scoring
    return gap_open < gap_ext


def align_batch(reads_pad, read_lens, adapters_pad, adapter_lens,
                scoring=(3, -6, -5, -2), device='cpu'):
    """Batched exact alignment on `device`: reads_pad (B, L) int8 Dna5
    codes (pad with 4), adapters_pad (B, A) int8, lengths int32, as host
    arrays.  Returns a dict of numpy int64 arrays: read_start, read_end
    (INCLUSIVE, as the C++ reports it), adapter_start, adapter_end,
    raw_score, matches, aligned_len, full_len."""
    if not supports(scoring):
        raise ValueError('scoring scheme %s: the v1 engine needs gap_open < '
                         'gap_ext' % (tuple(scoring),))
    match, mismatch, gap_open, gap_ext = (int(x) for x in scoring)
    x = [torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(device)
         for a, t in ((reads_pad, np.int8), (read_lens, np.int32),
                      (adapters_pad, np.int8), (adapter_lens, np.int32))]
    best_sc, best_st, cell_i, cell_j = (
        t.cpu().numpy() for t in _align_core(*x, match, mismatch, gap_open,
                                             gap_ext))
    return finish_batch(best_sc, best_st, cell_i, cell_j, read_lens,
                        adapter_lens)


def run_jobs(windows, adapters, pairs, lb, amax, scoring, device):
    """The planner's chunk of jobs `pairs` (J, 2) of (window, adapter)
    indices at window rung lb and adapter rung amax, on `device`
    (porechop_tpu/ops/dispatch.py:938-973): packed densely on the host,
    each distinct window and adapter once, in launches of at most
    LANE_COLS lane columns (a power of two of lanes, pad lanes 1-bp dummy
    jobs).  Returns align_batch's dict for the J jobs."""
    per = _MIN_LANES
    while per * 2 * (lb + 1) <= LANE_COLS:
        per *= 2
    parts = []
    for lo in range(0, len(pairs), per):
        part = pairs[lo:lo + per]
        B = len(part)
        Bp = max(_MIN_LANES, 1 << (B - 1).bit_length())
        uw, winv = np.unique(part[:, 0], return_inverse=True)
        ua, ainv = np.unique(part[:, 1], return_inverse=True)
        wmat = np.full((len(uw), lb), 4, dtype=np.int8)
        wlen = np.empty(len(uw), dtype=np.int32)
        for r, k in enumerate(uw):
            wmat[r, :len(windows[k])] = windows[k]
            wlen[r] = len(windows[k])
        amat = np.full((len(ua), amax), 4, dtype=np.int8)
        alen = np.empty(len(ua), dtype=np.int32)
        for r, k in enumerate(ua):
            amat[r, :len(adapters[k])] = adapters[k]
            alen[r] = len(adapters[k])
        reads = np.full((Bp, lb), 4, dtype=np.int8)
        adps = np.full((Bp, amax), 4, dtype=np.int8)
        rl = np.ones(Bp, dtype=np.int32)
        al = np.ones(Bp, dtype=np.int32)
        reads[:B] = wmat[winv]
        adps[:B] = amat[ainv]
        rl[:B] = wlen[winv]
        al[:B] = alen[ainv]
        res = align_batch(reads, rl, adps, al, scoring, device=device)
        parts.append({f: v[:B] for f, v in res.items()})
    return {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}
