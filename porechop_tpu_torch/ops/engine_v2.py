"""The device-side pieces around the DP kernels: the fused gathers from
deduplicated window/adapter tables, the finishers and the per-group
reductions.

Counterpart of the parts of porechop_tpu/ops/engine_v2.py on the trimming
path, in plain PyTorch on the device the tensors lie on.  The forwards and
the walk themselves are ops/kernels.py (the walk of a trace-bit launch,
_traceback_impl there, runs inside kernels.forward_walk).  Window tables travel unpacked: the
JAX package packed codes two or four to a byte only to spare a slow host
link.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


def finish_v2(walk, best_sc, cell_i, cell_j, read_lens, adapter_lens):
    """Host assembly: head/path/tail columns -> the reference 7-tuple
    fields (alignment.cpp:26-121 semantics).  Inputs are host arrays."""
    walk = np.asarray(walk).astype(np.int64)
    (i0, j0, n_path, matches, rd_tmin, rd_tmax, ad_tmin, ad_tmax,
     s_ar_rev, s_ra_rev) = (walk[:, k] for k in range(10))
    best_sc = np.asarray(best_sc).astype(np.int64)
    bi = np.asarray(cell_i).astype(np.int64)
    bj = np.asarray(cell_j).astype(np.int64)
    lr = np.asarray(read_lens).astype(np.int64)
    la = np.asarray(adapter_lens).astype(np.int64)
    BIGV = np.int64(1) << 60

    head = i0 + j0
    cols = head + n_path

    # Path-local stats in forward columns: col(t) = head + n_path - 1 - t.
    has_rd_path = rd_tmax >= 0
    frc = np.where(has_rd_path, head + n_path - 1 - rd_tmax, BIGV)
    lrc = np.where(has_rd_path, head + n_path - 1 - rd_tmin, -1)
    s_ar = np.where(has_rd_path, s_ar_rev, 0)
    has_ad_path = ad_tmax >= 0
    fac = np.where(has_ad_path, head + n_path - 1 - ad_tmax, BIGV)
    lac = np.where(has_ad_path, head + n_path - 1 - ad_tmin, -1)
    s_ra = np.where(has_ad_path, s_ra_rev, 0)

    # Head segment: cols [0, i0) adapter bases, or [0, j0) read bases.
    ad_head = i0 > 0
    fac = np.where(ad_head, 0, fac)
    lac = np.where(ad_head & ~has_ad_path, i0 - 1, lac)
    s_ra = np.where(ad_head & ~has_ad_path, 0, s_ra)
    rd_head = j0 > 0
    frc = np.where(rd_head, 0, frc)
    lrc = np.where(rd_head & ~has_rd_path, j0 - 1, lrc)
    s_ar = np.where(rd_head & ~has_rd_path, 0, s_ar)

    # Tails: read tail first, then adapter tail (dp_traceback_impl.h:528-536).
    has_rtail = bj < lr
    frc = np.where(has_rtail, np.minimum(frc, cols), frc)
    lrc = np.where(has_rtail, cols + (lr - bj) - 1, lrc)
    s_ar = np.where(has_rtail, bi, s_ar)
    cols = cols + np.where(has_rtail, lr - bj, 0)
    has_atail = bi < la
    fac = np.where(has_atail, np.minimum(fac, cols), fac)
    lac = np.where(has_atail, cols + (la - bi) - 1, lac)
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

    failed = (lr == 0) | (la == 0) | (frc >= BIGV) | (fac >= BIGV)
    read_start = np.where(failed, -1, read_start)
    return dict(read_start=read_start, read_end=read_end,
                adapter_start=adapter_start, adapter_end=adapter_end,
                raw_score=np.where(failed, -(2 ** 31), best_sc),
                matches=np.where(failed, 0, matches),
                aligned_len=np.where(failed, 0, aligned_len),
                full_len=np.where(failed, 0, full_len))


def finish_stats_device(walk, best_sc, cell_i, cell_j, rl, la):
    """Device twin of the (matches, full_len, failed) fragment of
    finish_v2 (porechop_tpu/ops/engine_v2._finish_stats_device) -- keep
    the two in sync."""
    w = walk.to(torch.int64)
    (i0, j0, n_path, matches, rd_tmin, rd_tmax, ad_tmin, ad_tmax,
     s_ar_rev, s_ra_rev) = (w[:, k] for k in range(10))
    BIGV = 1 << 30
    bi = cell_i.to(torch.int64)
    bj = cell_j.to(torch.int64)
    rl = rl.to(torch.int64)
    la = la.to(torch.int64)

    head = i0 + j0
    cols = head + n_path
    has_rd_path = rd_tmax >= 0
    frc = torch.where(has_rd_path, head + n_path - 1 - rd_tmax, BIGV)
    has_ad_path = ad_tmax >= 0
    fac = torch.where(has_ad_path, head + n_path - 1 - ad_tmax, BIGV)
    lac = torch.where(has_ad_path, head + n_path - 1 - ad_tmin, -1)

    ad_head = i0 > 0
    fac = torch.where(ad_head, 0, fac)
    lac = torch.where(ad_head & ~has_ad_path, i0 - 1, lac)
    frc = torch.where(j0 > 0, 0, frc)

    has_rtail = bj < rl
    frc = torch.where(has_rtail, torch.minimum(frc, cols), frc)
    cols = cols + torch.where(has_rtail, rl - bj, 0)
    has_atail = bi < la
    fac = torch.where(has_atail, torch.minimum(fac, cols), fac)
    lac = torch.where(has_atail, cols + (la - bi) - 1, lac)

    full_len = lac - fac + 1
    failed = (rl == 0) | (la == 0) | (frc >= BIGV) | (fac >= BIGV)
    return matches, full_len, failed


def merge_groupmax(parts):
    """The per-group (matches, full_len) that groupmax_reduce gives over
    the lanes of several launches, from each launch's own result (parts:
    a list of (gm, gl) pairs).  Per group the higher identity fraction
    wins, and between equal fractions the pair with more matches, then the
    longer one: the lane groupmax_reduce elects.  A group no lane of a
    launch reached is (0, 0) there and never wins.  Host int64 arrays."""
    gm, gl = (np.asarray(x).astype(np.int64) for x in parts[0])
    for m, ln in parts[1:]:
        m = np.asarray(m).astype(np.int64)
        ln = np.asarray(ln).astype(np.int64)
        lhs, rhs = m * gl, gm * ln
        better = (ln > 0) & ((gl == 0) | (lhs > rhs) | (
            (lhs == rhs) & ((m > gm) | ((m == gm) & (ln > gl)))))
        gm = np.where(better, m, gm)
        gl = np.where(better, ln, gl)
    return gm, gl


def groupmax_reduce(matches, full_len, ok, g_idx, n_groups):
    """Per-group best (matches, full_len) under the exact identity-fraction
    order (porechop_tpu/ops/engine_v2._groupmax_reduce).  The fraction key
    is float64, which orders distinct fractions with denominators below
    2^20 exactly and maps equal fractions to equal keys; among the lanes at
    the group max, the packed key matches * 4096 + full_len elects ONE lane
    (the max-matches lane, which under an exact tie is also the
    max-full_len lane), so the pair returned is one some lane produced.
    Groups with no ok lane return (0, 0).  Needs full_len < 4096."""
    dev = matches.device
    key = torch.where(ok, matches.to(torch.float64)
                      / full_len.clamp_min(1).to(torch.float64), -1.0)
    g = g_idx.to(torch.int64)
    seg = torch.full((n_groups + 1,), -1.0, dtype=torch.float64, device=dev)
    seg = seg.scatter_reduce(0, g, key, reduce='amax')
    lane_best = ok & (key == seg[g])
    slot = torch.where(lane_best, g, n_groups)
    k2 = matches.to(torch.int64) * 4096 + full_len.to(torch.int64)
    gk = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    gk = gk.scatter_reduce(0, slot, k2, reduce='amax')[:n_groups]
    return gk >> 12, gk & 4095


def group_scoremax_reduce(best, ok, g_idx, n_groups):
    """Per-group max best score; pad and failed lanes fold into a dummy
    slot (porechop_tpu/ops/engine_v2._group_scoremax_reduce)."""
    slot = torch.where(ok, g_idx.to(torch.int64), n_groups)
    gs = torch.full((n_groups + 1,), -2 ** 31 + 1, dtype=torch.int64,
                    device=best.device)
    gs = gs.scatter_reduce(0, slot, best.to(torch.int64), reduce='amax')
    return gs[:n_groups]


def _gather(wtab, wlens, atab, alens, w_idx, a_idx):
    """Device-side row fan-out from the deduplicated tables."""
    return (wtab.index_select(0, w_idx), wlens.index_select(0, w_idx),
            atab.index_select(0, a_idx), alens.index_select(0, a_idx))


def subwindow_table(wtab, cut, lens, width):
    """Sub-windows of the window table wtab's rows, on its device: row k
    holds lens[k] bases of row cut[0, k] from column cut[1, k], then N
    (code 4) to `width` columns.  A strided gather: every offset of a
    row is a view of it (unfold), so no window is copied from the host
    again."""
    padded = torch.nn.functional.pad(wtab, (0, width), value=4)
    sub = padded.unfold(1, width, 1)[cut[0], cut[1]]
    col = torch.arange(width, device=sub.device)
    return sub.masked_fill_(col >= lens[:, None], 4)


def stats_fwd(reads, rl, adps, al, scoring):
    """Per-lane (matches, full_len, ok) from the stat-carrying kernel."""
    _, _, _, mat, fl = kernels.forward_stats(reads, rl, adps, al, *scoring)
    return mat, fl, (rl > 0) & (al > 0) & (fl > 0)


def score_fwd(reads, rl, adps, al, scoring):
    """Per-lane (best_score, ok) from the score-only kernel."""
    best = kernels.forward_score(reads, rl, adps, al, *scoring)
    return best, (rl > 0) & (al > 0)


def gather_forward(wtab, wlens, atab, alens, w_idx, a_idx, scoring):
    """Gather + trace-bit forward and its walk, in one kernels.forward_walk
    call: (walk (B, 10), best, cell_i, cell_j), walk's aggregates as
    kernels.walk lists them.  One forward for every window length
    (porechop_tpu/ops/engine_v2 _pallas_mode's modes 1 and 2, with
    _traceback_impl)."""
    reads, rl, adps, al = _gather(wtab, wlens, atab, alens, w_idx, a_idx)
    return kernels.forward_walk(reads, rl, adps, al, *scoring)


def fused_gather_stats(wtab, wlens, atab, alens, w_idx, a_idx, scoring):
    """Gather + stats forward: per-lane (matches, full_len, ok)."""
    return stats_fwd(*_gather(wtab, wlens, atab, alens, w_idx, a_idx),
                     scoring)


def fused_gather_scores(wtab, wlens, atab, alens, w_idx, a_idx, scoring):
    """Gather + score-only forward: per-lane (best_score, ok)."""
    return score_fwd(*_gather(wtab, wlens, atab, alens, w_idx, a_idx),
                     scoring)


def fused_gather_groupmax(wtab, wlens, atab, alens, w_idx, a_idx, g_idx,
                          n_groups, scoring):
    """Gather + stats forward + per-group best fraction: (n_groups,) x 2."""
    mat, fl, ok = fused_gather_stats(wtab, wlens, atab, alens, w_idx, a_idx,
                                     scoring)
    return groupmax_reduce(mat, fl, ok, g_idx, n_groups)


def fused_gather_group_scoremax(wtab, wlens, atab, alens, w_idx, a_idx,
                                g_idx, n_groups, scoring):
    """Gather + score-only forward + per-group max score: (n_groups,)."""
    best, ok = fused_gather_scores(wtab, wlens, atab, alens, w_idx, a_idx,
                                   scoring)
    return group_scoremax_reduce(best, ok, g_idx, n_groups)
