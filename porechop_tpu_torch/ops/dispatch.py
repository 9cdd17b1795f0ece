"""Batch planner and engine dispatch.

Turns arbitrary collections of (window, adapter) alignment jobs into a small
number of dense, shape-bucketed device launches, then scatters results back
(counterpart of porechop_tpu/ops/dispatch.py).

Window lengths snap to a geometric ladder and adapters pad to their rung,
so launch shapes are stable across runs; launches are chunked to bound
device memory.  Every job runs on one device: the card unless the caller
asks for the CPU.  Which execution a job takes (group max, per-lane stats,
score only, or bitmap forward plus walk) depends on the mode and the shape,
never on the device; the device only decides whether the kernels or their
plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch

from . import engine_v2, kernels, spec

# Window-length ladder: fine-grained at the small end (end windows), then
# geometric.
_LADDER = [16, 32, 64, 96, 150, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
           4096, 6144, 8192, 10240, 12288, 16384, 24576, 32768, 49152,
           65536, 98304, 131072, 196608, 262144, 393216, 524288, 786432,
           1048576]

# Cap on B*L1*A DP cells per launch for the bitmap (walk) path: the trace
# bitmap is 1 byte per cell.  Bitless launches (group max, per-lane stats,
# score only) hold only the int8 inputs and a few int32 per lane.
_CELL_BUDGET = 2_000_000_000
_GM_CELL_BUDGET = 6_000_000_000
_MIN_LANES = 32

_A_LADDER = [16, 24, 32, 48, 64, 96, 128, 192, 256]


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: the card unless the caller asks for
    another one.  Raises when the card is asked for and there is none;
    there is no quiet fallback to the CPU."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           '(CLI: --device cpu) to run on the CPU')
    return dev


def _noop_progress(idxs):
    pass


def _bucket_len(n: int) -> int:
    for rung in _LADDER:
        if n <= rung:
            return rung
    return ((n + 65535) // 65536) * 65536


def _bucket_adapter_len(n: int) -> int:
    for rung in _A_LADDER:
        if n <= rung:
            return rung
    return ((n + 127) // 128) * 128


def _pow2_lanes(budget: int, lb: int, amax: int) -> int:
    """The largest power of two of lanes, at least _MIN_LANES, whose
    (lb + 1) x amax cells fit the budget."""
    per = max(_MIN_LANES, budget // ((lb + 1) * amax))
    return 1 << max(_MIN_LANES.bit_length() - 1, per.bit_length() - 1)


def bits_lanes(lb: int, amax: int) -> int:
    """Lanes per trace-bit launch at window rung lb and adapter rung amax:
    its bits (one byte per cell) under _CELL_BUDGET, and the walker's flat
    bit index lanes * L1p * A below 2^31."""
    per = _pow2_lanes(_CELL_BUDGET, lb, amax)
    l1p = kernels.tiled_l1p(lb)
    while per > _MIN_LANES and per * l1p * amax >= 2 ** 31:
        per //= 2
    return per


def _bucket_lanes(n: int) -> int:
    """Snap the batch (lane) count to a power of two so shrinking active
    sets reuse launch shapes."""
    b = _MIN_LANES
    while b < n:
        b *= 2
    return b


def seqan_pct_vec(matches: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized percent identity matching the reference's round trip
    through C++ std::to_string (6 decimals) and Python float().

    For values not adjacent to a .5 millionths boundary, banker's rounding of
    v*1e6 equals decimal rounding of v; the rare boundary cases are
    recomputed exactly through the string path.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    matches = np.asarray(matches, dtype=np.int64)
    v = np.where(lengths > 0, 100.0 * matches / np.maximum(lengths, 1), np.nan)
    scaled = v * 1e6
    out = np.round(scaled) / 1e6
    frac = scaled - np.floor(scaled)
    sus = np.abs(frac - 0.5) < 1e-6
    if np.any(sus):
        idx = np.nonzero(sus)[0]
        for k in idx:
            out[k] = spec.seqan_pct(int(matches[k]), int(lengths[k]))
    return out


def _host(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


class AlignJobs:
    """A flat list of alignment jobs over pre-encoded sequences.

    windows: list of np.int8 Dna5 code arrays (the read-side sequences).
    adapters: list of np.int8 code arrays.
    pairs: (P, 2) int array of (window_index, adapter_index).
    device: where the jobs run (default: the CUDA card; see resolve_device).
    """

    def __init__(self, windows, adapters, pairs, scoring=(3, -6, -5, -2),
                 device=None):
        self.windows = windows
        self.adapters = adapters
        self.pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        self.scoring = tuple(int(x) for x in scoring)
        self.device = resolve_device(device)
        self._group = None          # (group_ids, n_groups) in group-max mode
        self._gacc = None           # (n_groups, 2) int64 best (m, l)
        self._dev_grouped = None    # lanes already folded on device
        self._stats_only = False    # run_stats mode: no coordinate recovery
        self._stats_failed = None   # (P,) bool: device-stats lanes with ok=0
        self._score_only = False    # score-prefilter mode: raw score only
        self._score_lanes = None    # (P,) bool: lanes with score-only results
        self._gscore = None         # (group_ids, n_groups) group-score mode
        self._gsacc = None          # (n_groups,) int64 max-score fold

    # Window rungs above this bypass the device group max (its packed
    # election key needs full_len < 4096).
    _GROUP_MAX_RUNG = 1536

    def run_group_max(self, group_ids, n_groups, progress=None) -> dict:
        """Group-reduced execution: per group, the best exact identity
        fraction matches/full_len over its jobs (the detection phase's
        per-(adapter set, side) max, reference nanopore_read.py:155-164).
        Returns {'matches', 'full_len', 'full_pct'} of shape (n_groups,)."""
        group_ids = np.asarray(group_ids, dtype=np.int64)
        assert group_ids.shape == (len(self.pairs),)
        self._group = (group_ids, int(n_groups))
        # Baseline (0, 1) = 0.0 identity, matching align_adapter's failure
        # value (reference nanopore_read.py:481-485).
        self._gacc = np.zeros((n_groups, 2), dtype=np.int64)
        self._gacc[:, 1] = 1
        self._dev_grouped = np.zeros(len(self.pairs), dtype=bool)
        try:
            res = self.run(progress=progress)
        finally:
            group, self._group = self._group, None
            gacc, self._gacc = self._gacc, None
            dev_grouped, self._dev_grouped = self._dev_grouped, None
        # Fold the lanes of rungs past _GROUP_MAX_RUNG, which ran through
        # the full walk.  float64 keys order their fractions exactly.
        rest = np.nonzero(~dev_grouped)[0]
        if rest.size:
            m = res['matches'][rest]
            ln = res['full_len'][rest]
            ok = (res['read_start'][rest] != -1) & (ln > 0)
            g = group_ids[rest[ok]]
            key = m[ok] / ln[ok]
            seg = gacc[:, 0] / gacc[:, 1]
            np.maximum.at(seg, g, key)
            win = key == seg[g]
            best_m = np.zeros(n_groups, dtype=np.int64)
            np.maximum.at(best_m, g[win], m[ok][win])
            best_l = np.zeros(n_groups, dtype=np.int64)
            np.maximum.at(best_l, g[win], ln[ok][win])
            upd = best_m * gacc[:, 1] > gacc[:, 0] * best_l
            gacc[upd, 0] = best_m[upd]
            gacc[upd, 1] = best_l[upd]
        return {'matches': gacc[:, 0], 'full_len': gacc[:, 1],
                'full_pct': seqan_pct_vec(gacc[:, 0], gacc[:, 1])}

    def run_group_score_max(self, group_ids, n_groups, progress=None):
        """Per-group max raw score (the detection phase's prefilter pass):
        the score-only kernel plus an on-device group max.  Returns a
        (n_groups,) int64 array; groups whose every lane failed stay at the
        -2^31+1 floor."""
        group_ids = np.asarray(group_ids, dtype=np.int64)
        assert group_ids.shape == (len(self.pairs),)
        P = len(self.pairs)
        self._gscore = (group_ids, int(n_groups))
        self._score_only = True
        self._gsacc = np.full(n_groups, -2 ** 31 + 1, dtype=np.int64)
        self._score_lanes = np.zeros(P, dtype=bool)
        self._stats_failed = np.zeros(P, dtype=bool)
        self._dev_grouped = np.zeros(P, dtype=bool)
        try:
            res = self.run(progress=progress)
        finally:
            self._gscore = None
            self._score_only = False
            gsacc, self._gsacc = self._gsacc, None
            failed, self._stats_failed = self._stats_failed, None
            dev, self._dev_grouped = self._dev_grouped, None
            self._score_lanes = None
        rest = np.nonzero(~dev)[0]
        if rest.size:
            ok = (res['read_start'][rest] != -1) & ~failed[rest]
            np.maximum.at(gsacc, group_ids[rest[ok]],
                          res['raw_score'][rest[ok]])
        return gsacc

    def run_stats(self, progress=None, prefilter=None) -> dict:
        """Percent-identity-only execution: returns {'matches', 'full_len',
        'full_pct'} of shape (P,) and skips coordinate recovery entirely
        (the stat-carrying kernel: no trace bitmap, no walk).

        prefilter: optional identity threshold (percent).  When the caller
        only consumes `full_pct >= prefilter` (and the values of passing
        lanes), a score-only pass runs first; lanes whose best score is
        provably too low for the threshold (kernels.score_prefilter_coef)
        are rejected with full_pct = 0.0 and only the survivors re-run
        through the exact stats path.  Sub-threshold lanes' matches and
        full_len are NOT meaningful in this mode."""
        if prefilter is not None:
            match, mismatch, gap_open, gap_ext = self.scoring
            coef = kernels.score_prefilter_coef(prefilter, match, mismatch,
                                                gap_open, gap_ext)
            if coef > 0 and kernels.supports(self.scoring):
                return self._run_stats_prefiltered(coef, progress)
        self._stats_only = True
        self._stats_failed = np.zeros(len(self.pairs), dtype=bool)
        try:
            res = self.run(progress=progress)
        finally:
            self._stats_only = False
            failed, self._stats_failed = self._stats_failed, None
        # Degenerate lanes signal failure via read_start == -1
        # (align_adapter's zeros, reference nanopore_read.py:481-485);
        # device-stats lanes via the harvested ok flag.
        failed |= res['read_start'] == -1
        full_pct = seqan_pct_vec(res['matches'], res['full_len'])
        full_pct = np.where(failed | (res['full_len'] <= 0), 0.0, full_pct)
        return {'matches': res['matches'], 'full_len': res['full_len'],
                'full_pct': full_pct}

    def _run_stats_prefiltered(self, coef, progress) -> dict:
        """Score-prefiltered stats: one dense score-only pass over all
        pairs, then an exact stats pass over the (typically chimera-rate)
        survivors.  Soundness: a lane's best score below coef * adapter_len
        proves its full-span identity is below the threshold, so rejected
        lanes' full_pct = 0.0 compares identically against the threshold."""
        P = len(self.pairs)
        self._score_only = True
        self._score_lanes = np.zeros(P, dtype=bool)
        self._stats_failed = np.zeros(P, dtype=bool)
        try:
            res = self.run(progress=progress)
        finally:
            self._score_only = False
            score_lanes, self._score_lanes = self._score_lanes, None
            failed, self._stats_failed = self._stats_failed, None
        failed |= res['read_start'] == -1

        # Lanes that ran the full walk (rungs without a stats path) carry
        # full results already.
        host_pct = seqan_pct_vec(res['matches'], res['full_len'])
        host_ok = ~failed & (res['full_len'] > 0) & ~score_lanes
        full_pct = np.where(host_ok, host_pct, 0.0)
        matches = np.where(~score_lanes, res['matches'], 0)
        full_len = np.where(~score_lanes, np.maximum(res['full_len'], 1), 1)

        pa = np.array([len(a) for a in self.adapters],
                      dtype=np.int64)[self.pairs[:, 1]]
        cand = (score_lanes & ~failed
                & (res['raw_score'].astype(np.float64) >= coef * pa))
        if cand.any():
            idx = np.nonzero(cand)[0]
            sub = AlignJobs(self.windows, self.adapters, self.pairs[idx],
                            self.scoring, device=self.device)
            sres = sub.run_stats()          # exact, no prefilter
            matches[idx] = sres['matches']
            full_len[idx] = sres['full_len']
            full_pct[idx] = sres['full_pct']
        return {'matches': matches, 'full_len': full_len,
                'full_pct': full_pct}

    def run(self, progress=None) -> dict:
        """Executes all jobs; returns dict of (P,) arrays:
        read_start, read_end_excl, full_pct, partial_pct, plus the raw
        integer fields (matches, aligned_len, full_len, raw_score,
        read_end_incl, adapter_start, adapter_end).

        progress: optional callable(job_indices) invoked as groups of jobs
        resolve (degenerate fixes, each chunk harvest)."""
        if progress is None:
            progress = _noop_progress
        P = len(self.pairs)
        fields = ('read_start', 'read_end', 'adapter_start', 'adapter_end',
                  'raw_score', 'matches', 'aligned_len', 'full_len')
        out = {f: np.zeros(P, dtype=np.int64) for f in fields}
        if P == 0:
            return self._package(out)

        wlens = np.array([len(w) for w in self.windows], dtype=np.int64)
        alens = np.array([len(a) for a in self.adapters], dtype=np.int64)
        pw = wlens[self.pairs[:, 0]]
        pa = alens[self.pairs[:, 1]]

        # Degenerate jobs (empty window or adapter) resolve host-side.
        degenerate = (pw == 0) | (pa == 0)
        if degenerate.any():
            out['read_start'][degenerate] = -1
            out['raw_score'][degenerate] = -(2 ** 31)
            progress(np.nonzero(degenerate)[0])

        todo = np.nonzero(~degenerate)[0]
        if todo.size == 0:
            return self._package(out)
        if not kernels.supports(self.scoring):
            raise NotImplementedError(
                'scoring scheme %s: the kernels need gap_open < gap_ext '
                '(a host engine for other schemes is not ported yet)'
                % (self.scoring,))

        # Bucket by (window rung, adapter rung): adapters pad to the rung,
        # not the batch max, so launch shapes are stable across runs.
        # Radix sort over rung indices (the pair is a point on a tiny grid).
        lad = np.asarray(_LADDER, dtype=np.int64)
        wi = np.searchsorted(lad, pw[todo], side='left')
        lbv = np.where(wi < len(lad), lad[np.minimum(wi, len(lad) - 1)],
                       ((pw[todo] + 65535) // 65536) * 65536)
        alad = np.asarray(_A_LADDER, dtype=np.int64)
        ai = np.searchsorted(alad, pa[todo], side='left')
        amv = np.where(ai < len(alad), alad[np.minimum(ai, len(alad) - 1)],
                       ((pa[todo] + 127) // 128) * 128)
        Ga = len(alad) + 1
        comb = wi * Ga + ai
        over = (wi >= len(lad)) | (ai >= len(alad))
        if over.any():
            okey = lbv[over] * (1 << 20) + amv[over]
            _, oinv = np.unique(okey, return_inverse=True)
            comb[over] = (len(lad) + 1) * Ga + oinv
        order = np.argsort(comb, kind='stable')
        sc = comb[order]
        cut = np.nonzero(np.diff(sc))[0] + 1
        starts = np.concatenate((np.zeros(1, np.int64), cut))
        ends = np.concatenate((cut, np.asarray([len(sc)], np.int64)))
        todo_ord = todo[order]
        buckets = {(int(lbv[order][s]), int(amv[order][s])): todo_ord[s:e]
                   for s, e in zip(starts, ends)}

        device_work = []  # (lb, amax, chunk) launches
        for (lb, amax), idxs in sorted(buckets.items()):
            for chunk in self._chunk_split(np.asarray(idxs), lb, amax):
                device_work.append((lb, amax, chunk))

        # Per-rung job index lists, so table uploads dedup across buckets
        # sharing a rung.
        rung_w = {}
        rung_a = {}
        for lb, amax, chunk in device_work:
            rung_w.setdefault(lb, []).append(chunk)
            rung_a.setdefault(amax, []).append(chunk)

        # Enqueue every launch before touching results: CUDA launches are
        # asynchronous, so they run back to back while the host moves on.
        tables = {'w': {}, 'a': {}}
        pending = [(chunk, self._launch_chunk(chunk, lb, amax, tables,
                                              rung_w, rung_a))
                   for lb, amax, chunk in device_work]
        for chunk, h in pending:
            self._harvest(chunk, h, out)
            progress(chunk)
        return self._package(out)

    def _is_groupmax_rung(self, lb) -> bool:
        """Chunks of this window rung launch through the group max."""
        return self._group is not None and lb <= self._GROUP_MAX_RUNG

    def _is_stats_rung(self, lb) -> bool:
        """Chunks of this window rung launch through the per-lane stats
        kernel (run_stats mode) or the score-only kernel (prefilter mode)
        while L + 1 <= MAX_L1P; longer rungs run the trace-bit forward and
        the walk, the JAX package's route (engine_v2.stats_mode_ok)."""
        return ((self._stats_only or self._score_only)
                and lb + 1 <= kernels.MAX_L1P)

    def _per_launch(self, lb, amax):
        """Power-of-two chunk width: bitless rungs under the larger cell
        budget, trace-bit rungs as bits_lanes allows."""
        if self._is_groupmax_rung(lb) or self._is_stats_rung(lb):
            return _pow2_lanes(_GM_CELL_BUDGET, lb, amax)
        return bits_lanes(lb, amax)

    def _chunk_split(self, idxs, lb, amax):
        per_launch = self._per_launch(lb, amax)
        for lo in range(0, len(idxs), per_launch):
            yield idxs[lo:lo + per_launch]

    def _table(self, seqs, idxs, width):
        """Deduplicated table of the sequences `idxs` reference, plus one
        dummy row (a single 'A') that pad lanes use: (rows, lens) on the
        device, the host lens, and the map from sequence index to row."""
        seen = np.zeros(len(seqs), dtype=bool)
        seen[idxs] = True
        uniq = np.nonzero(seen)[0]
        mat = np.full((len(uniq) + 1, width), 4, dtype=np.int8)
        lens = np.ones(len(uniq) + 1, dtype=np.int32)
        for r, k in enumerate(uniq):
            s = seqs[k]
            mat[r, :len(s)] = s
            lens[r] = len(s)
        mat[len(uniq), 0] = 0
        row_of = np.full(len(seqs), len(uniq), dtype=np.int64)
        row_of[uniq] = np.arange(len(uniq), dtype=np.int64)
        dev = self.device
        return (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                lens, row_of)

    def _launch_chunk(self, chunk, lb, amax, tables, rung_w, rung_a):
        """Enqueues one chunk: the dedup'd window and adapter tables upload
        once per rung (shared by every chunk of the rung) and each lane is a
        pair of row indices gathered on the device.  Returns a handle for
        _harvest."""
        if lb not in tables['w']:
            tables['w'][lb] = self._table(
                self.windows, self.pairs[np.concatenate(rung_w[lb]), 0], lb)
        if amax not in tables['a']:
            tables['a'][amax] = self._table(
                self.adapters, self.pairs[np.concatenate(rung_a[amax]), 1],
                amax)
        wtab, wlen, wlen_host, wmap = tables['w'][lb]
        atab, alen, alen_host, amap = tables['a'][amax]
        B = len(chunk)
        Bp = _bucket_lanes(B)
        w_idx = np.full(Bp, wtab.shape[0] - 1, dtype=np.int64)
        a_idx = np.full(Bp, atab.shape[0] - 1, dtype=np.int64)
        w_idx[:B] = wmap[self.pairs[chunk, 0]]
        a_idx[:B] = amap[self.pairs[chunk, 1]]
        dev = self.device
        tabs = (wtab, wlen, atab, alen, torch.from_numpy(w_idx).to(dev),
                torch.from_numpy(a_idx).to(dev))

        if self._is_groupmax_rung(lb):
            group_ids, n_groups = self._group
            g_idx = np.full(Bp, n_groups, dtype=np.int64)  # pad -> dummy
            g_idx[:B] = group_ids[chunk]
            return ('gm', engine_v2.fused_gather_groupmax(
                *tabs, torch.from_numpy(g_idx).to(dev), n_groups,
                self.scoring))
        if self._is_stats_rung(lb):
            if self._gscore is not None:
                gids, n_groups = self._gscore
                g_idx = np.full(Bp, n_groups, dtype=np.int64)
                g_idx[:B] = gids[chunk]
                return ('gsc', engine_v2.fused_gather_group_scoremax(
                    *tabs, torch.from_numpy(g_idx).to(dev), n_groups,
                    self.scoring))
            if self._score_only:
                return ('sc', engine_v2.fused_gather_scores(*tabs,
                                                            self.scoring))
            return ('st', engine_v2.fused_gather_stats(*tabs, self.scoring))
        walk, best, ci, cj = engine_v2.fused_gather(*tabs, self.scoring)
        return ('res', (walk, best, ci, cj, wlen_host[w_idx],
                        alen_host[a_idx]))

    def _harvest(self, chunk, handle, out):
        """Blocks on a _launch_chunk handle and scatters results."""
        kind, h = handle
        B = len(chunk)
        if kind == 'gm':
            gm, gl = _host(h[0]), _host(h[1])
            better = gm * self._gacc[:, 1] > self._gacc[:, 0] * gl
            self._gacc[better, 0] = gm[better]
            self._gacc[better, 1] = gl[better]
            self._dev_grouped[chunk] = True
            return
        if kind == 'st':
            out['matches'][chunk] = _host(h[0])[:B]
            out['full_len'][chunk] = _host(h[1])[:B]
            self._stats_failed[chunk] = ~h[2].cpu().numpy()[:B]
            return
        if kind == 'sc':
            out['raw_score'][chunk] = _host(h[0])[:B]
            self._stats_failed[chunk] = ~h[1].cpu().numpy()[:B]
            self._score_lanes[chunk] = True
            return
        if kind == 'gsc':
            np.maximum(self._gsacc, _host(h), out=self._gsacc)
            self._dev_grouped[chunk] = True
            return
        walk, best, ci, cj, rl, al = h
        res = engine_v2.finish_v2(walk.cpu().numpy(), best.cpu().numpy(),
                                  ci.cpu().numpy(), cj.cpu().numpy(), rl, al)
        for f in out:
            out[f][chunk] = res[f][:B]

    def _package(self, out):
        if self._group is not None or self._stats_only or self._score_only:
            # Group-max / stats mode: the consumers read the raw integer
            # fields only.
            return dict(out)
        full_pct = seqan_pct_vec(out['matches'], out['full_len'])
        partial_pct = seqan_pct_vec(out['matches'], out['aligned_len'])
        failed = out['read_start'] == -1
        # align_adapter (reference nanopore_read.py:476-491): failure ->
        # zeros; read_end becomes exclusive via +1 otherwise.
        full_pct = np.where(failed, 0.0, full_pct)
        partial_pct = np.where(failed, 0.0, partial_pct)
        read_end_excl = np.where(failed, 0, out['read_end'] + 1)
        result = dict(out)
        result['full_pct'] = full_pct
        result['partial_pct'] = partial_pct
        result['read_end_excl'] = read_end_excl
        return result
