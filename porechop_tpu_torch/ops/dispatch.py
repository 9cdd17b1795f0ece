"""Batch planner and engine dispatch.

Turns arbitrary collections of (window, adapter) alignment jobs into a small
number of dense, shape-bucketed device launches, then scatters results back
(counterpart of porechop_tpu/ops/dispatch.py).

Window lengths snap to a geometric ladder and adapters pad to their rung,
so launch shapes are stable across runs; launches are chunked to bound
device memory.

The route is chosen by the scoring scheme and PORECHOP_TPU_FORCE_HOST
alone:
- gap_open < gap_ext (kernels.supports): the DP kernels, on the device
  entries the caller names (default the card);
- any other scheme, or every scheme under PORECHOP_TPU_FORCE_HOST (which
  touches no CUDA device), the host route (_host_batch): the native Gotoh
  engine (porechop_tpu_torch/native) in one threaded batch call where
  gap_open != gap_ext, the executable spec (spec.align_linear) one job at
  a time where gap_open == gap_ext.
PORECHOP_TPU_TIMING=1 prints the planner's `[timing]` lines on stderr, in
the JAX package's words: prefilter survivors, launches enqueued and
harvested (padded cells/s) and native batches; inside a CLI job it also
records the planner's spans (utils/spans.py: `plan` around the public
run methods, `host_route`, `upload` and, through mesh.launch_lanes,
`enqueue`; `wait` at every copy back) and counts a product's lanes
(`planner.product_lanes`).
Which kernel execution a job takes (group max, per-lane stats, score only,
or bitmap forward plus walk) depends on the mode and the shape; the device
only decides whether the kernels or their plain versions run.

Device entries (resolve_devices): each launch's padded lanes split,
contiguous and as even as possible, over the entries (parallel/mesh.py
launch_shards), which may name one device more than once.  The tables are
held once per (rung, device); every entry's launch (for trace bits, the
forward and its walk in one kernels.forward_walk call) is enqueued before
any is harvested, and the shards are harvested in order, so the results
are those of one entry.

A Product of jobs (the detection phase's check reads x adapter-set
sides) runs the group modes axis by axis: the same launches as its flat
pairs, but its tables and axes go to the devices once and each launch
computes its lane indices there (mesh.launch_lanes), so no per-pair
array is built, sorted or uploaded.  The host route, the other modes and
rungs past the group kernels take its flat pairs.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import native
from ..parallel import mesh
from ..utils import spans
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

# Jobs and padded cells per route since reset_routes(): 'device' (kernel
# launches, padded lanes) and 'host' (schemes the kernels refuse,
# PORECHOP_TPU_FORCE_HOST: jobs at their rungs' cells).
ROUTES = {'device': [0, 0], 'host': [0, 0]}


def reset_routes() -> None:
    for v in ROUTES.values():
        v[:] = [0, 0]


def timing() -> bool:
    """PORECHOP_TPU_TIMING (any value), read at each use: the CLI's phase
    walls and the planner's `[timing]` lines on stderr."""
    return bool(os.environ.get('PORECHOP_TPU_TIMING'))


def _timing_line(text):
    print('[timing] ' + text, file=sys.stderr, flush=True)


def force_host() -> bool:
    """PORECHOP_TPU_FORCE_HOST (any value): every job runs on the host
    engine and no CUDA device is resolved or touched."""
    return bool(os.environ.get('PORECHOP_TPU_FORCE_HOST'))


def score_path_available(scoring=(3, -6, -5, -2)) -> bool:
    """Whether a walk-free score-only execution exists for this scheme
    (porechop_tpu/ops/dispatch.py:99-109): the score kernel, or under
    PORECHOP_TPU_FORCE_HOST the native engine's score-only entry point."""
    if not force_host():
        return kernels.supports(scoring)
    _, _, gap_open, gap_ext = (int(x) for x in scoring)
    return gap_open != gap_ext


def stats_path_active(scoring=(3, -6, -5, -2), prefilter=None) -> bool:
    """Whether AlignJobs.run_stats routes bulk work through a cheaper
    stats or score execution than the full run
    (porechop_tpu/ops/dispatch.py:112-134).  On the device entries the
    bitless kernels skip the trace bits and the walk, so it always pays.
    Under PORECHOP_TPU_FORCE_HOST a plain stats pass costs the native
    engine a full run, so it pays only with a non-vacuous `prefilter`
    threshold and the native score-only entry point."""
    if not force_host():
        return kernels.supports(scoring)
    if prefilter is None:
        return False
    if kernels.score_prefilter_coef(prefilter, *scoring) <= 0:
        return False
    return score_path_available(scoring)


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: the card unless the caller asks for
    another one.  Raises when the card is asked for and there is none;
    there is no quiet fallback to the CPU.  Under PORECHOP_TPU_FORCE_HOST
    nothing runs on it, so it is named and not checked."""
    dev = torch.device('cuda' if device is None else device)
    if force_host():
        return dev
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           '(CLI: --device cpu) to run on the CPU')
    if (dev.type == 'cuda' and dev.index is not None
            and dev.index >= torch.cuda.device_count()):
        raise RuntimeError('%s: this host has %d CUDA devices'
                           % (dev, torch.cuda.device_count()))
    return dev


def resolve_devices(device=None) -> list:
    """The device entries launches split over: one device (a torch.device
    or its name; default the card), a comma-separated list of names
    ('cuda:0,cuda:1') or a sequence of either.  An entry may repeat
    ('cpu,cpu', 'cuda:0,cuda:0'): each entry takes its share of every
    launch's lanes all the same."""
    if device is None or isinstance(device, torch.device):
        names = [device]
    elif isinstance(device, str):
        names = device.split(',')
    else:
        names = list(device)
    if not names:
        raise ValueError('no device named')
    return [resolve_device(n.strip() if isinstance(n, str) else n)
            for n in names]


def _noop_progress(*resolved):
    pass


def bucket_len(n: int) -> int:
    """The window rung of length n: the least _LADDER rung that holds it,
    past the ladder the next multiple of 65,536."""
    for rung in _LADDER:
        if n <= rung:
            return rung
    return ((n + 65535) // 65536) * 65536


def bucket_adapter_len(n: int) -> int:
    """The adapter rung of length n: the least _A_LADDER rung that holds
    it, past the ladder the next multiple of 128."""
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
    its bits (one byte per cell) under _CELL_BUDGET, and lanes * L1p * A
    below 2^31, the JAX package's bound for its walker's int32 flat index
    (the port's walk indexes in 64 bits; the bound keeps the launch
    shapes, and with them the launch counts, the JAX package's)."""
    per = _pow2_lanes(_CELL_BUDGET, lb, amax)
    l1p = kernels.tiled_l1p(lb)
    while per > _MIN_LANES and per * l1p * amax >= 2 ** 31:
        per //= 2
    return per


def bucket_lanes(n: int) -> int:
    """Snap the batch (lane) count to a power of two so shrinking active
    sets reuse launch shapes."""
    b = _MIN_LANES
    while b < n:
        b *= 2
    return b


def _pad_cells(lb: int, amax: int, n: int) -> int:
    """Padded DP cells of an n-lane launch at rungs (lb, amax)."""
    return bucket_lanes(n) * (lb + 1) * amax if n else 0


def _buckets(todo, pw, pa) -> dict:
    """{(window rung, adapter rung): job indices} of the jobs `todo`
    (window lengths pw, adapter lengths pa): adapters pad to their rung,
    not the batch max, so launch shapes are stable across runs.  A radix
    sort over rung indices (the pair is a point on a tiny grid)."""
    lad = np.asarray(_LADDER, dtype=np.int64)
    wi = np.searchsorted(lad, pw, side='left')
    lbv = np.where(wi < len(lad), lad[np.minimum(wi, len(lad) - 1)],
                   ((pw + 65535) // 65536) * 65536)
    alad = np.asarray(_A_LADDER, dtype=np.int64)
    ai = np.searchsorted(alad, pa, side='left')
    amv = np.where(ai < len(alad), alad[np.minimum(ai, len(alad) - 1)],
                   ((pa + 127) // 128) * 128)
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
    return {(int(lbv[order][s]), int(amv[order][s])): todo_ord[s:e]
            for s, e in zip(starts, ends)}


def _named(seqs, idx):
    """The sequences of `seqs` that the indices idx name, as a list of
    their own, and idx mapped into it."""
    named = np.zeros(len(seqs), dtype=bool)
    named[idx] = True
    used = np.nonzero(named)[0]
    row = np.zeros(len(seqs), dtype=np.int64)
    row[used] = np.arange(len(used))
    return [seqs[k] for k in used], row[idx]


class Product:
    """A full product of alignment jobs, held axis by axis: every row
    against every column.  Row r holds one window per side
    (row_windows[r, s], window indices); column c names a side
    (col_side[c]), an adapter (col_adapter[c]) and a group
    (col_group[c]).  Job r * C + c of its C columns (read-major) aligns
    window row_windows[r, col_side[c]] against adapter col_adapter[c] in
    group col_group[c]: pairs() and group_ids() are those flat jobs."""

    def __init__(self, row_windows, col_side, col_adapter, col_group):
        self.row_windows = np.asarray(row_windows, dtype=np.int64)
        self.col_side = np.asarray(col_side, dtype=np.int64)
        self.col_adapter = np.asarray(col_adapter, dtype=np.int64)
        self.col_group = np.asarray(col_group, dtype=np.int64)

    def pairs(self) -> np.ndarray:
        return np.column_stack((
            self.row_windows[:, self.col_side].ravel(),
            np.tile(self.col_adapter, len(self.row_windows))))

    def group_ids(self) -> np.ndarray:
        return np.tile(self.col_group, len(self.row_windows))

    def columns(self, keep) -> 'Product':
        """The same rows against the columns `keep` (a mask or indices)."""
        return Product(self.row_windows, self.col_side[keep],
                       self.col_adapter[keep], self.col_group[keep])


def _rungs(lens, rung_of) -> np.ndarray:
    """rung_of (bucket_len, bucket_adapter_len) of every length."""
    u, inv = np.unique(lens, return_inverse=True)
    return np.array([rung_of(int(n)) for n in u], dtype=np.int64)[inv]


def _rows_table(seqs, width):
    """seqs as table rows of `width` codes, N (4) past each length, and
    one dummy row (a single 'A') that pad lanes use: (rows, lens) as host
    tensors, filled in one step from the sequences joined."""
    lens = np.ones(len(seqs) + 1, dtype=np.int32)
    lens[:-1] = [len(s) for s in seqs]
    mat = np.full((len(seqs) + 1, width), 4, dtype=np.int8)
    mat[np.arange(width) < lens[:, None]] = np.concatenate(
        list(seqs) + [np.zeros(1, dtype=np.int8)])
    return torch.from_numpy(mat), torch.from_numpy(lens)


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


def _cpu(t) -> torch.Tensor:
    """t copied to the host, which waits for the card's work that makes
    it."""
    with spans.span('wait'):
        return t.cpu()


def _host(t) -> np.ndarray:
    return _cpu(t).numpy().astype(np.int64)


class AlignJobs:
    """A flat list of alignment jobs over pre-encoded sequences.

    windows: list of np.int8 Dna5 code arrays (the read-side sequences).
    adapters: list of np.int8 code arrays.
    pairs: (P, 2) int array of (window_index, adapter_index), or a
    Product of them, which the group modes run axis by axis where they
    can (_product_lens) and every other route takes as its flat pairs.
    device: the device entries the kernels' launches split over (default:
    the CUDA card; see resolve_devices).
    """

    def __init__(self, windows, adapters, pairs, scoring=(3, -6, -5, -2),
                 device=None):
        self.windows = windows
        self.adapters = adapters
        if isinstance(pairs, Product):
            self.product, self._pairs = pairs, None
        else:
            self.product = None
            self._pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        self.scoring = tuple(int(x) for x in scoring)
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self._group = None          # (group_ids, n_groups) in group-max mode
        self._gacc = None           # (n_groups, 2) int64 best (m, l)
        self._dev_grouped = None    # lanes already folded on device
        self._stats_only = False    # run_stats mode: no coordinate recovery
        self._stats_failed = None   # (P,) bool: device-stats lanes with ok=0
        self._score_only = False    # score-prefilter mode: raw score only
        self._score_lanes = None    # (P,) bool: lanes with score-only results
        self._gscore = None         # (group_ids, n_groups) group-score mode
        self._gsacc = None          # (n_groups,) int64 max-score fold

    @property
    def pairs(self) -> np.ndarray:
        """The (P, 2) flat jobs; a product's are made at first use."""
        if self._pairs is None:
            self._pairs = self.product.pairs()
        return self._pairs

    # Window rungs above this bypass the device group max (its packed
    # election key needs full_len < 4096).
    _GROUP_MAX_RUNG = 1536

    def _group_ids(self, group_ids):
        if group_ids is None:
            group_ids = self.product.group_ids()
        return np.asarray(group_ids, dtype=np.int64)

    @spans.timed('plan')
    def run_group_max(self, group_ids, n_groups, progress=None) -> dict:
        """Group-reduced execution: per group, the best exact identity
        fraction matches/full_len over its jobs (the detection phase's
        per-(adapter set, side) max, reference nanopore_read.py:155-164).
        Returns {'matches', 'full_len', 'full_pct'} of shape (n_groups,).
        A product takes its columns' groups (group_ids None); where it
        runs axis by axis, progress(rows, counts) is told how many of each
        row's jobs resolved, in place of progress(job_indices)."""
        row_len = (None if self.product is None
                   else self._product_lens(self._GROUP_MAX_RUNG))
        if row_len is not None:
            gacc = self._run_product('gm', n_groups, progress, row_len)
            return {'matches': gacc[:, 0], 'full_len': gacc[:, 1],
                    'full_pct': seqan_pct_vec(gacc[:, 0], gacc[:, 1])}
        group_ids = self._group_ids(group_ids)
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

    @spans.timed('plan')
    def run_group_score_max(self, group_ids, n_groups, progress=None):
        """Per-group max raw score (the detection phase's prefilter pass):
        the score-only kernel plus an on-device group max.  Returns a
        (n_groups,) int64 array; groups whose every lane failed stay at the
        -2^31+1 floor.  A product as run_group_max's."""
        row_len = (None if self.product is None
                   else self._product_lens(kernels.MAX_L1P - 1))
        if row_len is not None:
            return self._run_product('gsc', n_groups, progress, row_len)
        group_ids = self._group_ids(group_ids)
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

    @spans.timed('plan')
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
            if coef > 0 and score_path_available(self.scoring):
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

        # Lanes that ran a full alignment (the native engine's full entry
        # point, rungs without a stats path) carry full results already.
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
                            self.scoring, device=self.devices)
            sres = sub.run_stats()          # exact, no prefilter
            matches[idx] = sres['matches']
            full_len[idx] = sres['full_len']
            full_pct[idx] = sres['full_pct']
        if timing():
            _timing_line('score prefilter: %d/%d lanes survived '
                         '(%d full-result lanes)'
                         % (int(cand.sum()), P, int((~score_lanes).sum())))
        return {'matches': matches, 'full_len': full_len,
                'full_pct': full_pct}

    @spans.timed('plan')
    def run(self, progress=None) -> dict:
        """Executes all jobs; returns dict of (P,) arrays:
        read_start, read_end_excl, full_pct, partial_pct, plus the raw
        integer fields (matches, aligned_len, full_len, raw_score,
        read_end_incl, adapter_start, adapter_end).

        progress: optional callable(job_indices) invoked as groups of jobs
        resolve (degenerate fixes, each chunk harvest, the host batch)."""
        progress = spans.outside(_noop_progress if progress is None
                                 else progress)
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
        buckets = _buckets(todo, pw[todo], pa[todo])
        if force_host() or not kernels.supports(self.scoring):
            self._count('host', [(lb, amax, c)
                                 for (lb, amax), c in buckets.items()])
            self._scatter_host(todo, self._host_batch(todo), out)
            progress(todo)
            return self._package(out)

        work = [(lb, amax, chunk)
                for (lb, amax), idxs in sorted(buckets.items())
                for chunk in self._chunk_split(np.asarray(idxs), lb, amax)]
        self._count('device', work, padded=True)
        # Per-rung job index lists, so table uploads dedup across buckets
        # sharing a rung.
        rung_w = {}
        rung_a = {}
        for lb, amax, chunk in work:
            rung_w.setdefault(lb, []).append(chunk)
            rung_a.setdefault(amax, []).append(chunk)
        tables = {}

        def launch(lb, amax, chunk):
            return self._launch_chunk(chunk, lb, amax, tables, rung_w, rung_a)

        def harvest(lb, amax, chunk, handle):
            self._harvest(chunk, handle, out)
            progress(chunk)
        # CUDA launches are asynchronous: every launch is enqueued before
        # any harvest, so they run back to back while the host moves on.
        self._launch_all(work, launch, harvest)
        return self._package(out)

    @staticmethod
    def _launch_all(work, launch, harvest):
        """Enqueues every (lb, amax, chunk) launch of `work`
        (launch(lb, amax, chunk) returns its handle), then harvests them in
        order (harvest(lb, amax, chunk, handle)), with the planner's
        `[timing]` lines."""
        t0 = time.perf_counter()
        pending = [launch(lb, amax, chunk) for lb, amax, chunk in work]
        if timing() and work:
            _timing_line('enqueued %d launches in %.3fs'
                         % (len(work), time.perf_counter() - t0))
        # The JAX package starts every harvest's device-to-host copies
        # here (copy_to_host_async) and notes their failures under the
        # switch; the port's harvest copies each result when it reads it,
        # so it has no such step and no such line.
        t0 = time.perf_counter()
        for (lb, amax, chunk), handle in zip(work, pending):
            harvest(lb, amax, chunk, handle)
        if timing() and pending:
            dt = time.perf_counter() - t0
            cells = sum(_pad_cells(lb, amax, len(c)) for lb, amax, c in work)
            _timing_line('harvested %d launches in %.3fs (%.2e cells/s '
                         'incl. enqueue-overlap)'
                         % (len(pending), dt, cells / max(dt, 1e-9)))

    def _product_lens(self, max_rung):
        """Each product row's window length where the product runs axis by
        axis, else None: on the kernels (not the host route), with each
        row's windows of one length (its jobs share a rung) and no window
        rung past max_rung."""
        if force_host() or not kernels.supports(self.scoring):
            return None
        rw = self.product.row_windows
        wl = np.array([len(self.windows[k]) for k in rw.ravel()],
                      dtype=np.int64).reshape(rw.shape)
        if (wl != wl[:, :1]).any() or (
                wl.size and bucket_len(int(wl.max())) > max_rung):
            return None
        return wl[:, 0] if rw.shape[1] else np.zeros(len(rw), np.int64)

    def _run_product(self, kind, n_groups, progress, row_len):
        """The product's jobs axis by axis, kind 'gm' (run_group_max:
        returns the (n_groups, 2) best (matches, full_len)) or 'gsc'
        (run_group_score_max: the (n_groups,) max scores); row_len from
        _product_lens.  Each (window rung, adapter rung) cell of the grid,
        in the order of sorted(_buckets), is the product of its rows and
        columns, split into launches of _per_launch lanes as contiguous
        ranges of its read-major flattening: the lanes, launches and
        padding of the flat pairs' stable bucketing.  The tables and the
        axes (each column's side, adapter row and group) go to each device
        once, before the first launch, and each launch computes its lane
        indices there (_launch_product)."""
        prod = self.product
        progress = spans.outside(_noop_progress if progress is None
                                 else progress)
        S, C = prod.row_windows.shape[1], len(prod.col_side)
        col_len = np.array([len(self.adapters[a]) for a in prod.col_adapter],
                           dtype=np.int64)
        # Degenerate jobs (an empty window or adapter) resolve at once.
        dead = np.where(row_len > 0, int((col_len == 0).sum()), C)
        if dead.any():
            progress(np.nonzero(dead)[0], dead[dead > 0])
        live_r = np.nonzero(row_len > 0)[0]
        live_c = np.nonzero(col_len > 0)[0]
        rung_r = _rungs(row_len[live_r], bucket_len)
        rung_c = _rungs(col_len[live_c], bucket_adapter_len)
        rows = {int(lb): live_r[rung_r == lb] for lb in np.unique(rung_r)}
        cols = {int(am): live_c[rung_c == am] for am in np.unique(rung_c)}

        host = {}
        for lb, rs in rows.items():
            host[('w', lb)] = _rows_table(
                [self.windows[k] for k in prod.row_windows[rs].ravel()], lb)
        for amax, cs in cols.items():
            uniq, arow = np.unique(prod.col_adapter[cs], return_inverse=True)
            axes = np.stack((prod.col_side[cs], arow, prod.col_group[cs]))
            host[('a', amax)] = (*_rows_table(
                [self.adapters[k] for k in uniq], amax),
                torch.from_numpy(np.ascontiguousarray(axes)))
        tables = {}
        for dev in self.devices:
            if dev not in tables:
                with spans.upload(dev):
                    tables[dev] = {key: tuple(t.to(dev) for t in val)
                                   for key, val in host.items()}

        def launch(lb, amax, lanes):
            spans.count('planner.product_lanes', len(lanes))
            return self._launch_product(kind, n_groups, tables, lb, amax, S,
                                        row_len[rows[lb]],
                                        col_len[cols[amax]], lanes)

        def harvest(lb, amax, lanes, shards):
            self._fold(kind, shards)
            E = len(cols[amax])
            r = np.arange(lanes.start // E, (lanes.stop - 1) // E + 1)
            progress(rows[lb][r], np.minimum(lanes.stop, (r + 1) * E)
                     - np.maximum(lanes.start, r * E))

        if kind == 'gm':
            self._group = (None, int(n_groups))
            self._gacc = np.zeros((n_groups, 2), dtype=np.int64)
            self._gacc[:, 1] = 1
        else:
            self._score_only = True
            self._gscore = (None, int(n_groups))
            self._gsacc = np.full(n_groups, -2 ** 31 + 1, dtype=np.int64)
        try:
            # A chunk is a range of the cell's flat lane numbers.
            work = []
            for lb in sorted(rows):
                for amax in sorted(cols):
                    n = len(rows[lb]) * len(cols[amax])
                    per = self._per_launch(lb, amax)
                    work += [(lb, amax, range(c0, min(c0 + per, n)))
                             for c0 in range(0, n, per)]
            self._count('device', work, padded=True)
            self._launch_all(work, launch, harvest)
        finally:
            self._group = self._gscore = None
            self._score_only = False
            gacc, self._gacc = self._gacc, None
            gsacc, self._gsacc = self._gsacc, None
        return gacc if kind == 'gm' else gsacc

    def _launch_product(self, kind, n_groups, tables, lb, amax, S, w_len,
                        a_len, lanes):
        """Enqueues the range `lanes` of a grid cell's flat lanes (rows at
        window rung lb with lengths w_len, columns at adapter rung amax
        with lengths a_len), padded to a power of two, split over the
        device entries.  Lane f is row f // E and column f % E of the
        cell's E columns: on each device its window row (S per row, then
        the column's side), adapter row and group come from the lane
        number and the axes there, and pad lanes take the dummy rows and
        group n_groups.  The needed cells of a range of lanes come from
        the axes' prefix sums."""
        E, c0, B = len(a_len), lanes.start, len(lanes)
        W = np.append(w_len, 0)
        pre_w = np.concatenate(([0], np.cumsum(W)))
        pre_a = np.concatenate(([0], np.cumsum(a_len)))

        def cells(k):
            """Needed cells of the cell's lanes before c0 + min(k, B)."""
            i, j = divmod(c0 + min(k, B), E)
            return int(pre_w[i] * pre_a[-1] + W[i] * pre_a[j])

        def shard(dev, lo, hi):
            wtab, wlen = tables[dev][('w', lb)]
            atab, alen, axes = tables[dev][('a', amax)]
            f = torch.arange(c0 + lo, c0 + hi, device=dev)
            i = torch.div(f, E, rounding_mode='floor')
            side, arow, grp = axes[:, f - i * E]
            pad = f >= c0 + B
            idx = (torch.where(pad, wtab.shape[0] - 1, i * S + side),
                   torch.where(pad, atab.shape[0] - 1, arow))
            if kind in ('gm', 'gsc'):
                idx += (torch.where(pad, n_groups, grp),)
            needed = cells(hi) - cells(lo) + max(0, hi - max(lo, B))
            return ((wtab, wlen, atab, alen) + idx,
                    spans.enqueue_cells(hi - lo, needed))
        return mesh.launch_lanes(kind, self.devices, bucket_lanes(B),
                                 shard, self.scoring, n_groups)

    def _fold(self, kind, shards):
        """Folds a group launch's shards into the run's accumulators:
        'gm' the best (matches, full_len), exactly
        (engine_v2.merge_groupmax); 'gsc' the max scores."""
        if kind == 'gm':
            gm, gl = engine_v2.merge_groupmax(
                [(_host(h[0]), _host(h[1])) for h in shards])
            better = gm * self._gacc[:, 1] > self._gacc[:, 0] * gl
            self._gacc[better, 0] = gm[better]
            self._gacc[better, 1] = gl[better]
        else:
            for h in shards:
                np.maximum(self._gsacc, _host(h), out=self._gsacc)

    @staticmethod
    def _count(route, work, padded=False):
        """Adds the (lb, amax, jobs) work to ROUTES[route]: jobs, and cells
        at the rungs (lanes padded to the launch width when `padded`)."""
        for lb, amax, chunk in work:
            n = bucket_lanes(len(chunk)) if padded else len(chunk)
            ROUTES[route][0] += len(chunk)
            ROUTES[route][1] += n * (lb + 1) * amax

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

    @spans.timed('host_route')
    def _host_batch(self, todo):
        """The jobs `todo` on the host route (schemes the kernels refuse,
        PORECHOP_TPU_FORCE_HOST; porechop_tpu/ops/dispatch.py:891-989):
        Gotoh schemes on the native engine in one threaded batch call
        (raising, naming the scheme, without g++), linear ones through the
        executable spec one job at a time.  Returns the (P, 9) rows."""
        pairs = self.pairs[todo]
        _, _, gap_open, gap_ext = self.scoring
        if gap_open != gap_ext:
            # The engine copies the sequences it is given into one buffer:
            # only those these jobs name (a middle-phase batch of a few
            # jobs would otherwise copy every read).
            windows, wi = _named(self.windows, pairs[:, 0])
            adapters, ai = _named(self.adapters, pairs[:, 1])
            t0 = time.perf_counter()
            res = native.align_batch(
                windows, adapters, np.column_stack([wi, ai]), self.scoring,
                entry=('align_simd_scores' if self._score_only
                       else 'align_simd_batch'))
            if timing() and res is not None:
                dt = time.perf_counter() - t0
                cells = sum(len(windows[w]) * len(adapters[a])
                            for w, a in zip(wi, ai))
                _timing_line('native batch P=%d: %.3fs (%.2e cells/s%s)'
                             % (len(todo), dt, cells / max(dt, 1e-9),
                                ', score-only' if self._score_only else ''))
            return res
        res = np.zeros((len(pairs), 9), dtype=np.int64)
        for k, (w, a) in enumerate(pairs):
            r = spec.align_linear(self.windows[w], self.adapters[a],
                                  self.scoring)
            res[k, :len(native.FIELDS)] = [getattr(r, f)
                                           for f in native.FIELDS]
        return res

    def _scatter_host(self, todo, res, out):
        """Scatters host rows into out.  Full results, except that the
        native score-only entry point (a score-only mode) fills only
        raw_score and the degenerate marker: those lanes join the score
        set, so that survivors re-run through the exact path."""
        if self._score_only and self.scoring[2] != self.scoring[3]:
            out['raw_score'][todo] = res[:, 4]
            out['read_start'][todo] = res[:, 0]
            self._score_lanes[todo] = True
            return
        for c, f in enumerate(native.FIELDS):
            out[f][todo] = res[:, c]

    def _table(self, tables, side, rung, chunks):
        """The deduplicated table of the sequences that the rung's chunks
        reference, plus one dummy row (a single 'A') that pad lanes use:
        (rows, lens) as host tensors, the host lens, and the map from
        sequence index to row.  Built once per rung."""
        seqs, col = ((self.windows, 0) if side == 'w'
                     else (self.adapters, 1))
        if (side, rung) not in tables:
            seen = np.zeros(len(seqs), dtype=bool)
            seen[self.pairs[np.concatenate(chunks), col]] = True
            uniq = np.nonzero(seen)[0]
            mat = np.full((len(uniq) + 1, rung), 4, dtype=np.int8)
            lens = np.ones(len(uniq) + 1, dtype=np.int32)
            for r, k in enumerate(uniq):
                s = seqs[k]
                mat[r, :len(s)] = s
                lens[r] = len(s)
            mat[len(uniq), 0] = 0
            row_of = np.full(len(seqs), len(uniq), dtype=np.int64)
            row_of[uniq] = np.arange(len(uniq), dtype=np.int64)
            tables[(side, rung)] = (torch.from_numpy(mat),
                                    torch.from_numpy(lens), lens, row_of)
        return tables[(side, rung)]

    def _launch_chunk(self, chunk, lb, amax, tables, rung_w, rung_a):
        """Enqueues one chunk: the dedup'd window and adapter tables upload
        once per rung and device (shared by every chunk of the rung) and
        each lane is a pair of row indices gathered on the device.  The
        chunk's padded lanes split over the device entries
        (mesh.launch_shards).  Returns (kind, per-shard handles, the lanes'
        window and adapter lengths) for _harvest."""
        B = len(chunk)
        Bp = bucket_lanes(B)
        if self._is_groupmax_rung(lb):
            kind = 'gm'
        elif not self._is_stats_rung(lb):
            kind = 'res'
        elif self._gscore is not None:
            kind = 'gsc'
        else:
            kind = 'sc' if self._score_only else 'st'
        wtab, wlen, wlen_host, wmap = self._table(tables, 'w', lb, rung_w[lb])
        atab, alen, alen_host, amap = self._table(tables, 'a', amax,
                                                  rung_a[amax])
        # Lanes past B are pad lanes, on the dummy rows.
        w_idx = np.full(Bp, wtab.shape[0] - 1, dtype=np.int64)
        a_idx = np.full(Bp, atab.shape[0] - 1, dtype=np.int64)
        w_idx[:B] = wmap[self.pairs[chunk, 0]]
        a_idx[:B] = amap[self.pairs[chunk, 1]]
        groups = None
        if kind in ('gm', 'gsc'):
            gids, n_groups = self._group if kind == 'gm' else self._gscore
            g_idx = np.full(Bp, n_groups, dtype=np.int64)  # pad -> dummy
            g_idx[:B] = gids[chunk]
            groups = (g_idx, n_groups)

        def on(dev):
            for key, host in ((('w', lb, dev), (wtab, wlen)),
                              (('a', amax, dev), (atab, alen))):
                if key not in tables:
                    tables[key] = tuple(t.to(dev) for t in host)
            return tables[('w', lb, dev)] + tables[('a', amax, dev)]
        shards = mesh.launch_shards(kind, self.devices, on, w_idx, a_idx,
                                    self.scoring, groups,
                                    lens=(wlen_host, alen_host))
        return kind, shards, (wlen_host[w_idx[:B]], alen_host[a_idx[:B]])

    def _harvest(self, chunk, handle, out):
        """Blocks on a _launch_chunk handle and scatters results, shard by
        shard in lane order."""
        kind, shards, lens = handle
        B = len(chunk)

        def to_np(t):
            return _cpu(t).numpy()

        def cat(k, host=_host):
            return np.concatenate([host(h[k]) for h in shards])[:B]

        if kind in ('gm', 'gsc'):
            self._fold(kind, shards)
            self._dev_grouped[chunk] = True
            return
        if kind == 'st':
            out['matches'][chunk] = cat(0)
            out['full_len'][chunk] = cat(1)
            self._stats_failed[chunk] = ~cat(2, to_np)
            return
        if kind == 'sc':
            out['raw_score'][chunk] = cat(0)
            self._stats_failed[chunk] = ~cat(1, to_np)
            self._score_lanes[chunk] = True
            return
        # Walks (walk, best, cell_i, cell_j).
        res = engine_v2.finish_v2(*(cat(k, to_np) for k in range(4)), *lens)
        for f in out:
            out[f][chunk] = res[f]

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
