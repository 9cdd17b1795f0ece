"""Batch planner and engine dispatch.

Turns arbitrary collections of (window, adapter) alignment jobs into a small
number of dense, shape-bucketed device launches, then scatters results back
(counterpart of porechop_tpu/ops/dispatch.py).

Window lengths snap to a geometric ladder and adapters pad to their rung,
so launch shapes are stable across runs; launches are chunked to bound
device memory.

The route is chosen by the scoring scheme, then by launch size:
- gap_open < gap_ext (kernels.supports): the DP kernels, on the device
  entries the caller names (default the card);
- any other gap_open != gap_ext: the native Gotoh engine on the host
  (porechop_tpu_torch/native), in one threaded batch call;
- gap_open == gap_ext (linear): the executable spec (spec.align_linear),
  one job at a time.
The size route (porechop_tpu/ops/dispatch.py's hybrid) is off unless the
caller sets PORECHOP_TPU_HYBRID_CELLS: then a kernel-scheme launch of
fewer padded cells runs on the native engine instead, in one threaded
batch on a worker thread beside the device launches, and the native queue
also takes power-of-two slices of device chunks where it would otherwise
finish first (_share_with_native).  PORECHOP_TPU_MERGE_CELLS, also off
unless set, merges same-rung device work into a wider adapter rung where
that saves launches (_merge_adapter_rungs).  Both change launch shapes and
counts; on the H100 neither paid end to end in paired runs (PERF.md), so
neither is on by default, on any device.  If the native engine fails to
load, its chunks run on the device entries instead (with a note on
stderr); a kernel that fails still raises.
PORECHOP_TPU_FORCE_HOST=1 runs every job on the host (Gotoh schemes on
the native engine, linear ones through the spec) and touches no CUDA
device; PORECHOP_TPU_NO_NATIVE=1 turns the size route off.
PORECHOP_TPU_ENGINE=v1 sends every device chunk through the stat-carrying
engine (ops/engine_v1.run_jobs) on the first device entry.
PORECHOP_TPU_TIMING=1 prints the planner's `[timing]` lines on stderr, in
the JAX package's words: prefilter survivors, launches enqueued and
harvested (padded cells/s), the work share and native batches.
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
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..parallel import mesh
from . import engine_v1, engine_v2, kernels, spec

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

# The size route's threshold and the adapter-rung merge's price of one
# launch, in padded cells, under the JAX package's variable names
# (porechop_tpu/ops/dispatch.py:51-55, :551).  0, the default, turns each
# off.  The H100's measured break-even (breakeven_torch.py: NVIDIA H100
# 80GB HBM3, 700.00 W, 8 host cores) was 1.35e7 cells for the bitless
# modes and, while the walk was plain torch, none or 8.2e8 for a
# trace-bit launch with its walk (1.06e7-1.21e7 with the walk kernel),
# and a merge price of 2.75e7; paired runs at those values showed no gain
# over both off (PERF.md section 6), so they are not defaults.
_HYBRID_CELLS = int(os.environ.get('PORECHOP_TPU_HYBRID_CELLS', 0))
_MERGE_CELLS = int(os.environ.get('PORECHOP_TPU_MERGE_CELLS', 0))

# Jobs and padded cells per route since reset_routes(): 'device' (kernel
# launches, padded lanes), 'native' (the size route: jobs at their rungs'
# cells) and 'host' (schemes the kernels refuse, PORECHOP_TPU_FORCE_HOST:
# jobs at their rungs' cells).
ROUTES = {'device': [0, 0], 'native': [0, 0], 'host': [0, 0]}


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
    return not (os.environ.get('PORECHOP_TPU_NO_NATIVE')
                or gap_open == gap_ext)


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
    its bits (one byte per cell) under _CELL_BUDGET, and lanes * L1p * A
    below 2^31, the JAX package's bound for its walker's int32 flat index
    (the port's walk indexes in 64 bits; the bound keeps the launch
    shapes, and with them the launch counts, the JAX package's)."""
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


def _pad_cells(lb: int, amax: int, n: int) -> int:
    """Padded DP cells of an n-lane launch at rungs (lb, amax)."""
    return _bucket_lanes(n) * (lb + 1) * amax if n else 0


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
    device: the device entries the kernels' launches split over (default:
    the CUDA card; see resolve_devices).
    """

    def __init__(self, windows, adapters, pairs, scoring=(3, -6, -5, -2),
                 device=None):
        self.windows = windows
        self.adapters = adapters
        self.pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
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
        # point, rungs without a stats path, the v1 engine) carry full
        # results already.
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

    def run(self, progress=None) -> dict:
        """Executes all jobs; returns dict of (P,) arrays:
        read_start, read_end_excl, full_pct, partial_pct, plus the raw
        integer fields (matches, aligned_len, full_len, raw_score,
        read_end_incl, adapter_start, adapter_end).

        progress: optional callable(job_indices) invoked as groups of jobs
        resolve (degenerate fixes, each chunk harvest, the native batch)."""
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
        buckets = _buckets(todo, pw[todo], pa[todo])
        if force_host() or not kernels.supports(self.scoring):
            self._count('host', [(lb, amax, c)
                                 for (lb, amax), c in buckets.items()])
            self._scatter_host(todo, self._host_batch(todo), out)
            progress(todo)
            return self._package(out)

        hybrid = (_HYBRID_CELLS
                  if _HYBRID_CELLS > 0 and self._native_available() else 0)
        if _MERGE_CELLS > 0:
            self._merge_adapter_rungs(buckets, hybrid, _MERGE_CELLS)
        small_meta = []   # (lb, amax, chunk) for the native host engine
        device_work = []  # (lb, amax, chunk) launches
        for (lb, amax), idxs in sorted(buckets.items()):
            for chunk in self._chunk_split(np.asarray(idxs), lb, amax):
                if _pad_cells(lb, amax, len(chunk)) < hybrid:
                    small_meta.append((lb, amax, chunk))
                else:
                    device_work.append((lb, amax, chunk))
        if hybrid > 0 and device_work:
            device_work = self._share_with_native(small_meta, device_work)

        # Per-rung job index lists, so table uploads dedup across buckets
        # sharing a rung.
        rung_w = {}
        rung_a = {}
        for lb, amax, chunk in device_work:
            rung_w.setdefault(lb, []).append(chunk)
            rung_a.setdefault(amax, []).append(chunk)
        tables = {}
        # The native batch runs on a worker thread from before the first
        # launch to after the last harvest, which waits on this thread for
        # the launches' device work; the engine's ctypes call drops the
        # GIL.
        small = (np.concatenate([c for _, _, c in small_meta])
                 if small_meta else None)
        with ThreadPoolExecutor(max_workers=1) as pool:
            host = (pool.submit(self._native_batch, small)
                    if small is not None else None)
            self._run_device(device_work, tables, rung_w, rung_a, out,
                             progress)
            res = host.result() if host is not None else None
        if res is not None:
            self._count('native', small_meta)
            self._scatter_host(small, res, out)
            progress(small)
        elif small is not None:
            # The native engine failed: its chunks run on the device
            # entries, and the rung tables grow to cover them.
            for lb, amax, chunk in small_meta:
                rung_w.setdefault(lb, []).append(chunk)
                rung_a.setdefault(amax, []).append(chunk)
            self._run_device(small_meta, tables, rung_w, rung_a, out,
                             progress)
        return self._package(out)

    def _run_device(self, work, tables, rung_w, rung_a, out, progress):
        """The (lb, amax, chunk) launches of `work` on the device entries:
        every launch enqueued before any harvest (CUDA launches are
        asynchronous, so they run back to back while the host moves on),
        or under PORECHOP_TPU_ENGINE=v1 each chunk through the v1 engine."""
        self._count('device', work, padded=True)
        t0 = time.perf_counter()
        if engine_v1.selected():
            # Each chunk runs to its end here, as the JAX package's
            # ungathered launches do: one line, no harvest.
            for lb, amax, chunk in work:
                res = engine_v1.run_jobs(self.windows, self.adapters,
                                         self.pairs[chunk], lb, amax,
                                         self.scoring, self.device)
                for f in out:
                    out[f][chunk] = res[f]
                progress(chunk)
            if timing() and work:
                _timing_line('enqueued %d launches in %.3fs'
                             % (len(work), time.perf_counter() - t0))
            return
        pending = [(chunk, self._launch_chunk(chunk, lb, amax, tables,
                                              rung_w, rung_a))
                   for lb, amax, chunk in work]
        if timing() and work:
            _timing_line('enqueued %d launches in %.3fs'
                         % (len(work), time.perf_counter() - t0))
        # The JAX package starts every harvest's device-to-host copies
        # here (copy_to_host_async) and notes their failures under the
        # switch; the port's harvest copies each result when it reads it,
        # so it has no such step and no such line.
        t0 = time.perf_counter()
        for chunk, h in pending:
            self._harvest(chunk, h, out)
            progress(chunk)
        if timing() and pending:
            dt = time.perf_counter() - t0
            cells = sum(_pad_cells(lb, amax, len(c)) for lb, amax, c in work)
            _timing_line('harvested %d launches in %.3fs (%.2e cells/s '
                         'incl. enqueue-overlap)'
                         % (len(pending), dt, cells / max(dt, 1e-9)))

    @staticmethod
    def _count(route, work, padded=False):
        """Adds the (lb, amax, jobs) work to ROUTES[route]: jobs, and cells
        at the rungs (lanes padded to the launch width when `padded`)."""
        for lb, amax, chunk in work:
            n = _bucket_lanes(len(chunk)) if padded else len(chunk)
            ROUTES[route][0] += len(chunk)
            ROUTES[route][1] += n * (lb + 1) * amax

    # The work-share model's rates, cells/s
    # (porechop_tpu/ops/dispatch.py:594-620), used only when the size route
    # is on: the native queue runs beside the device launches, so the model
    # splits a run's work to make both finish together.  H100 defaults
    # (breakeven_torch.py on NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
    # section 6): each mode's effective rate through the planner (tables,
    # upload, launch, walk, harvest) at its largest measured call, where
    # the fixed cost weighs least: score 7.15e10 at 16,384 x 10,240 x 32,
    # stats 7.29e10 at 1,024 x 10,240 x 32 (group max, which shares it,
    # 2.63e10 at 1,048,576 x 150 x 24), trace bits with the walk 2.38e10 at
    # 2,048 x 16,384 x 32.  The device rate stands for one card: with
    # device entries on several cards it underestimates them (set
    # PORECHOP_TPU_DEV_CELLS_S* to their sum).  The native rate scales with
    # the threads the size route runs on (native.threads() - 1) from
    # align_simd_batch's rate per thread at rung 150, the lower of two
    # calls on 8 threads (2.18e9 / 8).
    _HOST_CELLS_S = float(os.environ.get(
        'PORECHOP_TPU_HOST_CELLS_S',
        2.18e9 / 8 * max(1, native.threads() - 1)))
    _DEV_CELLS_S = float(os.environ.get('PORECHOP_TPU_DEV_CELLS_S',
                                        '2.38e10'))
    _DEV_CELLS_S_STATS = float(os.environ.get(
        'PORECHOP_TPU_DEV_CELLS_S_STATS', '7.29e10'))
    _DEV_CELLS_S_SCORE = float(os.environ.get(
        'PORECHOP_TPU_DEV_CELLS_S_SCORE', '7.15e10'))

    def _dev_rate(self) -> float:
        """Device cells/s for the work-share model under the active mode."""
        if self._score_only:
            return self._DEV_CELLS_S_SCORE
        if self._stats_only or self._group is not None:
            return self._DEV_CELLS_S_STATS
        return self._DEV_CELLS_S

    def _share_with_native(self, small_meta, device_work):
        """Balances one run's work across both engines
        (porechop_tpu/ops/dispatch.py:622-678): diverts job slices from
        device-bound chunks to the native queue so that the two finish
        together under the rate model (minimise max(device cells / device
        rate, native cells / host rate)).  Greedy over quantised moves: a
        device chunk can only shrink to a power-of-two lane count (any
        other count pads straight back up) or leave entirely.  Returns the
        trimmed device_work; diverted jobs are appended to small_meta."""
        rh, rd = self._HOST_CELLS_S, self._dev_rate()
        kept = list(device_work)
        c_dev = float(sum(_pad_cells(lb, amax, len(c))
                          for lb, amax, c in kept))
        # The native side pays real (unpadded) lanes at the rungs' cells.
        c_host = float(sum(len(c) * (lb + 1) * amax
                           for lb, amax, c in small_meta))
        while True:
            wall = max(c_dev / rd, c_host / rh)
            best = None
            for n, (lb, amax, chunk) in enumerate(kept):
                jc = (lb + 1) * amax
                L = len(chunk)
                keeps = {0}
                p = _bucket_lanes(L) // 2
                while p >= _MIN_LANES:
                    if p < L:
                        keeps.add(p)
                    p //= 2
                for keep in keeps:
                    nd = c_dev - _pad_cells(lb, amax, L) \
                        + _pad_cells(lb, amax, keep)
                    nh = c_host + (L - keep) * jc
                    w = max(nd / rd, nh / rh)
                    if w < wall - 1e-9 and (best is None or w < best[0]):
                        best = (w, n, keep)
            if best is None:
                break
            _, n, keep = best
            lb, amax, chunk = kept[n]
            c_dev += _pad_cells(lb, amax, keep) \
                - _pad_cells(lb, amax, len(chunk))
            c_host += (len(chunk) - keep) * (lb + 1) * amax
            small_meta.append((lb, amax, chunk[keep:]))
            if keep:
                kept[n] = (lb, amax, chunk[:keep])
            else:
                kept.pop(n)
        if timing() and c_host:
            _timing_line('work-share: %.2e cells device, %.2e native'
                         % (c_dev, c_host))
        return kept

    def _merge_adapter_rungs(self, buckets, hybrid, merge) -> None:
        """Merges same-window-rung, device-bound work whose adapter rungs
        differ into the widest rung among them, when the extra adapter
        padding costs less than `merge` padded cells per launch saved
        (porechop_tpu/ops/dispatch.py:680-733).  Padding an adapter beyond
        its length is free for correctness (rows past adapter_len are
        frozen).  Device-boundness is judged on the post-split chunks that
        run() routes by (cells >= hybrid): a native-bound tail chunk of a
        large bucket stays behind in its own (lb, amax) bucket."""
        by_lb = {}
        for (lb, amax), idxs in buckets.items():
            by_lb.setdefault(lb, []).append((amax, idxs))
        for lb, lst in by_lb.items():
            cand = []     # (amax, device-bound idxs, n device chunks)
            native_rest = {}
            for amax, idxs in lst:
                dev_chunks, nat_chunks = [], []
                for chunk in self._chunk_split(np.asarray(idxs), lb, amax):
                    if _pad_cells(lb, amax, len(chunk)) < hybrid:
                        nat_chunks.append(chunk)
                    else:
                        dev_chunks.append(chunk)
                if dev_chunks:
                    cand.append((amax, np.concatenate(dev_chunks),
                                 len(dev_chunks)))
                native_rest[amax] = (np.concatenate(nat_chunks)
                                     if nat_chunks else None)
            if len(cand) < 2:
                continue
            target = max(amax for amax, _, _ in cand)
            extra = sum(_bucket_lanes(len(didx)) * (lb + 1) * (target - amax)
                        for amax, didx, _ in cand if amax != target)
            merged_len = sum(len(didx) for _, didx, _ in cand)
            n_merged = -(-merged_len // self._per_launch(lb, target))
            saved = sum(n for _, _, n in cand) - n_merged
            if saved <= 0 or extra >= saved * merge:
                continue
            merged = np.concatenate([didx for _, didx, _ in cand])
            for amax, _, _ in cand:
                rest = native_rest[amax]
                if rest is not None and amax != target:
                    buckets[(lb, amax)] = rest
                else:
                    del buckets[(lb, amax)]
            if native_rest.get(target) is not None:
                merged = np.concatenate([merged, native_rest[target]])
            buckets[(lb, target)] = np.sort(merged)

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

    @staticmethod
    def _native_available() -> bool:
        """Whether the size route may use the native engine: not turned
        off (PORECHOP_TPU_NO_NATIVE) and the library loads (built with
        g++ at first use)."""
        return (not os.environ.get('PORECHOP_TPU_NO_NATIVE')
                and native.available())

    def _native_batch(self, todo):
        """The size route's jobs `todo` (a kernel scheme, so Gotoh) on the
        native engine: _host_batch's rows, or None when the engine returns
        nothing or its library fails to load (the caller then runs them on
        the device entries).  It runs beside this process's launches,
        walks and harvests, so it leaves their thread one core."""
        try:
            res = self._host_batch(todo, max(1, native.threads() - 1))
        except OSError as e:
            res, why = None, 'failed to load (%s)' % e
        else:
            why = 'returned nothing'
        if res is None:
            print('porechop_tpu_torch: the native engine %s; its %d jobs '
                  'run on the device' % (why, len(todo)), file=sys.stderr)
        return res

    def _host_batch(self, todo, n_threads=None):
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
                       else 'align_simd_batch'), n_threads=n_threads)
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

    def _table(self, tables, side, rung, chunks, chunk):
        """The deduplicated table of the sequences that the rung's chunks
        reference, plus one dummy row (a single 'A') that pad lanes use:
        (rows, lens) as host tensors, the host lens, and the map from
        sequence index to row.  Built once per rung, and again (with its
        device copies) when a chunk that joined the rung late, pushed back
        from the native engine, names a sequence it lacks: the map would
        send that lane to the dummy row."""
        seqs, col = ((self.windows, 0) if side == 'w'
                     else (self.adapters, 1))
        if (side, rung) in tables:
            row_of = tables[(side, rung)][3]
            if (row_of[self.pairs[chunk, col]] == len(
                    tables[(side, rung)][2]) - 1).any():
                for key in [k for k in tables if k[:2] == (side, rung)]:
                    del tables[key]
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
        Bp = _bucket_lanes(B)
        if self._is_groupmax_rung(lb):
            kind = 'gm'
        elif not self._is_stats_rung(lb):
            kind = 'res'
        elif self._gscore is not None:
            kind = 'gsc'
        else:
            kind = 'sc' if self._score_only else 'st'
        wtab, wlen, wlen_host, wmap = self._table(tables, 'w', lb, rung_w[lb],
                                                  chunk)
        atab, alen, alen_host, amap = self._table(tables, 'a', amax,
                                                  rung_a[amax], chunk)
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
                                    self.scoring, groups)
        return kind, shards, (wlen_host[w_idx[:B]], alen_host[a_idx[:B]])

    def _harvest(self, chunk, handle, out):
        """Blocks on a _launch_chunk handle and scatters results, shard by
        shard in lane order."""
        kind, shards, lens = handle
        B = len(chunk)

        def to_np(t):
            return t.cpu().numpy()

        def cat(k, host=_host):
            return np.concatenate([host(h[k]) for h in shards])[:B]

        if kind == 'gm':
            gm, gl = engine_v2.merge_groupmax(
                [(_host(h[0]), _host(h[1])) for h in shards])
            better = gm * self._gacc[:, 1] > self._gacc[:, 0] * gl
            self._gacc[better, 0] = gm[better]
            self._gacc[better, 1] = gl[better]
            self._dev_grouped[chunk] = True
            return
        if kind == 'gsc':
            for h in shards:
                np.maximum(self._gsacc, _host(h), out=self._gsacc)
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
