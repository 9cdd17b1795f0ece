"""In-program spans and launch records, on only while a cli.main call runs
with PORECHOP_TPU_TIMING set (the switch is read once per call).

A job is one cli.main call.  Inside it:

- phase spans: load, detect, endtrim, middle, output, with the boundaries
  of the `[timing] phase` lines, which are their exporter (cli._mark);
  a --stream run records them per chunk and sums them per job;
- nested spans, timed by self time (a span's clock stops while a span
  it opened runs), so that the spans of a phase never overlap:
  `plan` (the planner's host work: ops/dispatch.AlignJobs and
  ops/middle.ReplayRunner), `upload` (host-to-card copies), `enqueue`
  (the kernel entry-point calls, parallel/mesh.launch_shards), `host_route`
  (jobs on the native engine or the spec) and `wait` (the host blocked on
  the card: every copy back, and before each upload to a card the stream
  synchronisation that a copy from pageable memory does anyway, made
  explicit so that the wait is not counted as the copy);
  a phase's time outside them is its per-read host work;
- launch records, written by the kernel entry points (ops/kernels.py):
  entry point, device, instantiation ('AMAX/LW', 'plain' for the plain
  versions), lanes as launched, L, A, and the cells the lanes need
  (sum of read_len x adapter_len), counted on the host from the lengths
  the caller holds (`enqueue(...)`), never read back from the card;
- counters, summed over the job: `endtrim.pairs_decided` (the pairs
  phase 2 decides over whole result arrays), `endtrim.pairs_passed`
  (those that pass and are written to their read one by one) and
  `planner.product_lanes` (the lanes of products of jobs whose indices
  the devices computed, ops/dispatch.py).

Each job leaves one record in a buffer of the last JOBS_KEPT jobs
(last_jobs), also when it fails, and a summary on stderr, one `[spans]`
line per phase and span name and one of its launches.  While a
torch.profiler session records (PORECHOP_TPU_PROFILE), every span is also
a record_function range, so that the spans lie in the trace on the
kernels' clock.

Off, span() and its kin return one shared no-op context manager: no
clock read, no allocation, nothing kept.  Spans opened on a thread other
than the job's are not recorded.
"""

from __future__ import annotations

import collections
import functools
import itertools
import os
import sys
import threading
import time

import numpy as np
import torch

JOBS_KEPT = 2000
PHASES = ('load', 'detect', 'endtrim', 'middle', 'output')


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_JOBS = collections.deque(maxlen=JOBS_KEPT)
_IDS = itertools.count()
_job = None                 # the open job while the recorder is on
_PAGE = os.sysconf('SC_PAGE_SIZE')


def _rss_bytes():
    """Resident set size from /proc/self/statm, or None without it."""
    try:
        with open('/proc/self/statm') as f:
            return int(f.read().split()[1]) * _PAGE
    except OSError:
        return None


def _profiler_range(name):
    """An entered record_function range while a profiler session records,
    else None."""
    if not torch.autograd._profiler_enabled():
        return None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


class _Job:
    """The open job's record in the making."""

    def __init__(self):
        self.ident = next(_IDS)
        self.thread = threading.get_ident()
        self.start = time.perf_counter()
        self.stack = []         # open spans: [name, resumed at, range]
        self.lanes = None       # lengths of the launch being enqueued
        self.cur_spans = {}     # name -> [s, n] since the last phase
        self.cur_launches = {}  # key -> [n, n sized, needed]
        self.phases = {}        # label -> [s, n]
        self.spans = {}         # label -> {name -> [s, n]}
        self.launches = {}      # (label,) + key -> [n, n sized, needed]
        self.rss = {}           # label -> bytes at its last close
        self.counts = {}        # counter -> total

    def close_phase(self, label, seconds):
        ph = self.phases.setdefault(label, [0.0, 0])
        ph[0] += seconds
        ph[1] += 1
        self._file(label)
        rss = _rss_bytes()
        if rss is not None:
            self.rss[label] = rss

    def _file(self, label):
        """Moves the spans and launches since the last phase under label."""
        mine = self.spans.setdefault(label, {})
        for name, (s, n) in self.cur_spans.items():
            acc = mine.setdefault(name, [0.0, 0])
            acc[0] += s
            acc[1] += n
        for key, (n, sized, needed) in self.cur_launches.items():
            acc = self.launches.setdefault((label,) + key, [0, 0, 0])
            acc[0] += n
            acc[1] += sized
            acc[2] += needed
        self.cur_spans = {}
        self.cur_launches = {}

    def needed(self, B):
        """Cells that the lanes of the launch being enqueued need, or None
        when the caller gave no lengths for B lanes."""
        if self.lanes is None:
            return None
        if len(self.lanes) == 2:        # enqueue_cells: counted already
            n, needed = self.lanes
            return needed if n == B else None
        wl, wi, al, ai = self.lanes
        w = np.asarray(wl) if wi is None else np.asarray(wl)[wi]
        a = np.asarray(al) if ai is None else np.asarray(al)[ai]
        if len(w) != B or len(a) != B:
            return None
        return int(np.dot(w.astype(np.int64), a.astype(np.int64)))

    def record(self, ok):
        """The job's record: plain data, as last_jobs returns it."""
        self._file(None)
        totals = {}
        for by_name in self.spans.values():
            for name, (s, n) in by_name.items():
                acc = totals.setdefault(name, [0.0, 0])
                acc[0] += s
                acc[1] += n
        launches = [list(k) + v for k, v in self.launches.items()]
        launched = sum(n * B * L * A
                       for _, _, _, _, B, L, A, n, _, _ in launches)
        sized = sum(sz * B * L * A
                    for _, _, _, _, B, L, A, _, sz, _ in launches)
        return {
            'job': self.ident,
            'ok': ok,
            'seconds': time.perf_counter() - self.start,
            'phases': {k: list(v) for k, v in self.phases.items()},
            'spans': {k: {n: list(v) for n, v in d.items()}
                      for k, d in self.spans.items() if d},
            'totals': totals,
            'launches': launches,
            'cells': {'launches': sum(x[7] for x in launches),
                      'launched': launched,
                      'launched_sized': sized,
                      'needed': sum(x[9] for x in launches)},
            'rss_bytes': dict(self.rss),
            'counts': dict(self.counts),
        }


class _Span:
    """A nested span of the open job (name None: a pause of the span
    around it, timed as nothing)."""

    __slots__ = ('job', 'name', 'lanes')

    def __init__(self, job, name, lanes=None):
        self.job = job
        self.name = name
        self.lanes = lanes

    def __enter__(self):
        job = self.job
        now = time.perf_counter()
        if job.stack:
            _stop(job, job.stack[-1], now)
        rng = _profiler_range(self.name) if self.name else None
        job.stack.append([self.name, now, rng])
        if self.name:
            job.cur_spans.setdefault(self.name, [0.0, 0])[1] += 1
        if self.lanes is not None:
            job.lanes = self.lanes
        return self

    def __exit__(self, *exc):
        job = self.job
        top = job.stack.pop()
        if self.lanes is not None:
            job.lanes = None
        if top[2] is not None:
            top[2].__exit__(None, None, None)
        now = time.perf_counter()
        _stop(job, top, now)
        if job.stack:
            job.stack[-1][1] = now
        return False


def _stop(job, entry, now):
    """Adds the open span's self time since it last resumed."""
    if entry[0]:
        job.cur_spans[entry[0]][0] += now - entry[1]


class _Phase:
    """A phase span of the open job; on a clean exit it hands its seconds
    to the exporter."""

    __slots__ = ('job', 'label', 'exporter', 't0', 'rng')

    def __init__(self, job, label, exporter):
        self.job = job
        self.label = label
        self.exporter = exporter

    def __enter__(self):
        self.rng = _profiler_range(self.label)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        seconds = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        self.job.close_phase(self.label, seconds)
        if exc_type is None and self.exporter is not None:
            self.exporter(self.label, seconds)
        return False


def _current():
    job = _job
    if job is None or threading.get_ident() != job.thread:
        return None
    return job


def begin_job(enabled):
    """Opens a job's record when enabled (cli.main: PORECHOP_TPU_TIMING,
    read once per call); otherwise the recorder stays off."""
    global _job
    _job = _Job() if enabled else None


def end_job(ok):
    """Closes the open job: its record joins the buffer and its summary
    goes to stderr.  Nothing while off."""
    global _job
    job, _job = _job, None
    if job is None:
        return
    rec = job.record(ok)
    _JOBS.append(rec)
    for line in _summary(rec):
        print(line, file=sys.stderr, flush=True)


def last_jobs(n):
    """The records of the last n jobs (fewer if fewer were kept), oldest
    first: {'job', 'ok', 'seconds', 'phases' {label: [s, n]}, 'spans'
    {label: {name: [s, n]}} (self times; label None outside phases),
    'totals' {name: [s, n]}, 'launches' [[phase, entry, device,
    instantiation, lanes, L, A, launches, launches sized, needed cells]],
    'cells' {'launches', 'launched', 'launched_sized', 'needed'},
    'rss_bytes' {label: bytes}, 'counts' {counter: total}}."""
    if n <= 0:
        return []
    return list(_JOBS)[-n:]


def _summary(rec):
    """The `[spans]` lines of a job record."""
    head = '[spans] job %d' % rec['job']
    lines = ['%s %s %.6fs' % (head, 'ok' if rec['ok'] else 'failed',
                               rec['seconds'])]
    for label, (s, n) in rec['phases'].items():
        rss = rec['rss_bytes'].get(label)
        lines.append('%s phase %-8s %.6fs x%d%s' % (
            head, label, s, n,
            '' if rss is None else ' rss %.1fMiB' % (rss / 2 ** 20)))
    for name, (s, n) in rec['totals'].items():
        lines.append('%s span %-10s %.6fs x%d' % (head, name, s, n))
    c = rec['cells']
    lines.append('%s launches %d, cells launched %d, needed %d%s' % (
        head, c['launches'], c['launched'], c['needed'],
        ' (%.2f%% of those launched with lengths)'
        % (100.0 * c['needed'] / c['launched_sized'])
        if c['launched_sized'] else ''))
    for name, n in rec['counts'].items():
        lines.append('%s count %s %d' % (head, name, n))
    return lines


def phase_seconds():
    """{label: seconds} of the open job's phases so far, or None while
    off."""
    job = _current()
    if job is None:
        return None
    return {k: v[0] for k, v in job.phases.items()}


def phase(label, exporter=None):
    """A phase span; exporter(label, seconds) runs when it closes
    without an error."""
    job = _current()
    return NOOP if job is None else _Phase(job, label, exporter)


def span(name):
    """A nested span called name."""
    job = _current()
    return NOOP if job is None else _Span(job, name)


def enqueue(wlens, w_idx, alens, a_idx):
    """The span of one launch's entry-point call, with its lanes' lengths
    (lane k: wlens[w_idx[k]] x alens[a_idx[k]]; an index None takes the
    lengths as they are) for its launch record.  wlens None: no lengths."""
    job = _current()
    if job is None:
        return NOOP
    return _Span(job, 'enqueue',
                 None if wlens is None else (wlens, w_idx, alens, a_idx))


def enqueue_cells(n, needed):
    """enqueue's span for a launch of n lanes whose needed cells the
    caller counted (a product of jobs, ops/dispatch.py)."""
    job = _current()
    return NOOP if job is None else _Span(job, 'enqueue', (n, needed))


def upload(device):
    """The span of host-to-device copies to device.  On a card, the
    stream's pending work is waited for first, in a `wait` span: a copy
    from pageable memory synchronises the stream anyway."""
    job = _current()
    if job is None:
        return NOOP
    if device.type == 'cuda':
        with _Span(job, 'wait'):
            torch.cuda.current_stream(device).synchronize()
    return _Span(job, 'upload')


def outside(fn):
    """fn, run as a pause of the spans around it (per-read work called
    back from inside the planner)."""
    job = _current()
    if job is None:
        return fn

    @functools.wraps(fn)
    def paused(*args, **kwargs):
        with _Span(job, None):
            return fn(*args, **kwargs)
    return paused


def timed(name):
    """Decorator: each call is a span called name."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def count(name, n):
    """Adds n to the open job's counter called name."""
    job = _current()
    if job is not None:
        job.counts[name] = job.counts.get(name, 0) + n


def launch(entry, device, inst, B, L, A):
    """A launch record (ops/kernels.py's entry points): B lanes at L x A
    on device, instantiation inst."""
    job = _current()
    if job is None:
        return
    needed = job.needed(B)
    key = (entry, str(device), inst, B, L, A)
    acc = job.cur_launches.setdefault(key, [0, 0, 0])
    acc[0] += 1
    if needed is not None:
        acc[1] += 1
        acc[2] += needed
