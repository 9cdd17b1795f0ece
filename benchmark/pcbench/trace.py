"""What a traced run records besides the clock: each kernel launch's shape
and the cells its inputs need, the device's activity under
torch.profiler, and the host's phase spans.

The launch recorder wraps the port's kernel entry points
(`ops/kernels.py`: forward_score, forward_stats, forward_tiled,
forward_walk, walk) from outside: per launch it notes (name, lanes, L,
A) and enqueues one small reduction that sums, on the device, the cells
its lanes need (read_len x adapter_len), their read bases and adapter
bases; nothing is read back before the window closes.  An entry point
that is renamed is no longer wrapped, and the metrics that read it go
silent.

The phase spans wrap the CLI's phase functions by name, as `cli.py`
imports them, and record host clock intervals; a marker kernel launched
just before the window ties the host clock to the profiler's.
"""

from __future__ import annotations

import collections
import functools
import time

ENTRY_POINTS = ('forward_score', 'forward_stats', 'forward_tiled',
                'forward_walk', 'walk')
# The CLI's phases by the names cli.py calls them.
PHASES = ('load_reads', '_find_adapter_sets', 'find_adapters_at_read_ends',
          'find_adapters_in_read_middles', 'output_reads')
# Kernels of the port (csrc/): the names its CUDA kernels are given.
PORT_KERNELS = ('dp_wave_kernel', 'bits_fold_kernel', 'dp_walk_kernel')


class LaunchRecorder:
    """Wraps the kernel entry points while active; `launches()` returns
    (name, B, L, A, needed cells, read bases, adapter bases) per launch."""

    def __init__(self, kernels_module):
        self.mod = kernels_module
        self.shapes = []
        self.sums = []
        self.saved = {}

    def _wrap(self, name, fn):
        import torch

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if name == 'walk':
                bits = args[0]
                A, B, L1p = bits.shape
                self.shapes.append((name, B, L1p - 1, A))
                self.sums.append(None)
            else:
                reads, read_lens, adapters, adapter_lens = args[:4]
                B, L = reads.shape
                self.shapes.append((name, B, L, adapters.shape[1]))
                rl = read_lens.to(torch.int64)
                al = adapter_lens.to(torch.int64)
                self.sums.append(torch.stack((rl * al, rl, al)).sum(1))
            return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        for name in ENTRY_POINTS:
            fn = getattr(self.mod, name, None)
            if fn is not None:
                self.saved[name] = fn
                setattr(self.mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)
        return False

    def launches(self):
        import torch
        done = [s for s in self.sums if s is not None]
        vals = (torch.stack([s.cpu() for s in done]).tolist()
                if done else [])
        it = iter(vals)
        out = []
        for shape, s in zip(self.shapes, self.sums):
            out.append(shape + (tuple(next(it)) if s is not None
                                else (None, None, None)))
        return out


class PhaseSpans:
    """Host-clock spans of the CLI's phases while active: a list of
    (phase, start, end) in perf_counter seconds."""

    def __init__(self, cli_module):
        self.mod = cli_module
        self.spans = []
        self.saved = {}

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((name, t0, time.perf_counter()))
        return wrapped

    def __enter__(self):
        for name in PHASES:
            fn = getattr(self.mod, name, None)
            if fn is not None:
                self.saved[name] = fn
                setattr(self.mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)
        return False


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only.  Entering it
    launches a short kernel with the host clock read just before it, so
    that host times map onto the trace's clock."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.host0 = None

    def __enter__(self):
        self.prof.__enter__()
        torch = self.torch
        torch.cuda.synchronize()
        self.host0 = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """[(device index, name, start us, end us)] of the device's
        activity, and the marker's start (us)."""
        torch = self.torch
        out = []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.append((e.device_index, e.name, e.time_range.start,
                            e.time_range.end))
        out.sort(key=lambda x: x[2])
        marker = [x for x in out if 'sleep' in x[1] or 'spin' in x[1]]
        return out, (marker[0][2] if marker else None)


def union(spans):
    """Merged intervals of (start, end) pairs."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy(events):
    """Per card, the union of its events' intervals; over all cards, the
    share of the span from the first event's start to the last one's end
    in which two or more cards were busy at once (profile_torch.busy's
    arithmetic).  Times in us."""
    spans = collections.defaultdict(list)
    for dev, _, s, e in events:
        spans[dev].append((s, e))
    if not spans:
        return {}, None
    t0 = min(s for v in spans.values() for s, _ in v)
    t1 = max(e for v in spans.values() for _, e in v)
    out, edges = {}, []
    for card, v in sorted(spans.items()):
        out[card] = union(v)
        for lo, hi in out[card]:
            edges += [(lo, 1), (hi, -1)]
    both, active, last = 0, 0, t0
    for t, step in sorted(edges):
        if active >= 2:
            both += t - last
        active += step
        last = t
    return out, (both / (t1 - t0) if t1 > t0 else None)


def idle_by_phase(intervals, lo, hi, spans):
    """Idle time of one card's busy `intervals` inside [lo, hi], split by
    the host phase spans [(name, start, end)] that cover it (the rest is
    'between phases').  All in one clock (us)."""
    gaps, pos = [], lo
    for s, e in intervals:
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > pos:
            gaps.append((pos, min(s, hi)))
        pos = max(pos, e)
    if pos < hi:
        gaps.append((pos, hi))
    out = collections.Counter()
    spans = sorted(spans, key=lambda x: x[1])
    for g0, g1 in gaps:
        covered = 0.0
        for name, s, e in spans:
            if e <= g0:
                continue
            if s >= g1:
                break
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                out[name] += ov
                covered += ov
        out['between phases'] += (g1 - g0) - covered
    return out


def short_name(name):
    """A kernel's name without its argument list and return type."""
    base = name.split('(')[0]
    return base.replace('void ', '').strip()
