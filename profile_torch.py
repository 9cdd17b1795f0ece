#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, on one NVIDIA
GPU or over every card of a host.  Run from the repository root:

    python3 profile_torch.py              # 8,192 x 10 kb reads, -o
    python3 profile_torch.py --long       # the long-read set, 8-200 kb
    python3 profile_torch.py --barcoded   # 8,192 barcoded 10 kb reads, -b
    python3 profile_torch.py --stream N   # any of these with --stream N
    python3 profile_torch.py --device cuda:0 -v 0   # one card, -v 0 only

For -v 0 and -v 1 (or the one -v given) it runs
porechop_tpu_torch.cli.main, on --device (a device or comma-separated
device entries; by default the CLI's own: every local card), on an input of
chip_smoke.py (build/smoke/reads.fastq, build/smoke/long/reads.fastq or
build/smoke/barcoded/reads.fastq, made if missing) three times: to warm
up, to time it (wall per phase on the host clock, each phase ending in a
synchronise of every card, and the peak device memory of each card), and
under torch.profiler (the device's busy time, the sum of its kernel times,
the CUDA kernels by total device time, and every kernel of csrc/; per
card, its kernels' and copies' summed and joined times, and over the run
the share in which two or more cards were busy at once, busy()).  A
streamed run's phases 2 and 3 sum over its chunks; what the wall holds
besides the phases (parsing, writing, text) is `other`.  It prints one
JSON line per verbosity, with the launches of each kernel by shape
and by card, score's and stats' by instantiation ('AMAX/LW',
kernels.WAVE_CALLS), and the device's calls of every kind (memory copies
included); the idle share is 1 - busy / the unprofiled wall.  The full
profiler tables go to build/profile/<input>[_stream][_<device>]/.
"""

import argparse
import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'smoke'
OUT = ROOT / 'build' / 'profile'
PHASES = ('load_reads', 'find_matching_adapter_sets',
          'find_adapters_at_read_ends', 'find_adapters_in_read_middles',
          'output_reads')


def busy(prof):
    """Per card, from a profile's CUDA events (kernels and copies): their
    summed durations, the union of their intervals, the first and last
    start after the first event of any card (ms), and the event count;
    over all cards, the share of the span from the first event's start to
    the last one's end in which two or more cards were busy at once."""
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans[e.device_index].append((e.time_range.start,
                                          e.time_range.end))
    if not spans:
        return {'busy_by_card': {}, 'overlap_share': None}
    t0 = min(s for v in spans.values() for s, _ in v)
    t1 = max(e for v in spans.values() for _, e in v)
    out = {}
    edges = []
    for card, v in sorted(spans.items()):
        v.sort()
        union, lo, hi = 0, None, None
        for s, e in v:
            if hi is None or s > hi:
                if hi is not None:
                    union += hi - lo
                    edges += [(lo, 1), (hi, -1)]
                lo, hi = s, e
            else:
                hi = max(hi, e)
        union += hi - lo
        edges += [(lo, 1), (hi, -1)]
        out['cuda:%d' % card] = {
            'busy_ms': sum(e - s for s, e in v) * 1e-3,
            'union_ms': union * 1e-3, 'calls': len(v),
            'first_start_ms': (v[0][0] - t0) * 1e-3,
            'last_start_ms': (v[-1][0] - t0) * 1e-3}
    # Sweep the cards' busy intervals: time with two or more at once.
    both, active, last = 0, 0, t0
    for t, step in sorted(edges):
        if active >= 2:
            both += t - last
        active += step
        last = t
    return {'busy_by_card': out,
            'overlap_share': both / (t1 - t0) if t1 > t0 else 0.0}


def main(argv=None):
    parser = argparse.ArgumentParser()
    which = parser.add_mutually_exclusive_group()
    which.add_argument('--long', action='store_true')
    which.add_argument('--barcoded', action='store_true')
    parser.add_argument('--stream', type=int, default=None)
    parser.add_argument('--device', default=None)
    parser.add_argument('-v', '--verbosity', type=int, choices=(0, 1))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_torch: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from porechop_tpu_torch import cli
    from porechop_tpu_torch.ops import kernels
    from porechop_tpu_torch.pipeline import stream
    from porechop_tpu_torch.utils.synth import (LONG_READ_PARTS,
                                                 synth_barcoded, synth_mixed,
                                                 synth_reads, write_fastq)
    what = ('long-read' if opts.long else 'barcoded' if opts.barcoded
            else '10 kb')
    sub = {'long-read': 'long', 'barcoded': 'barcoded', '10 kb': ''}[what]
    work = WORK / sub
    out = OUT / ((sub or 'short') + ('_stream' if opts.stream else '')
                 + ('_' + opts.device.replace(':', '').replace(',', '_')
                    if opts.device else ''))
    cards = range(torch.cuda.device_count())

    def sync():
        for k in cards:
            torch.cuda.synchronize(k)

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sync()                      # every card's context, before its stats
    kernels.build()
    work.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    if not os.path.isfile('reads.fastq'):
        write_fastq('reads.fastq', {
            'long-read': lambda: synth_mixed(LONG_READ_PARTS),
            'barcoded': lambda: synth_barcoded(8192, 10000, seed=0),
            '10 kb': lambda: synth_reads(8192, 10000, seed=0)}[what]())
    with open('reads.fastq', 'rb') as f:
        n_reads = sum(1 for _ in f) // 4

    walls = collections.Counter()

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                walls[name] += time.perf_counter() - t0
        return run

    for name in PHASES:
        setattr(cli, name, timed(name, getattr(cli, name)))
    for name in PHASES[2:4]:                # a streamed run's chunks
        setattr(stream, name, timed(name, getattr(stream, name)))

    shapes = {'forward_score': collections.Counter(),
              'forward_stats': collections.Counter()}

    def recorded(name, fn):
        def call(reads, read_lens, adapters, *rest):
            if reads.is_cuda:
                shapes[name][(*reads.shape, adapters.shape[1])] += 1
            return fn(reads, read_lens, adapters, *rest)
        return call

    for name in shapes:
        setattr(kernels, name, recorded(name, getattr(kernels, name)))

    for v in (0, 1) if opts.verbosity is None else (opts.verbosity,):
        args = (['-b', 'profile_bins_v%d' % v] if opts.barcoded
                else ['-o', 'profile_v%d.fastq' % v])
        args = ['-i', 'reads.fastq', *args, '-v', str(v), '-t', '4']
        if opts.stream:
            args += ['--stream', str(opts.stream)]
        if opts.device:
            args += ['--device', opts.device]

        def run():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(args)
            sync()
            return time.perf_counter() - t0

        run()                                   # warm-up
        walls.clear()
        for c in shapes.values():
            c.clear()
        kernels.reset_launches()
        for k in cards:
            torch.cuda.reset_peak_memory_stats(k)
        wall = run()                            # clean wall and phases
        phase_walls = dict(walls)
        phase_walls['other'] = wall - sum(walls.values())
        launches = dict(kernels.LAUNCHES)
        tiled_calls = [[*k, n] for k, n in sorted(kernels.TILED_CALLS.items())]
        wave_calls = [[*k, n] for k, n in
                      sorted(kernels.WAVE_CALLS.items())]
        shape_calls = {k: [[*s_, n] for s_, n in sorted(c.items())]
                       for k, c in shapes.items()}
        peak_mib = {'cuda:%d' % k:
                    torch.cuda.max_memory_allocated(k) / 2 ** 20
                    for k in cards}
        by_card = collections.defaultdict(dict)
        for (name, dev), n in kernels.DEVICE_LAUNCHES.items():
            by_card[dev][name] = n
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            prof_wall = run()
        by_kernel = collections.Counter()
        count = collections.Counter()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[evt.name] += evt.time_range.elapsed_us()
                count[evt.name] += 1
        busy_s = sum(by_kernel.values()) * 1e-6
        (out / ('table_v%d.txt' % v)).write_text(
            prof.key_averages().table(sort_by='self_device_time_total',
                                      row_limit=40))
        print(json.dumps({
            'input': what, 'stream': opts.stream,
            'device': opts.device or 'every card', 'cards': len(cards),
            'verbosity': v, 'wall_s': wall, 'reads_per_s': n_reads / wall,
            'phase_wall_s': phase_walls, 'launches': launches,
            'tiled_calls_lanes_L_A_chunks_n': tiled_calls,
            'wave_calls_kernel_layout_n': wave_calls,
            'score_calls_lanes_L_A_n': shape_calls['forward_score'],
            'stats_calls_lanes_L_A_n': shape_calls['forward_stats'],
            'peak_device_mib': max(peak_mib.values()),
            'peak_device_mib_by_card': peak_mib,
            'launches_by_card': dict(sorted(by_card.items())),
            'profiled_wall_s': prof_wall, 'device_busy_s': busy_s,
            'device_idle_share': 1 - busy_s / wall,
            'kernel_calls': sum(count.values()),
            **busy(prof),
            'top_kernels': [
                {'name': n[:80], 'ms': us * 1e-3, 'calls': count[n]}
                for n, us in by_kernel.most_common(12)],
            'dp_kernels': [
                {'name': n[:80], 'ms': us * 1e-3, 'calls': count[n]}
                for n, us in by_kernel.most_common()
                if 'dp_wave_kernel' in n or 'bits_fold_kernel' in n
                or 'dp_walk_kernel' in n]}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
