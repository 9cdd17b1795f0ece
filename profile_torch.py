#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, on one NVIDIA
GPU.  Run from the repository root:

    python3 profile_torch.py              # 8,192 x 10 kb reads, -o
    python3 profile_torch.py --long       # the long-read set, 8-200 kb
    python3 profile_torch.py --barcoded   # 8,192 barcoded 10 kb reads, -b
    python3 profile_torch.py --stream N   # any of these with --stream N

For -v 0 and -v 1 it runs porechop_tpu_torch.cli.main on an input of
chip_smoke.py (build/smoke/reads.fastq, build/smoke/long/reads.fastq or
build/smoke/barcoded/reads.fastq, made if missing) three times: to warm
up, to time it (wall per phase on the host clock, each phase ending in a
device synchronise, and the peak device memory), and under torch.profiler
(the device's busy time, the sum of its kernel times, the CUDA kernels by
total device time, and every kernel of csrc/).  A streamed run's phases 2
and 3 sum over its chunks; what the wall holds besides the phases
(parsing, writing, text) is `other`.  It prints
one JSON line per verbosity, with the launches of each kernel by shape
and the device's calls of every kind (memory copies included);
the idle share is 1 - busy / the unprofiled wall.  The full profiler
tables go to build/profile/<input>[_stream]/.
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


def main(argv=None):
    parser = argparse.ArgumentParser()
    which = parser.add_mutually_exclusive_group()
    which.add_argument('--long', action='store_true')
    which.add_argument('--barcoded', action='store_true')
    parser.add_argument('--stream', type=int, default=None)
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
    out = OUT / ((sub or 'short') + ('_stream' if opts.stream else ''))

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
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
                torch.cuda.synchronize()
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

    for v in (0, 1):
        args = (['-b', 'profile_bins_v%d' % v] if opts.barcoded
                else ['-o', 'profile_v%d.fastq' % v])
        args = ['-i', 'reads.fastq', *args, '-v', str(v), '-t', '4']
        if opts.stream:
            args += ['--stream', str(opts.stream)]

        def run():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(args)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run()                                   # warm-up
        walls.clear()
        for c in shapes.values():
            c.clear()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall = run()                            # clean wall and phases
        phase_walls = dict(walls)
        phase_walls['other'] = wall - sum(walls.values())
        launches = dict(kernels.LAUNCHES)
        tiled_calls = [[*k, n] for k, n in sorted(kernels.TILED_CALLS.items())]
        shape_calls = {k: [[*s_, n] for s_, n in sorted(c.items())]
                       for k, c in shapes.items()}
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
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
            'verbosity': v, 'wall_s': wall, 'reads_per_s': n_reads / wall,
            'phase_wall_s': phase_walls, 'launches': launches,
            'tiled_calls_lanes_L_A_chunks_n': tiled_calls,
            'score_calls_lanes_L_A_n': shape_calls['forward_score'],
            'stats_calls_lanes_L_A_n': shape_calls['forward_stats'],
            'peak_device_mib': peak_mib,
            'profiled_wall_s': prof_wall, 'device_busy_s': busy_s,
            'device_idle_share': 1 - busy_s / wall,
            'kernel_calls': sum(count.values()),
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
