#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, on one NVIDIA
GPU.  Run from the repository root:

    python3 profile_torch.py          # 8,192 x 10 kb reads
    python3 profile_torch.py --long   # the long-read set, 8-200 kb

For -v 0 and -v 1 it runs porechop_tpu_torch.cli.main on an input of
chip_smoke.py (build/smoke/reads.fastq or build/smoke/long/reads.fastq,
made if missing) three times: to warm up, to time it (wall per phase on
the host clock, each phase ending in a device synchronise, and the peak
device memory), and under torch.profiler (the device's busy time, the sum
of its kernel times, the CUDA kernels by total device time, and every
kernel of csrc/).  It
prints one JSON line per verbosity; the idle share is 1 - busy / the
unprofiled wall.  The full profiler tables go to build/profile/ (or
build/profile/long/).
"""

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
    long_reads = '--long' in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print('profile_torch: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from porechop_tpu_torch import cli
    from porechop_tpu_torch.ops import kernels
    from porechop_tpu_torch.utils.synth import (LONG_READ_PARTS,
                                                 synth_mixed, synth_reads,
                                                 write_fastq)
    work, out = (WORK / 'long', OUT / 'long') if long_reads else (WORK, OUT)

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.build()
    work.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    if not os.path.isfile('reads.fastq'):
        write_fastq('reads.fastq', synth_mixed(LONG_READ_PARTS) if long_reads
                    else synth_reads(8192, 10000, seed=0))
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

    for v in (0, 1):
        args = ['-i', 'reads.fastq', '-o', 'profile_v%d.fastq' % v,
                '-v', str(v), '-t', '4']

        def run():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(args)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run()                                   # warm-up
        walls.clear()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall = run()                            # clean wall and phases
        phase_walls = dict(walls)
        launches = dict(kernels.LAUNCHES)
        tiled_calls = [[*k, n] for k, n in sorted(kernels.TILED_CALLS.items())]
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
            'input': 'long-read' if long_reads else '10 kb',
            'verbosity': v, 'wall_s': wall, 'reads_per_s': n_reads / wall,
            'phase_wall_s': phase_walls, 'launches': launches,
            'tiled_calls_lanes_L_A_chunks_n': tiled_calls,
            'peak_device_mib': peak_mib,
            'profiled_wall_s': prof_wall, 'device_busy_s': busy_s,
            'device_idle_share': 1 - busy_s / wall,
            'top_kernels': [
                {'name': n[:80], 'ms': us * 1e-3, 'calls': count[n]}
                for n, us in by_kernel.most_common(12)],
            'dp_kernels': [
                {'name': n[:80], 'ms': us * 1e-3, 'calls': count[n]}
                for n, us in by_kernel.most_common()
                if 'dp_wave_kernel' in n or 'bits_fold_kernel' in n]}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
