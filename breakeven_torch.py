#!/usr/bin/env python3
"""Measures the hybrid route's constants for porechop_tpu_torch on one NVIDIA
GPU and its host: where a launch stops paying for the card.  Run from the
repository root:

    python3 breakeven_torch.py            # break-even, rates, overlap
    python3 breakeven_torch.py --walls    # paired CLI walls (A B B A)
    python3 breakeven_torch.py --walls --reps 3   # three rounds of them

The default run prints the card's name and power limit, then JSON lines:
- `launch`: the wall of one planner call (ops/dispatch.AlignJobs: tables,
  upload, launch, walk for trace bits, harvest; the size route off) per
  mode (score, stats, group max, trace bits with its walk) and shape,
  the median of several calls after a warm-up: 32-lane calls at the 150
  and 10,240 rungs give the fixed cost, calls at the trimming path's
  shapes (PERF.md section 6) the device's cells/s (jobs pair at most
  16,384 windows with as many adapters as it takes, as detection does);
- `rate`: per mode, the device rate at its largest call, the work-share
  model's rate;
- `native`: the native engine's cells/s on this host's cores, both entry
  points (align_simd_batch, align_simd_scores), at rungs 150 and 10,240;
- `breakeven`: per mode and rung, the fixed cost t0 (the 32-lane wall less
  its cells at the device rate) and the cells c where the host's time
  c / host rate equals t0 + c / device rate;
- `overlap`: a trace-bit call with its walks alone, a native batch alone,
  and both at once (the batch on a worker thread, as the planner runs
  it), with the engine's default thread count and with the size route's
  (one fewer), to show whether the native threads slow the walker's
  Python loop.

--walls runs the trimmer (python -m porechop_tpu_torch, in memory, -v 0,
on chip_smoke.py's 10 kb input, made if missing) as separate processes in
the order A B B A for two pairs: the default (size route and merge off)
against both at their measured values (BREAK_EVEN), and the allocator
tuning on against
PORECHOP_TPU_NO_MALLOC_TUNE=1; each process prints the wall of cli.main
after its imports.  Times are host-clock walls of calls that end in a
copy to the host.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'smoke'
# Modes: the AlignJobs call that makes each kernel execution.
MODES = ('score', 'stats', 'group', 'bits')
SHAPES = {                      # (lanes, window length, adapter length)
    'fixed': [(32, 150, 24), (32, 10240, 32)],
    'score': [(16384, 150, 24), (1048576, 150, 24), (16384, 10240, 32)],
    'stats': [(16384, 150, 24), (1024, 10240, 32)],
    'group': [(16384, 150, 24), (1048576, 150, 24)],
    'bits': [(16384, 150, 32), (1024, 10240, 32), (2048, 16384, 32)],
}
# The size route and the merge at the break-even and merge price this
# script measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6).
BREAK_EVEN = {'PORECHOP_TPU_HYBRID_CELLS': '13500000',
              'PORECHOP_TPU_MERGE_CELLS': '27500000'}
WALL_CODE = """\
import sys, time
t0 = time.perf_counter()
from porechop_tpu_torch import cli
import torch
t1 = time.perf_counter()
cli.main(sys.argv[1:])
torch.cuda.synchronize()
print('WALL %.6f IMPORT %.6f' % (time.perf_counter() - t1, t1 - t0))
"""


def _jobs(B, L, A, seed=0):
    """B jobs of random windows of length L (no adapter in them, so a
    score prefilter rejects every lane) against random adapters of length
    A: at most 16,384 windows, each against B / 16,384 adapters, as the
    detection phase pairs its windows with every adapter."""
    rng = np.random.default_rng(seed)
    n_w = min(B, 16384)
    windows = list(rng.integers(0, 4, (n_w, L)).astype(np.int8))
    adapters = list(rng.integers(0, 4, (-(-B // n_w), A)).astype(np.int8))
    pairs = np.column_stack([np.arange(B) % n_w, np.arange(B) // n_w])
    return windows, adapters, pairs


def _call(mode, jobs):
    from porechop_tpu_torch.ops import dispatch
    windows, adapters, pairs = jobs
    j = dispatch.AlignJobs(windows, adapters, pairs)
    if mode == 'score':
        return j.run_stats(prefilter=90.0)
    if mode == 'stats':
        return j.run_stats()
    if mode == 'group':
        return j.run_group_max(np.arange(len(pairs)) % 8, 8)
    return j.run()


def _median_wall(fn, reps):
    fn()                                    # warm-up
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def _padded(B, L, A):
    from porechop_tpu_torch.ops import dispatch
    return dispatch._pad_cells(dispatch._bucket_len(L),
                               dispatch._bucket_adapter_len(A), B)


def measure_launches():
    from porechop_tpu_torch.ops import dispatch, kernels
    dispatch._HYBRID_CELLS = 0            # every launch on the card
    rows = {}
    for mode in MODES:
        for B, L, A in SHAPES['fixed'] + SHAPES[mode]:
            jobs = _jobs(B, L, A)
            kernels.reset_launches()
            med, walls = _median_wall(lambda: _call(mode, jobs),
                                      9 if B <= 1024 else 5)
            cells = _padded(B, L, A)
            rows[(mode, B, L, A)] = (med, cells)
            print(json.dumps({'launch': mode, 'lanes': B, 'L': L, 'A': A,
                              'padded_cells': cells, 'median_s': med,
                              'walls_s': walls,
                              'cells_per_s': cells / med,
                              'launches_per_call': {
                                  k: v / (len(walls) + 1) for k, v in
                                  kernels.LAUNCHES.items()}}), flush=True)
    return rows


def measure_native():
    from porechop_tpu_torch import native
    native.library()
    rates = {}
    for entry in ('align_simd_batch', 'align_simd_scores'):
        for B, L, A in ((8192, 150, 24), (256, 10240, 32)):
            windows, adapters, pairs = _jobs(B, L, A, seed=1)
            med, walls = _median_wall(
                lambda: native.align_batch(windows, adapters, pairs,
                                           (3, -6, -5, -2), entry=entry), 3)
            cells = B * (L + 1) * A
            rates[(entry, L)] = cells / med
            print(json.dumps({'native': entry, 'lanes': B, 'L': L, 'A': A,
                              'threads': min(os.cpu_count() or 1, 16),
                              'rung_cells': cells, 'median_s': med,
                              'walls_s': walls, 'cells_per_s': cells / med}),
                  flush=True)
    return rates


def rates(rows):
    """Per mode, the device rate at its largest call (the most cells),
    where the fixed cost weighs least: the work-share model's rate."""
    for mode in MODES:
        key = max((k for k in rows if k[0] == mode),
                  key=lambda k: rows[k][1])
        t, c = rows[key]
        print(json.dumps({'rate': mode, 'shape': list(key[1:]),
                          'device_cells_per_s': c / t}), flush=True)


def breakeven(rows, native_rates):
    """Per mode and rung: t0 = 32-lane wall - its cells / device rate, and
    c = t0 / (1 / host rate - 1 / device rate), the device rate from the
    same mode's largest call at that rung (else at any rung)."""
    for mode in MODES:
        for _, L, A in SHAPES['fixed']:
            big = ([k for k in rows if k[0] == mode and k[1] > 32
                    and k[2] == L]
                   or [k for k in rows if k[0] == mode and k[1] > 32])
            t_big, c_big = rows[big[0]]
            rd = c_big / t_big
            t32, c32 = rows[(mode, 32, L, A)]
            t0 = t32 - c32 / rd
            entry = ('align_simd_scores' if mode == 'score'
                     else 'align_simd_batch')
            rh = native_rates[(entry, 150 if L <= 150 else 10240)]
            c = t0 / (1 / rh - 1 / rd) if rh < rd else float('inf')
            print(json.dumps({'breakeven': mode, 'L': L, 'A': A,
                              'fixed_s': t0, 'device_cells_per_s': rd,
                              'rate_from': list(big[0][1:]),
                              'host_cells_per_s': rh,
                              'breakeven_cells': c}), flush=True)


def measure_overlap():
    """Walks alone, a native batch alone, and both at once."""
    from porechop_tpu_torch import native
    from porechop_tpu_torch.ops import dispatch
    dispatch._HYBRID_CELLS = 0
    walk_jobs = _jobs(1024, 10240, 32, seed=2)
    nat_jobs = _jobs(16384, 150, 24, seed=3)

    def walks():
        t0 = time.perf_counter()
        _call('bits', walk_jobs)
        return time.perf_counter() - t0

    def nat(n_threads):
        t0 = time.perf_counter()
        native.align_batch(*nat_jobs, (3, -6, -5, -2), n_threads=n_threads)
        return time.perf_counter() - t0

    walks()
    # The engine's default thread count, and the size route's (one core
    # left to the walking thread).
    for n_threads in (native.threads(), max(1, native.threads() - 1)):
        nat(n_threads)
        for rep in range(3):
            alone_w, alone_n = walks(), nat(n_threads)
            box = {}
            th = threading.Thread(
                target=lambda: box.update(n=nat(n_threads)))
            t0 = time.perf_counter()
            th.start()
            w = walks()
            th.join()
            both = time.perf_counter() - t0
            print(json.dumps({'overlap': rep, 'native_threads': n_threads,
                              'walks_alone_s': alone_w,
                              'native_alone_s': alone_n,
                              'walks_beside_native_s': w,
                              'native_beside_walks_s': box['n'],
                              'both_s': both,
                              'serial_s': alone_w + alone_n}), flush=True)


def measure_walls(reps=1):
    """A B B A walls of the CLI, `reps` times over, each in its own
    process."""
    from porechop_tpu_torch.utils.synth import synth_reads, write_fastq
    WORK.mkdir(parents=True, exist_ok=True)
    if not (WORK / 'reads.fastq').is_file():
        write_fastq(str(WORK / 'reads.fastq'),
                    synth_reads(8192, 10000, seed=0))
    base = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ('PORECHOP_TPU_HYBRID_CELLS', 'PORECHOP_TPU_MERGE_CELLS',
              'PORECHOP_TPU_NO_MALLOC_TUNE'):
        base.pop(k, None)
    pairs = [('default', {}, 'break-even', BREAK_EVEN),
             ('malloc tune on', {}, 'malloc tune off',
              {'PORECHOP_TPU_NO_MALLOC_TUNE': '1'})]
    argv = ['-i', 'reads.fastq', '-o', 'walls.fastq', '-v', '0', '-t', '4']
    for a_name, a_env, b_name, b_env in pairs:
        for name, env in ((a_name, a_env), (b_name, b_env), (b_name, b_env),
                          (a_name, a_env)) * reps:
            r = subprocess.run([sys.executable, '-c', WALL_CODE] + argv,
                               cwd=WORK, env=dict(base, **env),
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError('%s: exit %d\n%s' % (name, r.returncode,
                                                        r.stderr[-3000:]))
            line = [ln for ln in r.stdout.splitlines()
                    if ln.startswith('WALL ')][-1].split()
            print(json.dumps({'walls': name, 'env': env,
                              'wall_s': float(line[1]),
                              'import_s': float(line[3])}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--walls', action='store_true')
    ap.add_argument('--reps', type=int, default=1,
                    help='A B B A rounds of --walls (default 1)')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('breakeven_torch: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print('host cores: %d' % (os.cpu_count() or 1), flush=True)
    from porechop_tpu_torch.ops import kernels
    kernels.build()
    if opts.walls:
        measure_walls(opts.reps)
        return 0
    rows = measure_launches()
    rates(rows)
    breakeven(rows, measure_native())
    measure_overlap()
    return 0


if __name__ == '__main__':
    sys.exit(main())
