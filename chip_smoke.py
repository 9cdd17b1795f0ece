#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (porechop_tpu_torch) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the three DP kernels from porechop_tpu_torch/csrc/, holds each
against its plain PyTorch version on the card at the shapes the trimming
path gives it (and times both), then runs the default trimming path end to
end through porechop_tpu_torch.cli.main at -v 0 and at -v 1 on two inputs:
8,192 synthetic 10 kb reads, and the long-read set (2,560 reads of 8-200
kb, read N50 40 kb).  Each run must write the output FASTQ and the stdout
transcript of the JAX package (by SHA-256) and launch every kernel, and
the long-read runs must cut at least one trace-bit launch into column
chunks (kernels.split_plan).  The
last line of stdout is the result: {"ok": true, "device":
{...}}; before it, one {"kernels": [...]} line.  Any failure raises and
exits non-zero without a result line.  It writes only under build/
(kernels and the work directories build/smoke/ and build/smoke/long/).
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'smoke'

# The main path's input and the JAX package's outputs on it, recorded on a
# CPU host with the package's byte-identical host engine, in a directory
# holding reads.fastq = write_fastq(synth_reads(8192, 10000, seed=0)):
#   PORECHOP_TPU_FORCE_HOST=1 python -m porechop_tpu -i reads.fastq \
#       -o out_v0.fastq -v 0 -t 4 > stdout_v0.txt
#   PORECHOP_TPU_FORCE_HOST=1 python -m porechop_tpu -i reads.fastq \
#       -o out_v1.fastq -v 1 -t 4 > stdout_v1.txt
# The -v 1 transcript prints the output's absolute path; its digest is of
# the bytes with that directory replaced by <WORKDIR> (progress lines keep
# their carriage returns).
READS_SHA = '8b58d75676fb086c73b18ff06c74089169055b258664afdbfb0722e4fa2dea8d'
OUT_SHA = {0: 'dac6f1bd4d13931723679798e659c3ff90b362025bab3db379daadc21268a844',
           1: 'dac6f1bd4d13931723679798e659c3ff90b362025bab3db379daadc21268a844'}
STDOUT_SHA = {0: 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
              1: '50d6c2089023d2541f402d35df92ab07f33e65e061432f866a89ef56a81b2443'}
# The same for the long-read set, reads.fastq =
# write_fastq(synth_mixed(LONG_READ_PARTS)) (porechop_tpu_torch/utils/
# synth.py), recorded the same way.
LONG_READS_SHA = (
    '3a80e71f8887dc240c3acc7627de9c02de948c8298ab0b336e27b9381f8a998b')
LONG_OUT_SHA = {
    0: 'aa2685515caa699d4fb3fb7a5f2ec7b9872c7a246115d6799737b3a33119477a',
    1: 'aa2685515caa699d4fb3fb7a5f2ec7b9872c7a246115d6799737b3a33119477a'}
LONG_STDOUT_SHA = {
    0: 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
    1: 'a8a742bcc6ad75e46a8c31551a8425707fb3b17f23215660c373fb3572f7dd70'}

SCHEME = (3, -6, -5, -2)
# H100 SXM: 3.35 TB/s of HBM3; 64 INT32 lanes per SM per clock x 132 SMs x
# 1.98 GHz boost = 16.7e12 int32 operations/s (no int32 tensor path).
MEM_BPS = 3.35e12
INT32_OPS = 64 * 132 * 1.98e9
# Minimal int32 operations per DP cell, counted from the recurrences with
# no fusion: score = 2 adds + max (V), select + add (diagonal), max (pre),
# 2 adds + max (next H), max (M) = 10; stats adds the payload selects and
# adds (6); the trace byte adds four compares and four ors (8).
OPS_PER_CELL = {'forward_score': 10, 'forward_stats': 16,
                'forward_tiled': 18}

KERNELS = {
    'forward_score': dict(
        source='porechop_tpu_torch/csrc/dp_score.cu',
        replaces='porechop_tpu/ops/kernel_pallas.py:1228',
        replaces_also=['porechop_tpu/ops/kernel_pallas.py:1366'],
        shapes=[('middle round 0', 1024, 10240, 32),
                ('detection prefilter', 16384, 150, 24),
                ('detection prefilter', 16384, 150, 48),
                ('middle round 0, real width', 16384, 10240, 32)]),
    'forward_stats': dict(
        source='porechop_tpu_torch/csrc/dp_stats.cu',
        replaces='porechop_tpu/ops/kernel_pallas.py:721',
        replaces_also=['porechop_tpu/ops/kernel_pallas.py:979'],
        shapes=[('detection group max', 16384, 150, 24),
                ('detection group max', 16384, 150, 48),
                ('middle survivors', 1024, 10240, 32),
                ('middle survivors, adapter rung 48', 1024, 10240, 64)]),
    'forward_tiled': dict(
        source='porechop_tpu_torch/csrc/dp_tiled.cu',
        replaces='porechop_tpu/ops/kernel_pallas.py:376',
        replaces_also=['porechop_tpu/ops/kernel_pallas.py:590',
                       'porechop_tpu/ops/kernel_pallas.py:115'],
        shapes=[('middle round 0, rung 16,384', 2048, 16384, 32),
                ('phase 2 end windows', 16384, 150, 32),
                ('middle coordinates and replay', 1024, 10240, 32),
                ('middle coords, adapter rung 48', 1024, 10240, 64),
                ('middle round 0, adapter rung 48', 1024, 24576, 64),
                ('middle replay, rung 262,144', 128, 262144, 32),
                # Split launches that the long-read and 10 kb runs make
                # (kernels.TILED_CALLS), and AMAX 128 for coverage only.
                ('long-read, 32 lanes at rung 262,144', 32, 262144, 32),
                ('long-read, 32 lanes at rung 131,072', 32, 131072, 32),
                ('long-read, 128 lanes at rung 131,072', 128, 131072, 32),
                ('10 kb, 512 lanes, adapter rung 48', 512, 10240, 48),
                ('adapter rung 128, coverage only', 32, 131072, 128)]),
}


def _inputs(B, L, A, seed):
    """Main-path-like lanes: reads 90-100% of the rung, adapters 75-100%
    of theirs, one lane in ten carrying its adapter."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    rl = rng.integers((9 * L) // 10, L + 1, B).astype(np.int32)
    adps = rng.integers(0, 4, (B, A)).astype(np.int8)
    al = rng.integers((3 * A) // 4, A + 1, B).astype(np.int32)
    for k in range(0, B, 10):
        reads[k, 5:5 + al[k]] = adps[k, :al[k]]
    return [torch.from_numpy(x).cuda() for x in (reads, rl, adps, al)]


def _time_ms(fn, reps=None):
    """Device time of one call (CUDA events), averaged over reps calls
    after a warm-up; by default over as many calls as fill ~100 ms (5 to
    200), so that short kernels are not timed at the events' resolution."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if reps is None:
        reps = min(200, max(5, int(100 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(name, B, L, A, rl, al):
    """Least time for this call: bytes (inputs read once, outputs written
    once) over the memory rate vs the cells this data needs times the
    minimal ops per cell over the int32 rate."""
    cells = int((rl.long() * al.long()).sum())
    out_bytes = (int((al.long() * (rl.long() + 1)).sum()) + 14 * B
                 if name == 'forward_tiled'
                 else {'forward_score': 4 * B, 'forward_stats': 16 * B}[name])
    nbytes = B * L + B * A + 8 * B + out_bytes
    t_bytes = nbytes / MEM_BPS * 1e3
    t_ops = cells * OPS_PER_CELL[name] / INT32_OPS * 1e3
    return cells, (t_bytes, 'bytes') if t_bytes > t_ops else (t_ops,
                                                             'operations')


def check_kernels(kernels):
    """Each kernel against its plain version at the main path's shapes."""
    results = {}
    for n, (name, spec_) in enumerate(KERNELS.items()):
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + '_plain')
        rows = []
        for m, (what, B, L, A) in enumerate(spec_['shapes']):
            x = _inputs(B, L, A, seed=10 * n + m)
            got, want = kern(*x, *SCHEME), plain(*x, *SCHEME)
            torch.cuda.synchronize()
            if name == 'forward_score':
                got, want = [got], [want]
            if name == 'forward_tiled':
                A_, B_, L1p = got[0].shape
                region = ((torch.arange(A_, device='cuda')[:, None, None]
                           < x[3][None, :, None])
                          & (torch.arange(L1p, device='cuda')[None, None, :]
                             <= x[1][None, :, None]))
                err = int(((got[0].int() - want[0].int()).abs()
                           * region).max())
                got, want = got[1:], want[1:]
            else:
                err = 0
            for g, w in zip(got, want):
                err = max(err, int((g.long() - w.long()).abs().max()))
            if err != 0:
                raise AssertionError('%s disagrees with its plain version '
                                     'at %s (%d x %d x %d): max |err| %d'
                                     % (name, what, B, L, A, err))
            ms = _time_ms(lambda: kern(*x, *SCHEME))
            plain_ms = _time_ms(lambda: plain(*x, *SCHEME), reps=1)
            cells, (bound_ms, bound_by) = _bound(name, B, L, A, x[1], x[3])
            rows.append(dict(what=what, lanes=B, L=L, A=A, cells=cells,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, max_abs_err=err))
            print('%-15s %-30s %6d x %5d x %3d  kernel %9.3f ms '
                  '(%.3e cells/s)  plain %9.3f ms  bound %.4f ms (%s)  '
                  'max|err| %d' % (name, what, B, L, A, ms,
                                   cells / (ms * 1e-3), plain_ms, bound_ms,
                                   bound_by, err), flush=True)
            del x, got, want
        results[name] = rows
    return results


def run_main_path(cli, kernels, what, work, reads, reads_sha, out_sha,
                  stdout_sha, split=False):
    """One input through the default trimming run, on the card, at -v 0
    and -v 1; with split, each run must cut at least one trace-bit launch
    into column chunks.  Returns {verbosity: launches of that run}."""
    from porechop_tpu_torch.utils.synth import write_fastq
    work.mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    t0 = time.perf_counter()
    reads = reads()
    write_fastq('reads.fastq', reads)
    with open('reads.fastq', 'rb') as f:
        if hashlib.sha256(f.read()).hexdigest() != reads_sha:
            raise AssertionError('synthetic %s input differs from the one '
                                 'the reference digests were recorded on'
                                 % what)
    n_reads, n_bases = len(reads), sum(len(r[1]) for r in reads)
    print('synthesised the %s input, %d reads, %d bp, in %.1f s'
          % (what, n_reads, n_bases, time.perf_counter() - t0), flush=True)
    launches = {}
    for v in (0, 1):
        out = 'out_v%d.fastq' % v
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(['-i', 'reads.fastq', '-o', out, '-v', str(v),
                      '-t', '4'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[v] = dict(kernels.LAUNCHES)
        tiled = sorted(kernels.TILED_CALLS.items())
        with open(out, 'rb') as f:
            got_out = hashlib.sha256(f.read()).hexdigest()
        text = buf.getvalue().replace(str(work), '<WORKDIR>')
        got_stdout = hashlib.sha256(text.encode()).hexdigest()
        print('%s run -v %d: %.2f s wall, %.1f reads/s, %.4g bases/s, peak '
              'device memory %.1f MiB, launches %s' % (
                  what, v, wall, n_reads / wall, n_bases / wall,
                  torch.cuda.max_memory_allocated() / 2 ** 20,
                  launches[v]), flush=True)
        print('  forward_tiled launches by (lanes, L, A, chunks): %s'
              % ', '.join('%s x %d' % (k, n) for k, n in tiled), flush=True)
        if got_out != out_sha[v]:
            raise AssertionError('%s -v %d output FASTQ differs from the JAX '
                                 'package (sha256 %s)' % (what, v, got_out))
        if got_stdout != stdout_sha[v]:
            (work / ('stdout_v%d.txt' % v)).write_text(text)
            raise AssertionError('%s -v %d stdout differs from the JAX '
                                 'package (sha256 %s)'
                                 % (what, v, got_stdout))
        idle = [k for k in KERNELS if launches[v][k] == 0]
        if idle:
            raise AssertionError('%s -v %d never launched %s'
                                 % (what, v, idle))
        if split and not any(k[3] > 1 for k, _ in tiled):
            raise AssertionError('%s -v %d never split a trace-bit launch'
                                 % (what, v))
    os.chdir(ROOT)
    return launches


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from porechop_tpu_torch import cli
    from porechop_tpu_torch.ops import kernels

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)

    t0 = time.perf_counter()
    reports = kernels.build()
    print('built %d kernels in %.1f s' % (len(reports),
                                          time.perf_counter() - t0),
          flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('  %s: %s' % (name, line.strip()), flush=True)

    print('trace-bit kernel, warps the card holds at once by AMAX: %s'
          % {a: kernels.card_warps(a) for a in (32, 64, 128)}, flush=True)

    from porechop_tpu_torch.utils.synth import (LONG_READ_PARTS,
                                                 synth_mixed, synth_reads)
    timings = check_kernels(kernels)
    runs = {'10 kb': run_main_path(
        cli, kernels, '10 kb', WORK,
        lambda: synth_reads(8192, 10000, seed=0), READS_SHA, OUT_SHA,
        STDOUT_SHA)}
    runs['long-read'] = run_main_path(
        cli, kernels, 'long-read', WORK / 'long',
        lambda: synth_mixed(LONG_READ_PARTS), LONG_READS_SHA, LONG_OUT_SHA,
        LONG_STDOUT_SHA, split=True)

    line = []
    for name, spec_ in KERNELS.items():
        primary = timings[name][0]
        by_run = {'%s -v %d' % (what, v): n[name]
                  for what, launches in runs.items()
                  for v, n in launches.items()}
        line.append(dict(
            name=name, route='cuda', source=spec_['source'],
            replaces=spec_['replaces'],
            replaces_also=spec_['replaces_also'],
            launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=max(r['max_abs_err'] for r in timings[name]),
            ms=primary['ms'], plain_ms=primary['plain_ms'],
            bound_ms=primary['bound_ms'], bound_by=primary['bound_by'],
            library_ms=None, shape=primary['what'],
            shapes=timings[name]))
    print(json.dumps({'kernels': line}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
