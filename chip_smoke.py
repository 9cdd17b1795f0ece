#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (porechop_tpu_torch) on one
NVIDIA GPU, or on every card of a host with several.  Run from the
repository root with no arguments:

    python3 chip_smoke.py

It builds the DP kernels and the trace-bit walk from
porechop_tpu_torch/csrc/, holds each against its plain PyTorch version on
the card at the shapes the trimming path gives it and times it: score,
stats, the trace-bit forward (forward_tiled, whose bits the K1/K2 checks
read), the trimming path's trace-bit call (forward_walk: the forward with
each lane walked inside its launch) and the standalone walk on the
forward's bits; score and stats at adapter rungs 16-24 and 48 in both
lane layouts (one lane a warp, and four or two lanes a warp: the
instantiations AMAX 24/LW 8 and 48/16), each timed in the layout
kernels.lane_group picks, which its row names.  A time under ~0.1 ms
comes from torch.profiler's CUDA kernel durations over the same launches,
printed beside the CUDA-event time, which a launch that short bounds by
the host's enqueue rate.  Then
it runs the trimmer end to end through
porechop_tpu_torch.cli.main at -v 0 and at -v 1 on three inputs:
- 8,192 synthetic 10 kb reads, in memory and streamed (--stream 2048);
- the long-read set (2,560 reads of 8-200 kb, read N50 40 kb), in memory
  and streamed (--stream 640);
- 8,192 natively barcoded 10 kb reads (synth_barcoded), binned with -b,
  in memory and streamed (--stream 4096).
Each run must write the output FASTQ (or bins) and the stdout transcript
of the JAX package (by SHA-256) and launch every kernel of the path
(score, stats and forward_walk), every trace-bit call walking inside its
own launch on its own device (no forward_tiled and no standalone walk
launches, in every run below too; a one-tile call allocates no trace
bits), the in-process runs together must launch each narrow
instantiation of score and stats (kernels.WAVE_CALLS, printed per run),
the long-read runs must cut at least one trace-bit launch into
column chunks (kernels.split_plan), and every barcoded run must cut each
of its trace-bit calls at the middle's rung and adapter rung 96 (the
AMAX 96 instantiation) so.  Last, the 10 kb input runs at -v 1 as two
torch.distributed ranks sharing the card (two `python -m
porechop_tpu_torch` processes, in memory and streamed), whose merged
output and rank 0's transcript must be the single-process run's.  Then
the stretch input's head (stretch_torch.py: 200,000 gzipped 1 kb reads,
written by a process pool) streamed in ten chunks of 20,000, in this
process at -v 0 (the device memory allocated after the last chunk within
1 MiB of that after the first, on all cards together) and as two ranks
at -v 1, against the JAX package's digests recorded in stretch_torch.py.
Then
the schemes the kernels refuse, which run on the host (the native Gotoh
engine built with g++, the linear executable spec): the 10 kb input at
-v 0 and -v 1 under --scoring_scheme 3,-6,-2,-5 and 16 reads of 1 kb at
-v 1 under 2,-3,-3,-3, each against the JAX package's digests and with no
kernel launch.  Last, lanes split over two device entries on the one card
(--device cuda:0,cuda:0; also cuda:0,cuda:1 on a host with two cards):
10 kb at -v 0/-v 1 and barcoded -b at -v 1 against the digests they
already have, each kernel launched more often than on one entry (and on
every named card).  On a host with several cards a run
with no --device splits over all of them, so there the entry runs are
held against the same runs on cuda:0 alone.  On such a host every run
on two or more distinct cards (no --device, cuda:0,cuda:1) must launch
each kernel it launches on every card, as often on each card but the
first, the first card's surplus being the middle phase's replay (which
does not split, as the JAX package's does not shard), and the two ranks
run on two distinct cards.  Last, the 10 kb input at -v 0 and -v 1
under PORECHOP_TPU_FORCE_HOST=1, against the default digests: every job
on the native host engine, no launch and no byte allocated on the card.
The 10 kb two-rank run (in memory) runs under PORECHOP_TPU_LOAD_STATS,
and each rank must have built fewer reads than the input holds.  Every run prints its
wall, reads/s, peak device memory per card and jobs and padded cells per
route.  After the runs, every kernel is held against its plain version
at every (lanes, L, A) that any on-card run launched it at (the two-rank
runs' included) and the first checks did not cover; at every trace-bit
shape, forward_walk, forward_tiled (bits, best, cells, flags) and the
standalone walk on its bits; on a host with several cards, every kernel
also on each card but cuda:0 at shapes the runs launched there (on one
card, one line says that the multi-card phases did not run).  Then the
dry-run entry points (porechop_tpu_torch/entry.py): entry() on the card
against the CPU, dryrun_multichip(2) on cuda:0,cuda:0 and, on n >= 2
cards, dryrun_multichip(n) on the cards.  Last, the instruments: the 10 kb
input at -v 0 under PORECHOP_TPU_TIMING=1 (the five phase lines on
stderr, in order) and under PORECHOP_TPU_PROFILE=<dir> (one Chrome trace
naming the port's CUDA kernels), each against the default digests, then
`bench_torch.py --runs 1 --warmups 0` as a child, whose JSON line must
say `correct` with the card's and the forced host's values; these runs'
launches join the kernels line.  The script prints its own wall
before the result.  The last line of stdout is the result: {"ok": true,
"device": {...}}; before it, one {"kernels": [...]} line.  Any failure
raises and exits non-zero without a result line.  It writes only under
build/ (kernels, the native engine and the work directories under
build/smoke/); it builds the native engine first, as it builds the
kernels, so that no run's wall holds the g++ build.
"""

import collections
import contextlib
import hashlib
import io
import json
import os
import shutil
import socket
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
# The barcoded input, reads.fastq = write_fastq(synth_barcoded(8192, 10000,
# seed=0)), and the JAX package's bins and transcript on it, recorded the
# same way:
#   PORECHOP_TPU_FORCE_HOST=1 python -m porechop_tpu -i reads.fastq \
#       -b bins -v 1 -t 4 > stdout_v1.txt
# The -v 0 runs are held against these -v 1 bins (with an empty
# transcript): the JAX package's -b -v 0 prefilters detection and may zero
# the side scores that choose the barcode orientation, which the port
# does not copy.
BARCODED_READS_SHA = (
    'f20d1a6824c3afe5d9bbea4aa99706311d85e640aaaf4db97e9426c2819aec3b')
BARCODED_BIN_SHA = {
    'BC01.fastq': 'bfc661a9bbb87c5dfa2ac10ee71a6afc65d735d186d531d71800b7a788dcf3b5',
    'BC02.fastq': '1258761cbb29ebfa640ea15c2fa2ed03a8069d1aac73602ea26a377a17d68df6',
    'BC03.fastq': 'fc9c1dd5e9e687634220100752665cfdc438b8e65bdf7ddca2538614cf8bdc22',
    'BC04.fastq': '676bab998dbe8bf1abaa1ac24d675570845f4e1afaa009c15a50ef413c7c105e',
    'BC05.fastq': 'aab75823943f36aa153c1d2cb9c79b618d058db9aa829fa7b4a7ed88213fafb3',
    'BC06.fastq': '0dacb3ce99ab33c9a368abeb05f995f56112417770f66e9e45c0b84543b0d904',
    'BC07.fastq': '000b2588d553db29f89e7b94d457d996c5ba5d04d3ada1f1cf8a665559f18137',
    'BC08.fastq': '3531c4412e6185e6af18bbc30953845d9572e60595b779700063862765d362c7',
    'BC09.fastq': 'b3f30a65dab8f088dbdfc9c653876507a53cbb6f498e86b31e935c29bd3cbe42',
    'BC10.fastq': '577f99323c9250d6f614303515ddf21aa680491b7393c3e03f082ca1803179cc',
    'BC11.fastq': 'ebcbc2fa2744fe6018fc32983f8c1cbce6362d46a27d5e517d209179c313adb8',
    'BC12.fastq': 'b12c5e143a077a03346a3bb56fef70c7bed006cdcba0b539de1e6a187426f73b',
    'none.fastq': '9238e7bbd06c6909851b4693e12f10149548356fb8dbad3034024ee81ecaae80'}
BARCODED_STDOUT_SHA = {
    0: 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
    1: 'b9ef99e430ea8bf31fe2fcdaa9a497d6f7f060ae8cf3df7a0d9fdb0443add84c'}

# The host route: the 10 kb input under a Gotoh scheme the kernels refuse
# (gap_open > gap_ext), recorded the same way with
#   PORECHOP_TPU_FORCE_HOST=1 python -m porechop_tpu -i reads.fastq \
#       -o out_v1.fastq -v 1 -t 4 --scoring_scheme 3,-6,-2,-5 > stdout_v1.txt
# (and -v 0); and a linear scheme on reads.fastq = write_fastq(synth_reads(
# 16, 1000, seed=0)), its split pieces kept so that the output holds them:
#   PORECHOP_TPU_FORCE_HOST=1 python -m porechop_tpu -i reads.fastq \
#       -o out_v1.fastq -v 1 -t 4 --scoring_scheme 2,-3,-3,-3 \
#       --min_split_read_size 100 > stdout_v1.txt
GOTOH_FLAGS = ['--scoring_scheme', '3,-6,-2,-5']
GOTOH_OUT_SHA = {
    0: 'a109e5d836a93ecb3511d8ff9adf637df5d535f0a36abd4843c1fec3dda933a1',
    1: 'a109e5d836a93ecb3511d8ff9adf637df5d535f0a36abd4843c1fec3dda933a1'}
GOTOH_STDOUT_SHA = {
    0: 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855',
    1: '4f3710a4f36742a99e698be0b9e86242df29fa3e571b1e8ad2a767ca42d114ef'}
LINEAR_FLAGS = ['--scoring_scheme', '2,-3,-3,-3', '--min_split_read_size',
                '100']
LINEAR_READS_SHA = (
    'ef95da1af73004718ad9b633840fa4c194c33e7748bf2f56083169eb7d81bf59')
LINEAR_OUT_SHA = {
    1: '85c608b01dd1158cb8e4b88e92f0a4774287b1adc704c463a17c0fdebe0ae482'}
LINEAR_STDOUT_SHA = {
    1: '8a6fe297431ac92973ee0c5bcd5916e91e38bc217c8bbc4a8f02cd51ef8e8ead'}

# Each rank of the two-rank runs: `python -m porechop_tpu_torch`, then its
# peak device memory (on its card, cuda:rank % cards), kernel launches,
# routes and the (lanes, L, A) of every kernel call as one JSON line on
# stderr.
RANK_CODE = """\
import json, runpy, sys, torch
from porechop_tpu_torch.ops import dispatch, kernels
shapes = {}
def recording(name, fn):
    def call(reads, read_lens, adapters, *rest):
        shapes.setdefault(name, set()).add((*reads.shape, adapters.shape[1]))
        return fn(reads, read_lens, adapters, *rest)
    return call
for name in ('forward_score', 'forward_stats', 'forward_tiled',
             'forward_walk'):
    setattr(kernels, name, recording(name, getattr(kernels, name)))
walk = kernels.walk
def walking(bits, *rest):
    shapes.setdefault('walk', set()).add(
        (bits.shape[1], bits.shape[2], bits.shape[0]))
    return walk(bits, *rest)
kernels.walk = walking
runpy.run_module('porechop_tpu_torch', run_name='__main__', alter_sys=True)
print(json.dumps({'peak_bytes': max(
    torch.cuda.max_memory_allocated(k)
    for k in range(torch.cuda.device_count())),
                  'cards': sorted({d for _, d in kernels.DEVICE_LAUNCHES}),
                  'launches': kernels.LAUNCHES,
                  'routes': dispatch.ROUTES,
                  'shapes': {n: sorted(v) for n, v in shapes.items()}}),
      file=sys.stderr)
"""
RANK_TIMEOUT = 300
# The stretch phase: the head of stretch_torch.py's 1M-read input, its
# digests recorded there, streamed in ten chunks of stretch_torch.CHUNK.
STRETCH_READS = 200_000

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
                'forward_tiled': 18, 'forward_walk': 18}

# A launch at the barcoded middle's adapter rung (AMAX 96) whose lanes mix
# adapters of MIXED_ALENS bases (lane k the (k % 3)-th); every other shape's
# lanes draw theirs from 75-100% of A.
MIXED = 'barcoded middle, adapters of 65, 80 and 96 bp'
MIXED_ALENS = (65, 80, 96)
# A launch whose lanes draw read lengths from 0 to L and adapter lengths
# from 0 to A, so that the lanes sharing a warp end at different columns
# and rows (adapter rungs 24 and 48 run up to four lanes a warp).
RAGGED = 'ragged, read lengths 0 to L, adapters 0 to A'

KERNELS = {
    'forward_score': dict(
        source='porechop_tpu_torch/csrc/dp_score.cu',
        replaces='porechop_tpu/ops/kernel_pallas.py:1228',
        replaces_also=['porechop_tpu/ops/kernel_pallas.py:1366'],
        shapes=[('middle round 0', 1024, 10240, 32),
                ('detection prefilter', 16384, 150, 24),
                ('detection prefilter', 16384, 150, 48),
                ('middle round 0, real width', 16384, 10240, 32),
                ('detection prefilter, as the runs launch it', 1048576,
                 150, 24),
                ('stretch detection prefilter', 262144, 150, 24),
                ('stretch round 0', 32768, 1024, 48),
                (RAGGED, 16387, 1100, 24),
                (RAGGED, 2051, 1100, 48),
                ('barcoded middle round 0', 4096, 10240, 96),
                (MIXED, 512, 10240, 96),
                ('adapter rung 128, coverage only', 512, 10240, 128)]),
    'forward_stats': dict(
        source='porechop_tpu_torch/csrc/dp_stats.cu',
        replaces='porechop_tpu/ops/kernel_pallas.py:721',
        replaces_also=['porechop_tpu/ops/kernel_pallas.py:979'],
        shapes=[('detection group max', 16384, 150, 24),
                ('detection group max', 16384, 150, 48),
                ('stretch survivors', 32, 1024, 24),
                ('stretch survivors', 32, 1536, 48),
                (RAGGED, 16387, 1100, 48),
                (RAGGED, 2051, 1100, 24),
                ('middle survivors', 1024, 10240, 32),
                ('middle survivors, adapter rung 48', 1024, 10240, 64),
                ('barcoded middle survivors', 512, 10240, 96),
                (MIXED, 512, 10240, 96),
                ('adapter rung 128, coverage only', 512, 10240, 128)]),
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
                # Split launches that the long-read, 10 kb and barcoded
                # runs make (kernels.TILED_CALLS), and AMAX 128 for
                # coverage only.
                ('long-read, 32 lanes at rung 262,144', 32, 262144, 32),
                ('long-read, 32 lanes at rung 131,072', 32, 131072, 32),
                ('long-read, 128 lanes at rung 131,072', 128, 131072, 32),
                ('10 kb, 512 lanes, adapter rung 48', 512, 10240, 48),
                ('barcoded middle, 512 lanes, adapter rung 96', 512, 10240,
                 96),
                (MIXED, 512, 10240, 96),
                ('adapter rung 128, coverage only', 32, 131072, 128)]),
}
# The trimming path's trace-bit call: the forward with each lane's walk in
# the same launches (csrc/dp_walk.cuh run by the kernel's epilogue, or by
# bits_fold_kernel after a split), at the trace-bit forward's shapes.
KERNELS['forward_walk'] = dict(
    source='porechop_tpu_torch/csrc/dp_tiled.cu',
    replaces='porechop_tpu/ops/kernel_pallas.py:115',
    replaces_also=['porechop_tpu/ops/kernel_pallas.py:376',
                   'porechop_tpu/ops/engine_v2.py:252 _traceback_impl'],
    shapes=KERNELS['forward_tiled']['shapes'])
# The kernels every on-card trimming run launches.
PATH_KERNELS = ('forward_score', 'forward_stats', 'forward_walk')


# The standalone walk (csrc/dp_walk.cu) after the trace-bit forward, held
# against its plain version on the bits that forward_tiled makes of _inputs
# at the forward's shape: these first, then every trace-bit shape of the
# runs.
WALK = dict(
    source='porechop_tpu_torch/csrc/dp_walk.cu',
    replaces='porechop_tpu/ops/engine_v2.py:252 _traceback_impl',
    replaces_also=['porechop_tpu/native/traceback.cpp'],
    shapes=[('phase 2 end windows', 16384, 150, 32),
            ('10 kb middle, adapter rung 48', 512, 10240, 48),
            ('barcoded middle, adapter rung 96', 512, 10240, 96),
            ('middle replay, rung 262,144', 128, 262144, 32)])
# Every kernel whose launches a run counts.
ALL_KERNELS = [*KERNELS, 'walk']
# Events time under which a kernel is timed from its CUDA kernel durations.
CUPTI_BELOW_MS = 0.1
# Score and stats launches of every in-process run by (kernel, 'AMAX/LW'),
# and the narrow instantiations the runs must launch (adapter rungs 16-24
# and 48 in launches of many lanes: the 10 kb run's detection prefilter
# and group max, its round 0 at rung 48).
WAVE_TOTAL = collections.Counter()
NARROW = [(name, layout) for name in ('forward_score', 'forward_stats')
          for layout in ('24/8', '48/16')]


def _inputs(B, L, A, seed, what=None):
    """Main-path-like lanes: reads 90-100% of the rung, adapters 75-100%
    of theirs (for the shape `what` MIXED, MIXED_ALENS in turn; RAGGED, 0
    to 100% of each), one lane in ten carrying its adapter."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    lo = (0, 0) if what == RAGGED else ((9 * L) // 10, (3 * A) // 4)
    rl = rng.integers(lo[0], L + 1, B).astype(np.int32)
    adps = rng.integers(0, 4, (B, A)).astype(np.int8)
    al = rng.integers(lo[1], A + 1, B).astype(np.int32)
    if what == MIXED:
        al = np.resize(np.array(MIXED_ALENS, np.int32), B)
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


def _cupti_ms(fn, reps=50, tries=6):
    """The card's time of one call: the durations of the CUDA kernels that
    reps calls launch, as torch.profiler records them (CUPTI), summed and
    averaged over the calls, after a warm-up.  Launches back to back are
    not: the host's enqueue rate bounds their event time from below.  A
    profile that recorded no kernel is taken again a second later, up to
    `tries` profiles: on the H100 about one profile in 30 records none,
    and three in a row did once (a smoke run that failed on it)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for k in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if times:
            return sum(times) / reps * 1e-3
        print('  (profile %d recorded no CUDA kernel)' % (k + 1), flush=True)
        time.sleep(1)
    raise RuntimeError('the profiler recorded no CUDA kernel in %d profiles'
                       % tries)


def _kernel_ms(fn):
    """(ms, events ms, how ms was taken): the CUDA-event time, or below
    CUPTI_BELOW_MS the kernel durations of _cupti_ms."""
    ev = _time_ms(fn)
    if ev >= CUPTI_BELOW_MS:
        return ev, ev, 'events'
    return _cupti_ms(fn), ev, 'cupti'


def _once_ms(fn):
    """(fn(), its device time in ms by CUDA events): one call, no
    warm-up, for the plain versions, which take tens of milliseconds."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _bound(name, B, L, A, rl, al):
    """Least time for this call: bytes (inputs read once, outputs written
    once) over the memory rate vs the cells this data needs times the
    minimal ops per cell over the int32 rate.  A trace-bit call writes the
    bits of the walker's region (forward_walk: none on a one-tile launch,
    whose bits stay on the SM) and 14 bytes a lane (forward_walk: and the
    40-byte aggregates)."""
    cells = int((rl.long() * al.long()).sum())
    if name in ('forward_tiled', 'forward_walk'):
        one_tile = name == 'forward_walk' and L + 1 <= 256
        out_bytes = (0 if one_tile else int((al.long() * (rl.long() + 1))
                                            .sum())) + 14 * B
        out_bytes += 40 * B if name == 'forward_walk' else 0
    else:
        out_bytes = {'forward_score': 4 * B, 'forward_stats': 16 * B}[name]
    nbytes = B * L + B * A + 8 * B + out_bytes
    t_bytes = nbytes / MEM_BPS * 1e3
    t_ops = cells * OPS_PER_CELL[name] / INT32_OPS * 1e3
    return cells, (t_bytes, 'bytes') if t_bytes > t_ops else (t_ops,
                                                             'operations')


def _row(name, what, B, L, A, timed, plain_ms, bound, err, **extra):
    """One timed shape: the row the kernels line lists, printed."""
    ms, ms_events, timing = timed
    cells, (bound_ms, bound_by) = bound
    print('%-15s %-30s %6d x %6d x %3d  kernel %9.4f ms (%s; events %.4f)'
          '  plain %9.3f ms  bound %.4g ms (%s)  max|err| %d%s'
          % (name, what, B, L, A, ms, timing, ms_events, plain_ms, bound_ms,
             bound_by, err, ''.join('  %s %s' % kv for kv in extra.items())),
          flush=True)
    return dict(what=what, lanes=B, L=L, A=A, cells=cells, ms=ms,
                ms_events=ms_events, timing=timing, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                **extra)


def _max_err(got, want):
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _bits_err(got, want, rl, al):
    """Largest |difference| of two trace-bit tensors in the walker's region
    (rows < adapter_len, columns <= read_len)."""
    A_, _, L1p = got.shape
    region = ((torch.arange(A_, device='cuda')[:, None, None]
               < al[None, :, None])
              & (torch.arange(L1p, device='cuda')[None, None, :]
                 <= rl[None, :, None]))
    return int(((got.int() - want.int()).abs() * region).max())


def layouts(kernels, name, B, A):
    """(lanes a warp that the wrapper picks, the layouts it picks between:
    one lane a warp and, at adapter rungs 16-24 and 48, the narrow one) of
    a score or stats launch; (1, [1]) for the trace-bit kernel, which runs
    one lane a warp."""
    narrow = kernels.narrow_group(A)
    if name not in ('forward_score', 'forward_stats') or narrow is None:
        return 1, [1]
    return kernels.lane_group(name, B, A), [1, narrow]


def check_kernels(kernels, specs=KERNELS, seed=0):
    """Each kernel of specs against its plain version at its shapes (by
    default the main path's), score and stats in both layouts at adapter
    rungs 16-24 and 48 (one lane a warp, and four or two): exact, and
    timed in the layout the wrapper picks."""
    results = {}
    for n, (name, spec_) in enumerate(specs.items()):
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + '_plain')
        rows = []
        for m, (what, B, L, A) in enumerate(spec_['shapes']):
            x = _inputs(B, L, A, seed=seed + 10 * n + m, what=what)
            group, allowed = layouts(kernels, name, B, A)
            want, plain_ms = _once_ms(lambda: plain(*x, *SCHEME))
            err = 0
            for g in allowed:
                got = (kern(*x, *SCHEME) if len(allowed) == 1
                       else kern(*x, *SCHEME, group=g))
                torch.cuda.synchronize()
                if name == 'forward_score':
                    got, want_ = [got], [want]
                else:
                    want_ = want
                if name == 'forward_tiled':
                    err = _bits_err(got[0], want[0], x[1], x[3])
                    got, want_ = got[1:], want[1:]
                err = max(err, _max_err(got, want_))
                if err != 0:
                    raise AssertionError(
                        '%s disagrees with its plain version at %s (%d x %d '
                        'x %d, %d lanes a warp): max |err| %d'
                        % (name, what, B, L, A, g, err))
                del got
            del want
            rows.append(_row(name, what, B, L, A,
                             _kernel_ms(lambda: kern(*x, *SCHEME)), plain_ms,
                             _bound(name, B, L, A, x[1], x[3]), err,
                             layout=kernels.wave_layout(A, group),
                             group=group, layouts_checked=allowed))
            del x
        results[name] = rows
    return results


def _walk_bound(walk):
    """Least time for a walk: each walked byte read once (one a move),
    cell_i, cell_j and the two flags read (10 bytes a lane), the 40-byte
    aggregates written, over the memory rate; no arithmetic to speak of.
    The kernel is bound instead by the chain of block loads and moves of
    its longest lane, so that lane's moves come with it."""
    moves = walk[:, 2].long()
    nbytes = int(moves.sum()) + 50 * walk.shape[0]
    return nbytes / MEM_BPS * 1e3, int(moves.max())


def check_trace_bits(kernels, shapes, seed=200, walk_only=False):
    """At each trace-bit shape (what, B, L, A): forward_tiled against
    forward_tiled_plain (bits in the walker's region, best, cells, flags),
    the standalone walk on its bits and forward_walk against walk_plain on
    the plain bits, exact, each timed.  With walk_only, the walk alone
    (the main path's shapes, whose forwards check_kernels holds).  Returns
    {kernel: rows}."""
    rows = {'forward_tiled': [], 'walk': [], 'forward_walk': []}
    for m, (what, B, L, A) in enumerate(shapes):
        x = _inputs(B, L, A, seed=seed + m, what=what)
        (bits_p, best_p, ci_p, cj_p, vf_p, hf_p), fwd_ms = _once_ms(
            lambda: kernels.forward_tiled_plain(*x, *SCHEME))
        walk_p, walk_ms = _once_ms(
            lambda: kernels.walk_plain(bits_p, ci_p, cj_p, vf_p, hf_p))
        tiled = kernels.forward_tiled(*x, *SCHEME)
        bits, _, ci, cj, vf, hf = tiled
        walk = kernels.walk(bits, ci, cj, vf, hf)
        fused = kernels.forward_walk(*x, *SCHEME)
        torch.cuda.synchronize()
        errs = {'forward_tiled': max(
                    _bits_err(bits, bits_p, x[1], x[3]),
                    _max_err(tiled[1:], (best_p, ci_p, cj_p, vf_p, hf_p))),
                'walk': _max_err([walk], [walk_p]),
                'forward_walk': _max_err(fused,
                                         (walk_p, best_p, ci_p, cj_p))}
        for name, err in errs.items():
            if err != 0:
                raise AssertionError('%s disagrees with its plain version '
                                     'at %s (%d x %d x %d): max |err| %d'
                                     % (name, what, B, L, A, err))
        bound_ms, moves = _walk_bound(walk)
        rows['walk'].append(_row(
            'walk', what, B, L, A,
            _kernel_ms(lambda: kernels.walk(bits, ci, cj, vf, hf)), walk_ms,
            (B, (bound_ms, 'bytes')), 0, moves=moves,
            walked_bytes=int(walk[:, 2].long().sum())))
        if not walk_only:
            for name, plain_ms in (('forward_tiled', fwd_ms),
                                   ('forward_walk', fwd_ms + walk_ms)):
                kern = getattr(kernels, name)
                rows[name].append(_row(
                    name, what, B, L, A, _kernel_ms(lambda: kern(*x, *SCHEME)),
                    plain_ms, _bound(name, B, L, A, x[1], x[3]), 0))
        del x, tiled, bits, walk, fused, bits_p, walk_p
    return rows


def make_input(what, work, reads, reads_sha):
    """Writes reads() to work/reads.fastq and checks its digest (unless
    reads_sha is None: no digests recorded on it); returns (reads,
    bases)."""
    from porechop_tpu_torch.utils.synth import write_fastq
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    reads = reads()
    write_fastq(str(work / 'reads.fastq'), reads)
    if reads_sha is not None and _sha(work / 'reads.fastq') != reads_sha:
        raise AssertionError('synthetic %s input differs from the one the '
                             'reference digests were recorded on' % what)
    size = len(reads), sum(len(r[1]) for r in reads)
    print('synthesised the %s input, %d reads, %d bp, in %.1f s'
          % (what, size[0], size[1], time.perf_counter() - t0), flush=True)
    return size


def _fresh_dir(work, name, reads='reads.fastq'):
    """work/name, emptied, holding a link to work/reads."""
    d = work / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    os.symlink(work / reads, d / reads)
    return d


def _sha(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cards():
    return range(torch.cuda.device_count())


@contextlib.contextmanager
def environment(**names):
    """The variables `names` set in os.environ inside the block."""
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _routes():
    from porechop_tpu_torch.ops import dispatch
    return {r: list(v) for r, v in dispatch.ROUTES.items()}


def run_cli(cli, kernels, label, d, argv, size, on_card=True):
    """One in-process run of the trimmer in directory d, on the card.
    With on_card, every kernel of the path must launch and no other, on
    every device that --device names in argv (without it, on every card:
    a single process splits over all of them), each trace-bit call
    walking inside its launch; without on_card, none may, and nothing may
    be allocated on a card.  On two or more distinct cards (check_cards)
    each card must launch every kernel that the run launches, the same
    number of times but for the middle phase's replay, which runs on the
    first card alone.  Returns (its launches, its trace-bit launch
    shapes, its stdout with d's path as <WORKDIR>)."""
    from porechop_tpu_torch.ops import dispatch
    kernels.reset_launches()
    dispatch.reset_routes()
    for k in _cards():
        torch.cuda.reset_peak_memory_stats(k)
    buf = io.StringIO()
    os.chdir(d)
    try:
        with replay_launches(kernels) as replayed:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            for k in _cards():
                torch.cuda.synchronize(k)
            wall = time.perf_counter() - t0
    finally:
        os.chdir(ROOT)
    launches = dict(kernels.LAUNCHES)
    tiled = sorted(kernels.TILED_CALLS.items())
    peaks = ', '.join('cuda:%d %.1f' % (k, torch.cuda.max_memory_allocated(k)
                                         / 2 ** 20) for k in _cards())
    print('%s: %.2f s wall, %.1f reads/s, %.4g bases/s, peak device memory '
          '%s MiB, launches %s, by device %s' % (
              label, wall, size[0] / wall, size[1] / wall, peaks, launches,
              dict(kernels.DEVICE_LAUNCHES)), flush=True)
    print('  forward_tiled launches by (lanes, L, A, chunks): %s'
          % ', '.join('%s x %d' % (k, n) for k, n in tiled), flush=True)
    print('  score and stats launches by instantiation (AMAX/LW): %s'
          % ', '.join('%s %s x %d' % (*k, n) for k, n in
                      sorted(kernels.WAVE_CALLS.items())), flush=True)
    WAVE_TOTAL.update(kernels.WAVE_CALLS)
    routes = _routes()
    print('  routes (jobs, padded cells): %s' % ', '.join(
        '%s %d, %.4g' % (r, n, c) for r, (n, c) in routes.items()),
          flush=True)
    if on_card:
        want = set(PATH_KERNELS)
        idle = [k for k in sorted(want) if launches[k] == 0]
        if idle:
            raise AssertionError('%s never launched %s' % (label, idle))
        extra = [k for k in ALL_KERNELS if k not in want and launches[k]]
        if extra:
            raise AssertionError('%s launched %s' % (label, extra))
        named = (['cuda:%d' % k for k in _cards()] if '--device' not in argv
                 else argv[argv.index('--device') + 1].split(','))
        cards = sorted(set(named), key=named.index)
        stray = {dev for _, dev in kernels.DEVICE_LAUNCHES} - set(cards)
        if stray:
            raise AssertionError('%s launched on %s, which it was not given'
                                 % (label, sorted(stray)))
        idle = set(cards) - {dev for _, dev in kernels.DEVICE_LAUNCHES}
        if idle:
            raise AssertionError('%s launched nothing on %s'
                                 % (label, sorted(idle)))
        check_cards(label, cards, launches, kernels.DEVICE_LAUNCHES,
                    replayed)
        _check_walks(label, launches, kernels.DEVICE_LAUNCHES,
                     kernels.TILED_CALLS)
    else:
        if any(launches.values()) or routes['device'][0]:
            raise AssertionError('%s launched kernels on the host route: %s'
                                 % (label, launches))
        held = [k for k in _cards() if torch.cuda.max_memory_allocated(k)]
        if held:
            raise AssertionError('%s allocated memory on cards %s'
                                 % (label, held))
    return launches, tiled, buf.getvalue().replace(str(d), '<WORKDIR>')


@contextlib.contextmanager
def replay_launches(kernels):
    """The launches of each kernel made inside the middle phase's device
    replay (middle.ReplayRunner.round) within the block, into a Counter."""
    from porechop_tpu_torch.ops import middle
    counts = collections.Counter()
    round_ = middle.ReplayRunner.round

    def counting(self, *args, **kwargs):
        before = dict(kernels.LAUNCHES)
        try:
            return round_(self, *args, **kwargs)
        finally:
            counts.update({k: n - before[k]
                           for k, n in kernels.LAUNCHES.items()})
    middle.ReplayRunner.round = counting
    try:
        yield counts
    finally:
        middle.ReplayRunner.round = round_


def check_cards(label, cards, launches, by_device, replayed):
    """For a run over two or more distinct cards (device names, the first
    one first): every kernel that the run launched, launched on every
    card, each card but the first as often as the others, and the first
    card's surplus exactly the replay's launches (replayed: a Counter),
    the one device call of the run that does not split, as in the JAX
    package, whose replay does not shard either.  Prints the launches by
    card and what ran on the first card alone."""
    if len(cards) < 2:
        return
    ran = [k for k in ALL_KERNELS if launches[k]]
    table = {k: [by_device[(k, c)] for c in cards] for k in ran}
    print('  launches by card (%s): %s; on %s alone: the replay\'s %s'
          % (', '.join(cards), table, cards[0], dict(+replayed)), flush=True)
    for k, n in table.items():
        if not all(n) or len(set(n[1:])) != 1 \
                or n[0] - n[1] != replayed[k]:
            raise AssertionError(
                '%s: %s launched %s on %s, the replay %d of them'
                % (label, k, n, cards, replayed[k]))


def _check_walks(label, launches, by_device=None, calls=None):
    """Every trace-bit call walked inside its own launch: forward_walk,
    never forward_tiled and the standalone walk, on every device
    (DEVICE_LAUNCHES) and, given the calls by shape (TILED_CALLS), one
    forward_walk launch a call."""
    if launches['walk'] or launches['forward_tiled']:
        raise AssertionError('%s: %d standalone walks and %d forward_tiled '
                             'launches on the path' % (
                                 label, launches['walk'],
                                 launches['forward_tiled']))
    stray = sorted(dev for (name, dev), n in (by_device or {}).items()
                   if name in ('walk', 'forward_tiled') and n)
    if stray:
        raise AssertionError('%s: a standalone walk or forward_tiled '
                             'launched on %s' % (label, stray))
    if calls is not None and sum(calls.values()) != launches['forward_walk']:
        raise AssertionError('%s: %d trace-bit calls, %d forward_walk '
                             'launches' % (label, sum(calls.values()),
                                           launches['forward_walk']))


def _check_text(label, d, text, want_sha):
    got = hashlib.sha256(text.encode()).hexdigest()
    if got != want_sha:
        (d / 'stdout.txt').write_text(text)
        raise AssertionError('%s stdout differs from the JAX package '
                             '(sha256 %s)' % (label, got))


def run_main_path(cli, kernels, what, work, size, out_sha, stdout_sha,
                  stream=None, split=False, flags=(), verbosities=(0, 1),
                  on_card=True):
    """One input (work/reads.fastq) through the trimming run to -o, on the
    card, at -v 0 and -v 1, in memory or with --stream, with flags added;
    with split, each run must cut at least one trace-bit launch into
    column chunks; without on_card, no run may launch a kernel.  Returns
    {run label: launches of that run}."""
    mode = '' if stream is None else ' --stream %d' % stream
    mode += ''.join(' ' + f for f in flags)
    launches = {}
    for v in verbosities:
        label = '%s%s -v %d' % (what, mode, v)
        d = _fresh_dir(work, ('mem' if stream is None else 'stream')
                       + '_v%d' % v)
        out = 'out_v%d.fastq' % v
        argv = ['-i', 'reads.fastq', '-o', out, '-v', str(v), '-t', '4']
        if stream is not None:
            argv += ['--stream', str(stream)]
        launches[label], tiled, text = run_cli(cli, kernels, label, d,
                                               argv + list(flags), size,
                                               on_card)
        got_out = _sha(d / out)
        if got_out != out_sha[v]:
            raise AssertionError('%s output FASTQ differs from the JAX '
                                 'package (sha256 %s)' % (label, got_out))
        _check_text(label, d, text, stdout_sha[v])
        if split and not any(k[3] > 1 for k, _ in tiled):
            raise AssertionError('%s never split a trace-bit launch' % label)
    return launches


def run_barcoded(cli, kernels, work, size, stream=None, flags=(),
                 verbosities=(0, 1)):
    """The barcoded input binned with -b at -v 0 and -v 1, in memory or
    with --stream, with flags added; every run's bins against the JAX
    package's -v 1 bins, and every run's trace-bit calls at the middle's
    rung (10,240) and adapter rung 96 (AMAX 96) cut into column chunks
    (there must be some)."""
    mode = '' if stream is None else ' --stream %d' % stream
    mode += ''.join(' ' + f for f in flags)
    launches = {}
    for v in verbosities:
        label = 'barcoded -b%s -v %d' % (mode, v)
        d = _fresh_dir(work, ('mem' if stream is None else 'stream')
                       + '_v%d' % v)
        argv = ['-i', 'reads.fastq', '-b', 'bins', '-v', str(v), '-t',
                '4'] + list(flags)
        if stream is not None:
            argv += ['--stream', str(stream)]
        launches[label], tiled, text = run_cli(cli, kernels, label, d,
                                               argv, size)
        check_rung96_split(label, tiled)
        got = {f: _sha(d / 'bins' / f) for f in sorted(os.listdir(d /
                                                                  'bins'))}
        if got != BARCODED_BIN_SHA:
            raise AssertionError('%s bins differ from the JAX package: %s'
                                 % (label, {f: h for f, h in got.items()
                                            if BARCODED_BIN_SHA.get(f) != h}))
        _check_text(label, d, text, BARCODED_STDOUT_SHA[v])
    return launches


def check_rung96_split(label, tiled):
    """The barcoded middle's trace-bit calls (rung 10,240, adapter rung 96:
    AMAX 96) among a run's calls by (lanes, L, A, chunks) (`tiled`, the
    sorted items of kernels.TILED_CALLS): there are some, and each cut its
    lanes into column chunks."""
    rung96 = [k for k, _ in tiled if k[1:3] == (10240, 96)]
    if not rung96 or any(k[3] < 2 for k in rung96):
        raise AssertionError('%s: trace-bit calls at rung 10,240 and adapter '
                             'rung 96 by (lanes, L, A, chunks): %s, not all '
                             'split' % (label, rung96))


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_two_ranks(work, size, shapes, stream=None, what='10 kb',
                  reads='reads.fastq', out='out_v1.fastq', out_sha=OUT_SHA[1],
                  stdout_sha=STDOUT_SHA[1], load_stats=False):
    """The input (work/reads) at -v 1 as two torch.distributed ranks,
    rank r on cuda:(r % cards): sharing the one card, or on two distinct
    cards where there are two, each rank launching on its card alone.
    The merged output and rank 0's transcript must be the JAX package's
    (by default the 10 kb input's).  With load_stats, under
    PORECHOP_TPU_LOAD_STATS: each rank must have built fewer reads than
    the input holds.  Adds the ranks' kernel call shapes to shapes;
    returns the launches of both ranks together."""
    mode = '' if stream is None else ' --stream %d' % stream
    label = '%s two ranks%s -v 1' % (what, mode)
    d = _fresh_dir(work, 'ranks' + ('_mem' if stream is None else '_stream'),
                   reads)
    argv = ['-i', reads, '-o', out, '-v', '1', '-t', '4']
    if stream is not None:
        argv += ['--stream', str(stream)]
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PORECHOP_TPU_COORDINATOR='127.0.0.1:%d' % port,
                   PORECHOP_TPU_NUM_PROCS='2', PORECHOP_TPU_PROC_ID=str(r))
        if load_stats:
            env['PORECHOP_TPU_LOAD_STATS'] = str(d / 'loadstats')
        procs.append(subprocess.Popen(
            [sys.executable, '-c', RANK_CODE] + argv, cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError('%s: rank %d exited %d:\n%s' % (
                label, r, p.returncode, err.decode()[-3000:]))
    stats = [json.loads([ln for ln in err.decode().splitlines()
                         if ln.startswith('{"peak_bytes"')][-1])
             for _, err in outs]
    launches = {k: sum(s_['launches'][k] for s_ in stats)
                for k in ALL_KERNELS}
    for s_ in stats:
        for name, seen in s_['shapes'].items():
            shapes[name].update(tuple(x) for x in seen)
            for card in s_['cards']:
                shapes['by_device'][(name, card)].update(
                    tuple(x) for x in seen)
    print('%s: %.2f s wall (two processes, start-up included), %.1f reads/s, '
          'cards by rank %s, peak device memory by rank %s MiB, launches '
          '%s, routes (jobs, padded cells) by rank %s' % (
              label, wall, size[0] / wall, [s_['cards'] for s_ in stats],
              ['%.1f' % (s_['peak_bytes'] / 2 ** 20) for s_ in stats],
              [s_['launches'] for s_ in stats],
              [s_['routes'] for s_ in stats]), flush=True)
    want_cards = [['cuda:%d' % (r % torch.cuda.device_count())]
                  for r in range(2)]
    if [s_['cards'] for s_ in stats] != want_cards:
        raise AssertionError('%s: the ranks launched on %s, not on %s'
                             % (label, [s_['cards'] for s_ in stats],
                                want_cards))
    for r, s_ in enumerate(stats):
        idle = [k for k in PATH_KERNELS if s_['launches'][k] == 0]
        if idle:
            raise AssertionError('%s: rank %d never launched %s'
                                 % (label, r, idle))
        _check_walks('%s rank %d' % (label, r), s_['launches'])
    got_out = _sha(d / out)
    if got_out != out_sha:
        raise AssertionError('%s merged output differs from the JAX '
                             'package (sha256 %s)' % (label, got_out))
    _check_text(label, d, outs[0][0].decode().replace(str(d), '<WORKDIR>'),
                stdout_sha)
    if outs[1][0]:
        raise AssertionError('%s: rank 1 wrote to stdout' % label)
    if load_stats:
        built = [json.loads((d / ('loadstats.rank%d' % r)).read_text())
                 for r in range(2)]
        print('  reads built by rank (PORECHOP_TPU_LOAD_STATS): %s'
              % built, flush=True)
        if not all(b['materialized'] < b['total'] for b in built):
            raise AssertionError('%s: a rank built every read: %s'
                                 % (label, built))
    return {label: launches}


@contextlib.contextmanager
def recorded_shapes(kernels):
    """Records the (lanes, L, A) of every call of each forward wrapper made
    inside the block, and the (lanes, L1p, A) of the bits of every
    standalone walk, into {kernel: set of shapes}; counts the calls of
    each forward wrapper by (kernel, lanes, L, A) into shapes['calls'],
    the forward_walk launches by (one tile, given a trace-bit tensor) into
    shapes['bits'] (Counters), and the shapes of each wrapper's calls on
    each card into shapes['by_device'][(kernel, 'cuda:k')]."""
    shapes = {name: set() for name in ALL_KERNELS}
    shapes['bits'] = collections.Counter()
    shapes['calls'] = collections.Counter()
    shapes['by_device'] = collections.defaultdict(set)
    saved = {name: getattr(kernels, name) for name in ALL_KERNELS}
    launch = kernels._launch

    def recording(name, fn):
        def call(reads, read_lens, adapters, *rest):
            shape = (*reads.shape, adapters.shape[1])
            shapes[name].add(shape)
            shapes['calls'][(name, *shape)] += 1
            shapes['by_device'][(name, str(reads.device))].add(shape)
            return fn(reads, read_lens, adapters, *rest)
        return call

    def walking(bits, *rest):
        shapes['walk'].add((bits.shape[1], bits.shape[2], bits.shape[0]))
        return saved['walk'](bits, *rest)

    def launching(name, reads, *rest):
        if name == 'forward_walk':
            one_tile = kernels.tiled_l1p(reads.shape[1]) == kernels.TILE_T
            shapes['bits'][(one_tile, rest[-1][0] is not None)] += 1
        return launch(name, reads, *rest)
    for name, fn in saved.items():
        setattr(kernels, name, recording(name, fn) if name != 'walk'
                else walking)
    kernels._launch = launching
    try:
        yield shapes
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
        kernels._launch = launch


def check_no_bits_on_one_tile(bits):
    """Every one-tile forward_walk launch of the runs allocated no trace
    bits (there was at least one), and every other launch did."""
    print('forward_walk launches by (one tile, trace-bit tensor): %s'
          % dict(bits), flush=True)
    if not bits[(True, False)] or bits[(True, True)] or bits[(False, False)]:
        raise AssertionError('trace-bit tensors of forward_walk launches by '
                             '(one tile, allocated): %s' % dict(bits))


def entry_runs(cli, kernels, flags, inputs):
    """The 10 kb input at -v 0/-v 1 and the barcoded one with -b at -v 1,
    in memory, with flags added: {run label: launches}."""
    (work, size), (bc_work, bc_size) = inputs
    runs = run_main_path(cli, kernels, '10 kb', work, size, OUT_SHA,
                         STDOUT_SHA, flags=flags)
    runs.update(run_barcoded(cli, kernels, bc_work, bc_size, flags=flags,
                             verbosities=(1,)))
    return runs


def run_entries(cli, kernels, entries, inputs, one_entry, one_flag=''):
    """entry_runs with their lanes split over the device entries (--device
    entries): the digests they already have, every named device
    launching (run_cli), and each kernel launched more often than in the
    same run on one entry (one_entry: {run label: launches}, its labels
    holding one_flag where these hold the --device flag), since each
    planner launch becomes one per entry (the middle phase's replay does
    not split).  Returns {run label: launches}."""
    runs = entry_runs(cli, kernels, ['--device', entries], inputs)
    for label, launches in runs.items():
        one = one_entry[label.replace(' --device ' + entries, one_flag)]
        unsplit = [k for k in PATH_KERNELS if launches[k] <= one[k]]
        if unsplit:
            raise AssertionError('%s: %s launched no more often than on one '
                                 'entry (%s vs %s)' % (label, unsplit,
                                                       launches, one))
    return runs


def check_launched_shapes(kernels, shapes, timings, seed=100):
    """Each kernel against its plain version at every shape the on-card
    runs launched it at that the first checks did not already hold, added
    to timings: score and stats alone, and at every trace-bit shape
    forward_tiled, the standalone walk and forward_walk together
    (check_trace_bits).  No run may have launched the standalone walk."""
    if shapes['walk']:
        raise AssertionError('standalone walks at %s' % sorted(shapes['walk']))
    for name in ('forward_score', 'forward_stats'):
        known = {(r['lanes'], r['L'], r['A']) for r in timings[name]}
        todo = sorted(shapes[name] - known)
        print('%s: %d launched shapes to check' % (name, len(todo)),
              flush=True)
        timings[name] += check_kernels(
            kernels, {name: dict(KERNELS[name], shapes=[
                ('launched by the runs', *shape) for shape in todo])},
            seed=seed)[name]
    known = {(r['lanes'], r['L'], r['A']) for r in timings['forward_walk']}
    todo = sorted((shapes['forward_walk'] | shapes['forward_tiled']) - known)
    print('trace bits: %d launched shapes to check' % len(todo), flush=True)
    rows = check_trace_bits(kernels, [('launched by the runs', *shape)
                                      for shape in todo], seed + 200)
    for name, got in rows.items():
        timings[name] += got


def check_other_cards(kernels, by_device, cards):
    """On each card of `cards` (indices: every card but cuda:0), each
    kernel against its plain version at shapes the runs launched it at on
    that card (by_device, from recorded_shapes): score and stats at their
    smallest (in cells), and at forward_walk's smallest one-tile and
    smallest multi-tile shape forward_tiled, the standalone walk and
    forward_walk (check_trace_bits); exact.  Every one of these launches
    must land on that card."""
    for k in cards:
        card = 'cuda:%d' % k
        seen = {name: sorted(by_device.get((name, card), ()),
                             key=lambda x: (x[0] * x[1] * x[2], x))
                for name in PATH_KERNELS}
        idle = [name for name, shapes in seen.items() if not shapes]
        if idle:
            raise AssertionError('no run launched %s on %s' % (idle, card))
        tiles = [[x for x in seen['forward_walk']
                  if (kernels.tiled_l1p(x[1]) == kernels.TILE_T) == one][:1]
                 for one in (True, False)]
        bits = [x for pick in tiles for x in pick]
        what = 'launched on ' + card
        kernels.reset_launches()
        with torch.cuda.device(k):
            check_kernels(kernels, {
                name: dict(KERNELS[name], shapes=[(what, *seen[name][0])])
                for name in ('forward_score', 'forward_stats')}, seed=300)
            check_trace_bits(kernels, [(what, *x) for x in bits], seed=400)
        where = {dev for (_, dev), n in kernels.DEVICE_LAUNCHES.items() if n}
        idle = [name for name in ALL_KERNELS
                if not kernels.DEVICE_LAUNCHES[(name, card)]]
        if where != {card} or idle:
            raise AssertionError('the checks on %s launched on %s, and '
                                 'never launched %s there'
                                 % (card, sorted(where), idle))
        print('kernels on %s against their plain versions, max |err| 0 at '
              'score %s, stats %s, trace bits %s'
              % (card, seen['forward_score'][0], seen['forward_stats'][0],
                 bits), flush=True)


def one_card_runs(cli, kernels, inputs):
    """On a host with several cards, where a run with no --device splits
    over all of them: entry_runs on cuda:0 alone, the one entry that
    run_entries holds the entry runs against."""
    return entry_runs(cli, kernels, ['--device', 'cuda:0'], inputs)


def forced_host_runs(cli, kernels, work, size):
    """The 10 kb input against the default digests under
    PORECHOP_TPU_FORCE_HOST=1 (-v 0, -v 1: no launch, nothing on the
    card, every job on the host route).  Returns {run label: launches}."""
    runs = {}
    with environment(PORECHOP_TPU_FORCE_HOST='1'):
        for v in (0, 1):
            runs.update(run_main_path(cli, kernels, '10 kb forced host',
                                      work, size, OUT_SHA, STDOUT_SHA,
                                      verbosities=(v,), on_card=False))
            if not _routes()['host'][0]:
                raise AssertionError('a forced-host run took no host jobs')
    return runs


def stretch_runs(cli, kernels, shapes):
    """The stretch input's head (stretch_torch.py: 200,000 gzipped 1 kb
    reads, written by the pool), streamed in chunks of 20,000: in this
    process at -v 0 and as two ranks at -v 1, each against the JAX
    package's digests, every kernel of the path launching.  In the
    in-process run the device memory allocated after the last chunk must
    be within 1 MiB of that after the first (read after each chunk, when
    the chunk loop counts its trims).  Returns {run label: launches}."""
    import stretch_torch
    from porechop_tpu_torch.pipeline import stream
    n, chunk = STRETCH_READS, stretch_torch.CHUNK
    work = WORK / 'stretch'
    path, made_s = stretch_torch.make_input(n, work)
    print('wrote the stretch input, %d gzipped reads, in %.1f s'
          % (n, made_s), flush=True)
    # As the digests were recorded: the input named reads.fastq.gz, which
    # the -v 1 transcript prints.
    reads = 'reads.fastq.gz'
    if not (work / reads).is_symlink():
        os.symlink(path, work / reads)
    # Bases: the reads' 1 kb bodies (adapters not counted).
    size = n, n * stretch_torch.READ_LEN
    label = 'stretch %dk gz --stream %d -v 0' % (n // 1000, chunk)
    d = _fresh_dir(work, 'stream_v0', reads)
    after_chunk = []
    trim_counts = stream.trim_counts

    def counting(done):
        after_chunk.append(sum(torch.cuda.memory_allocated(k)
                               for k in _cards()))
        return trim_counts(done)
    stream.trim_counts = counting
    calls = shapes['calls'].copy()
    try:
        launches, _, text = run_cli(
            cli, kernels, label, d,
            ['-i', reads, '-o', 'out.fastq', '-v', '0', '-t', '4',
             '--stream', str(chunk)], size)
    finally:
        stream.trim_counts = trim_counts
    runs = {label: launches}
    print('  calls by (kernel, lanes, L, A): %s' % ', '.join(
        '%s x %d' % (k, c) for k, c in sorted((shapes['calls'] - calls)
                                              .items())), flush=True)
    want_out, want_text = stretch_torch.JAX_SHA[(n, 0)]
    if _sha(d / 'out.fastq') != want_out:
        raise AssertionError('%s output differs from the JAX package' % label)
    _check_text(label, d, text, want_text)
    growth = (after_chunk[-1] - after_chunk[0]) / 2 ** 20
    print('  device memory allocated after each of %d chunks, MiB: %s'
          % (len(after_chunk), ', '.join('%.2f' % (b / 2 ** 20)
                                         for b in after_chunk)), flush=True)
    if len(after_chunk) != n // chunk or abs(growth) > 1:
        raise AssertionError('%s: %d chunks, device memory after the last '
                             'minus after the first %.2f MiB'
                             % (label, len(after_chunk), growth))
    out_sha, stdout_sha = stretch_torch.JAX_SHA[(n, 1)]
    runs.update(run_two_ranks(work, size, shapes, chunk,
                              'stretch %dk gz' % (n // 1000), reads,
                              'out.fastq', out_sha, stdout_sha))
    return runs


def on_card_runs(cli, kernels, shapes):
    """Every run of the trimmer but the instruments', in the order the
    module docstring gives; shapes collects the two-rank runs' kernel call
    shapes.  Returns ({run label: launches}, the 10 kb input's (work
    directory, size))."""
    from porechop_tpu_torch.utils.synth import (LONG_READ_PARTS,
                                                 synth_barcoded, synth_mixed,
                                                 synth_reads)
    runs = {}
    work = WORK
    size = make_input('10 kb', work,
                      lambda: synth_reads(8192, 10000, seed=0), READS_SHA)
    for stream in (None, 2048):
        runs.update(run_main_path(cli, kernels, '10 kb', work, size, OUT_SHA,
                                  STDOUT_SHA, stream=stream))
    long_work = WORK / 'long'
    long_size = make_input('long-read', long_work,
                           lambda: synth_mixed(LONG_READ_PARTS),
                           LONG_READS_SHA)
    for stream in (None, 640):
        runs.update(run_main_path(cli, kernels, 'long-read', long_work,
                                  long_size, LONG_OUT_SHA, LONG_STDOUT_SHA,
                                  stream=stream, split=True))
    bc_work = WORK / 'barcoded'
    bc_size = make_input('barcoded', bc_work,
                         lambda: synth_barcoded(8192, 10000, seed=0),
                         BARCODED_READS_SHA)
    # Streamed in two chunks: four took 25 s a run on the H100.
    for stream in (None, 4096):
        runs.update(run_barcoded(cli, kernels, bc_work, bc_size,
                                 stream=stream))
    for stream in (None, 2048):
        runs.update(run_two_ranks(work, size, shapes, stream=stream,
                                  load_stats=stream is None))
    runs.update(stretch_runs(cli, kernels, shapes))

    # Schemes the kernels refuse: on the host, no launch.
    runs.update(run_main_path(cli, kernels, '10 kb', work, size,
                              GOTOH_OUT_SHA, GOTOH_STDOUT_SHA,
                              flags=GOTOH_FLAGS, on_card=False))
    lin_work = WORK / 'linear'
    lin_size = make_input('linear-scheme', lin_work,
                          lambda: synth_reads(16, 1000, seed=0),
                          LINEAR_READS_SHA)
    runs.update(run_main_path(cli, kernels, '16 x 1 kb', lin_work, lin_size,
                              LINEAR_OUT_SHA, LINEAR_STDOUT_SHA,
                              flags=LINEAR_FLAGS, verbosities=(1,),
                              on_card=False))

    # Device entries: two on the one card, and two cards where there are
    # (the runs above then split over every card, so the entries are held
    # against runs on cuda:0 alone).
    inputs = ((work, size), (bc_work, bc_size))
    one, one_flag = runs, ''
    entry_lists = ['cuda:0,cuda:0']
    if torch.cuda.device_count() > 1:
        entry_lists.append('cuda:0,cuda:1')
        one, one_flag = one_card_runs(cli, kernels, inputs), ' --device cuda:0'
        runs.update(one)
    for entries in entry_lists:
        runs.update(run_entries(cli, kernels, entries, inputs, one,
                                one_flag))

    runs.update(forced_host_runs(cli, kernels, work, size))
    return runs, (work, size)


def instrument_runs(cli, kernels, work, size):
    """The 10 kb input at -v 0 against the default digests under
    PORECHOP_TPU_TIMING=1 (the five `[timing] phase` lines on stderr, in
    order) and under PORECHOP_TPU_PROFILE=<dir> (one Chrome trace whose
    kernel events name the port's CUDA kernels), then `bench_torch.py
    --runs 1 --warmups 0` as a child: its JSON line must say `correct`
    and hold the card's and the forced host's values.  Returns {run
    label: launches}."""
    err = io.StringIO()
    with environment(PORECHOP_TPU_TIMING='1'), \
            contextlib.redirect_stderr(err):
        runs = run_main_path(cli, kernels, '10 kb timed', work, size,
                             OUT_SHA, STDOUT_SHA, verbosities=(0,))
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith('[timing] ')]
    print('  %d timing lines; phases: %s' % (len(lines), '; '.join(
        ' '.join(ln.split()[2:]) for ln in lines if ' phase ' in ln)),
          flush=True)
    labels = [ln.split()[2] for ln in lines if ' phase ' in ln]
    if labels != ['load', 'detect', 'endtrim', 'middle', 'output']:
        raise AssertionError('the timed run printed the phases %s' % labels)
    trace_dir = WORK / 'profile'
    shutil.rmtree(trace_dir, ignore_errors=True)
    with environment(PORECHOP_TPU_PROFILE=str(trace_dir)):
        runs.update(run_main_path(cli, kernels, '10 kb profiled', work,
                                  size, OUT_SHA, STDOUT_SHA,
                                  verbosities=(0,)))
    traces = os.listdir(trace_dir)
    if len(traces) != 1:
        raise AssertionError('the profiled run wrote %s' % traces)
    with open(trace_dir / traces[0]) as f:
        events = json.load(f)['traceEvents']
    named = collections.Counter(e['name'] for e in events
                                if e.get('cat') == 'kernel')
    ours = {k: n for k, n in named.items() if 'dp_wave_kernel' in k}
    print('  profile %s: %d kernel events, the port\'s: %s'
          % (traces[0], sum(named.values()), ours), flush=True)
    if not ours:
        raise AssertionError('the trace names none of the port\'s kernels: '
                             '%s' % sorted(named)[:10])
    t0 = time.perf_counter()
    # No warm-up: the runs above left the input's and libraries' pages
    # in memory.
    r = subprocess.run([sys.executable, str(ROOT / 'bench_torch.py'),
                        '--runs', '1', '--warmups', '0'], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError('bench_torch.py exited %d:\n%s'
                             % (r.returncode, r.stderr[-3000:]))
    line = json.loads(r.stdout.splitlines()[-1])
    print('bench_torch.py --runs 1 --warmups 0 (%.1f s): %s'
          % (time.perf_counter() - t0, json.dumps(line)), flush=True)
    if not (line['correct'] is True and line['value'] > 0
            and line['baseline_value'] > 0 and line['device'] == 'card'):
        raise AssertionError('bench_torch.py: %s' % line)
    return runs


def dry_run(kernels):
    """The dry-run entry points (porechop_tpu_torch/entry.py): the flagship
    step on the card against the same step on the CPU (the plain
    versions), then the multi-device dry run on two entries on cuda:0,
    which checks itself, and on a host with n >= 2 cards on the real
    cards (dryrun_multichip(n) with no device), each card launching every
    kernel of the path."""
    from porechop_tpu_torch import entry
    t0 = time.perf_counter()
    fn, args = entry.entry()
    got = fn(*args)
    want = fn(*(x.cpu() for x in args))
    for g, w in zip(got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError('entry() on the card differs from the CPU')
    kernels.reset_launches()
    entry.dryrun_multichip(2, 'cuda:0,cuda:0')
    launches = dict(kernels.LAUNCHES)
    idle = [k for k in PATH_KERNELS if not launches[k]]
    if idle:
        raise AssertionError('the dry run never launched %s' % idle)
    _check_walks('dry run', launches, kernels.DEVICE_LAUNCHES,
                 kernels.TILED_CALLS)
    print('dry run (entry, dryrun_multichip(2) on cuda:0,cuda:0): %.2f s, '
          'launches %s' % (time.perf_counter() - t0, launches), flush=True)
    n = torch.cuda.device_count()
    if n < 2:
        return
    t0 = time.perf_counter()
    kernels.reset_launches()
    entry.dryrun_multichip(n)
    cards = ['cuda:%d' % k for k in range(n)]
    table = {k: [kernels.DEVICE_LAUNCHES[(k, c)] for c in cards]
             for k in PATH_KERNELS}
    if not all(all(v) for v in table.values()):
        raise AssertionError('dryrun_multichip(%d) launched %s on %s'
                             % (n, table, cards))
    _check_walks('dry run on %d cards' % n, kernels.LAUNCHES,
                 kernels.DEVICE_LAUNCHES, kernels.TILED_CALLS)
    print('dry run (dryrun_multichip(%d) on the cards): %.2f s, launches by '
          'card (%s) %s' % (n, time.perf_counter() - t0, ', '.join(cards),
                            table), flush=True)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
          % {a: kernels.card_warps(a) for a in (32, 64, 96, 128)}, flush=True)
    from porechop_tpu_torch import native
    t0 = time.perf_counter()
    native.library()
    print('built the native host engine in %.1f s' % (time.perf_counter()
                                                       - t0), flush=True)

    timings = check_kernels(kernels)
    timings['walk'] = check_trace_bits(kernels, WALK['shapes'],
                                       walk_only=True)['walk']
    with recorded_shapes(kernels) as shapes:
        runs, ten_kb = on_card_runs(cli, kernels, shapes)
    print('score and stats launches of the runs in process by '
          'instantiation: %s' % dict(sorted(WAVE_TOTAL.items())), flush=True)
    idle = [k for k in NARROW if not WAVE_TOTAL[k]]
    if idle:
        raise AssertionError('no run launched the narrow instantiations %s'
                             % idle)
    check_no_bits_on_one_tile(shapes['bits'])
    check_launched_shapes(kernels, shapes, timings)
    if torch.cuda.device_count() > 1:
        check_other_cards(kernels, shapes['by_device'], list(_cards())[1:])
    else:
        print('multi-card phases: not run (device_count 1): the runs with '
              'no --device on every card, each card launching every '
              'kernel; cuda:0,cuda:1 entries; two ranks on two cards; '
              'dryrun_multichip on the cards; the kernels on a second '
              'card', flush=True)
    dry_run(kernels)
    # Last, after every kernel's timing: the profiled run's session is not
    # among the ones _cupti_ms times kernels with.
    runs.update(instrument_runs(cli, kernels, *ten_kb))

    line = []
    for name, spec_ in [*KERNELS.items(), ('walk', WALK)]:
        primary = timings[name][0]
        by_run = {label: n[name] for label, n in runs.items()}
        line.append(dict(
            name=name, route='cuda', source=spec_['source'],
            replaces=spec_['replaces'],
            replaces_also=spec_['replaces_also'],
            launches=sum(by_run.values()), launches_by_run=by_run,
            launches_by_instantiation={
                layout: n for (k, layout), n in sorted(WAVE_TOTAL.items())
                if k == name} or None,
            max_abs_err=max(r['max_abs_err'] for r in timings[name]),
            ms=primary['ms'], ms_events=primary['ms_events'],
            timing=primary['timing'], plain_ms=primary['plain_ms'],
            bound_ms=primary['bound_ms'], bound_by=primary['bound_by'],
            library_ms=None, shape=primary['what'],
            shapes=timings[name]))
    print('chip_smoke: %.1f s from the start to the result'
          % (time.perf_counter() - t_start), flush=True)
    print(json.dumps({'kernels': line}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
