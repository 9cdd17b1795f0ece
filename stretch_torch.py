#!/usr/bin/env python3
"""The stretch run of the PyTorch/CUDA port (porechop_tpu_torch) on an
NVIDIA GPU host, the port's counterpart of tools/stretch_1m.py: a gzipped
FASTQ of 1,000,000 synthetic 1 kb reads (BASELINE.json configs[4]) trimmed
with --stream in fresh processes, one process (over every card) and then
two torch.distributed ranks (rank r on cuda:(r % cards): sharing a lone
card, else on two).  Run from the repository root:

    python3 stretch_torch.py                    # 1M reads, one process
    python3 stretch_torch.py --multihost        # and two ranks
    python3 stretch_torch.py --reads 200000     # the 1M input's head
    python3 stretch_torch.py --root build/parent --pairs 10

The input is the decompressed bytes of
utils.synth.ensure_fastq_streamed(path, reads, 1000, seed=7), written by
utils.synth.synth_fastq_gz (one 50,000-read part a worker process) into
build/stretch/ if missing and checked against its recorded SHA-256.  Each
run is `python -m porechop_tpu_torch -i reads.fastq.gz -o out.fastq -v 0
-t 4 --stream 20000` in a fresh process (through RUNNER, which reports
the process's own numbers); with --multihost the same as two ranks.  It
prints the card's name and power limit, then one JSON line per run: wall
(the processes' start to their exit), reads/s, the time inside cli.main
(run_s, with the card's context and the libraries set up before it, and
run_s_with_setup, with them as earlier records counted it), each rank's
wall split into interpreter start-up, `import torch`, importing the
port, CUDA context, library load, run and exit, peak RSS, peak
device MiB, kernel launches and the cards launched on per rank, and the
output's SHA-256 against
the JAX package's digest recorded for those parameters (at -v 1 the
transcript's too).  A mismatch, a failed run or a wrong input exits
non-zero.  --root DIR runs the porechop_tpu_torch of another checkout
(e.g. the parent commit unpacked with git archive) beside this one on the
same input, --pairs times, alternating which goes first, and ends with a
summary line: median walls and the pairs each tree won.  --profile adds
one run of this tree under torch.profiler: the device's busy time (its
kernels' and copies' durations summed) and idle share.  --device cpu
runs the children on the CPU (small --reads only); without it and
without a card the children raise.
"""

import argparse
import gzip
import hashlib
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'stretch'
READ_LEN = 1000
SEED = 7
CHUNK = 20_000
CHILD_TIMEOUT = 3000

# SHA-256 of the decompressed input, utils.synth.ensure_fastq_streamed(
# path, reads, 1000, seed=7).  The 200,000-read input is the first 200,000
# records of the 1,000,000-read one (both name reads with six digits).
READS_SHA = {
    1_000_000: 'f7b1176b234066ca2e1a54b0a26a3a3ffea726d6694f692a24621d40f1d94ae6',
    200_000: 'd680736235ca8532b5f74954c83f3e1ed490530f20cd95a463c465fde4538278'}
# The JAX package's output and -v 1 transcript on these inputs, recorded on
# a CPU host with its byte-identical host engine, in a directory holding
# reads.fastq.gz:
#   PORECHOP_TPU_FORCE_HOST=1 python -m porechop_tpu -i reads.fastq.gz \
#       -o out.fastq -v 0 -t 4 --stream 20000 > stdout.txt
# (and -v 1, which chip_smoke.py's two-rank run is held against).  The -v 1
# transcript prints the output's absolute path; its digest is of the bytes
# with that directory replaced by <WORKDIR>.
# {(reads, verbosity): (output SHA-256, transcript SHA-256)}
EMPTY_SHA = 'e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855'
JAX_SHA = {
    (1_000_000, 0): (
        '4a92a35701d11a957a6a7c4e96dab8bae22db90963a42c65ff798f45c31027a5',
        EMPTY_SHA),
    (1_000_000, 1): (
        '4a92a35701d11a957a6a7c4e96dab8bae22db90963a42c65ff798f45c31027a5',
        '5ef511c025b1a0c013010011a4d383e05799b9192a0f0b0569ea780f2cdac089'),
    (200_000, 0): (
        '5ff988b9f8bf8fc1d5c0739878ad21f006d9da189bd9f0724d6dacbb9ab9b51b',
        EMPTY_SHA),
    (200_000, 1): (
        '5ff988b9f8bf8fc1d5c0739878ad21f006d9da189bd9f0724d6dacbb9ab9b51b',
        'a9e1b51333dfee3394b727a5f37a02ce0fc01165117ceac6bab208286e2ffba8'),
}
# Output bytes of the 1M run: 1,911,125,238 (BASELINE.md's figure for the
# JAX package's older code), 382,150,230 for the 200,000-read head.
KERNEL_NAMES = ('forward_score', 'forward_stats', 'forward_walk',
                'forward_tiled', 'walk')

# One run of the port in a fresh process: argv[1] is 1 to profile it, the
# rest the CLI's arguments.  It reports on stderr, as `STRETCH {json}`:
# seconds inside cli.main, the peak RSS, the peak device memory, launches
# per kernel, and under the profiler the device's busy seconds; also the
# peak RSS when adapter-set detection (cli._find_adapter_sets) returns,
# None on a rank that does no detection.  The peak RSS is VmHWM from /proc/self/status (on Linux a child's ru_maxrss
# inherits the forking parent's high-water mark across exec; VmHWM does
# not), or where the kernel gives no VmHWM the largest resident size read
# from /proc/self/statm every 0.1 s; ru_maxrss is reported beside it.
# Before cli.main it creates the CUDA context on every card the run will
# use (none under PORECHOP_TPU_FORCE_HOST or on CPU entries) and loads the
# libraries the run calls (the kernels on a card, the native engine under
# PORECHOP_TPU_FORCE_HOST), so that run_s holds neither; `marks` are its
# wall-clock times (time.time(), comparable with the parent's) at its first
# statement, after `import torch`, after importing the port, after the
# context, after the libraries, and before and after cli.main.
RUNNER = r'''
import json, os, resource, sys, threading, time
marks = {'interpreter': time.time()}
sampled_kib = [0]
def sample(page_kib=os.sysconf('SC_PAGE_SIZE') // 1024):
    try:
        while True:
            with open('/proc/self/statm') as f:
                rss = int(f.read().split()[1]) * page_kib
            sampled_kib[0] = max(sampled_kib[0], rss)
            time.sleep(0.1)
    except (OSError, ValueError, IndexError):
        return
threading.Thread(target=sample, daemon=True).start()
def peak_mib():
    hwm = [ln for ln in open('/proc/self/status') if ln.startswith('VmHWM')]
    if hwm:
        return int(hwm[0].split()[1]) / 1024, 'VmHWM'
    return sampled_kib[0] / 1024, 'statm every 0.1 s'
import torch
marks['torch'] = time.time()
from porechop_tpu_torch import cli, native
from porechop_tpu_torch.ops import dispatch, kernels
from porechop_tpu_torch.parallel import mesh
marks['port_import'] = time.time()
profile, argv = sys.argv[1] == '1', sys.argv[2:]
cards = []
if not dispatch.force_host():
    # As cli.main chooses them; without a card resolve_devices raises.
    named = argv[argv.index('--device') + 1] if '--device' in argv else None
    cards = [d for d in dispatch.resolve_devices(named) if d.type == 'cuda']
    if named is None and os.environ.get('PORECHOP_TPU_COORDINATOR'):
        cards = [torch.device('cuda', int(os.environ['PORECHOP_TPU_PROC_ID'])
                              % torch.cuda.device_count())]
    elif named is None:
        cards = mesh.local_devices()
for d in cards:
    torch.cuda.synchronize(d)
marks['cuda_context'] = time.time()
if cards:
    for name in kernels.SOURCES:
        kernels._lib(name)
if dispatch.force_host():
    native.library()
marks['library_load'] = time.time()
detection = {}
find_adapter_sets = cli._find_adapter_sets
def finding(*args, **kwargs):
    found = find_adapter_sets(*args, **kwargs)
    detection['rss_mib'] = peak_mib()[0]
    return found
cli._find_adapter_sets = finding
prof = None
if profile:
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
marks['start'] = time.time()
t0 = time.perf_counter()
cli.main(argv)
for d in cards:
    torch.cuda.synchronize(d)
run_s = time.perf_counter() - t0
marks['end'] = time.time()
busy_s = None
if prof is not None:
    prof.__exit__(None, None, None)
    busy_s = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) * 1e-6
rss_mib, rss_from = peak_mib()
peak = (max(torch.cuda.max_memory_allocated(k)
            for k in range(torch.cuda.device_count()))
        if torch.cuda.is_initialized() else 0)
print('STRETCH ' + json.dumps({
    'run_s': run_s, 'rss_mib': rss_mib, 'rss_from': rss_from,
    'detection_rss_mib': detection.get('rss_mib'),
    'ru_maxrss_mib': resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024,
    'device_mib': peak / 2 ** 20, 'launches': dict(kernels.LAUNCHES),
    'cards': sorted({d for (_, d), n in kernels.DEVICE_LAUNCHES.items()
                     if n}),
    'busy_s': busy_s, 'marks': marks}), file=sys.stderr)
'''
# The parts of a fresh process's wall, from the parent's start and exit
# times and the runner's marks: (part, the mark it begins at, the mark it
# ends at); None is the process's start or its exit.
PARTS = (('interpreter', None, 'interpreter'),
         ('import_torch', 'interpreter', 'torch'),
         ('port_import', 'torch', 'port_import'),
         ('cuda_context', 'port_import', 'cuda_context'),
         ('library_load', 'cuda_context', 'library_load'),
         ('run', 'start', 'end'), ('exit', 'end', None))


def card():
    """The card's name and power limit as nvidia-smi gives them, or
    'none'."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return 'none'


def decompressed_sha(path):
    h = hashlib.sha256()
    with gzip.open(path, 'rb') as f:
        while block := f.read(1 << 24):
            h.update(block)
    return h.hexdigest()


def file_sha(path):
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        while block := f.read(1 << 24):
            h.update(block)
    return h.hexdigest()


def make_input(reads, work=None):
    """work/reads_<reads>.fastq.gz (by default in WORK), written by the
    pool if missing; its decompressed bytes checked against READS_SHA
    where recorded.  Returns (path, seconds spent writing it)."""
    from porechop_tpu_torch.utils.synth import synth_fastq_gz
    work = work or WORK
    work.mkdir(parents=True, exist_ok=True)
    path = work / ('reads_%d.fastq.gz' % reads)
    t0 = time.perf_counter()
    if not path.is_file():
        synth_fastq_gz(str(path), reads, READ_LEN, seed=SEED)
    made_s = time.perf_counter() - t0
    want = READS_SHA.get(reads)
    if want is not None and decompressed_sha(path) != want:
        raise SystemExit('stretch_torch: %s is not the recorded input' % path)
    return path, made_s


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _stats(err):
    lines = [ln for ln in err.decode(errors='replace').splitlines()
             if ln.startswith('STRETCH ')]
    return json.loads(lines[-1][len('STRETCH '):]) if lines else None


def _parts(started, marks, exited):
    """{part: seconds} of one fresh process (PARTS), from the wall-clock
    time of its start, the runner's marks and the time of its exit."""
    return {name: (marks[end] if end else exited)
            - (marks[begin] if begin else started)
            for name, begin, end in PARTS}


def run_child(tree, argv, cwd, ranks=1, profile=False, env=None):
    """The port of checkout `tree` in `ranks` fresh processes in cwd (two:
    torch.distributed ranks on 127.0.0.1), with the variables `env` added.
    Returns (wall seconds from the first start to the last exit, [stats by
    rank], [stdout bytes by rank]); each rank's stats carry its wall split
    by PARTS (`parts_s`) and its `[timing]` lines on stderr
    (`timing_lines`).  Raises if a rank fails."""
    env = dict(os.environ, PYTHONPATH=str(tree), **(env or {}))
    port = _free_port()
    procs, started = [], []
    t0 = time.perf_counter()
    for r in range(ranks):
        if ranks > 1:
            env = dict(env, PORECHOP_TPU_COORDINATOR='127.0.0.1:%d' % port,
                       PORECHOP_TPU_NUM_PROCS=str(ranks),
                       PORECHOP_TPU_PROC_ID=str(r))
        started.append(time.time())
        procs.append(subprocess.Popen(
            [sys.executable, '-c', RUNNER, '1' if profile else '0', *argv],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))

    def wait(p):
        out = p.communicate(timeout=CHILD_TIMEOUT)
        return out, time.time()
    try:
        # A thread a rank, so that each rank's exit is timed when it comes.
        with ThreadPoolExecutor(max_workers=ranks) as pool:
            outs = list(pool.map(wait, procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    stats = [_stats(err) for (_, err), _ in outs]
    for r, (p, ((_, err), exited), s) in enumerate(zip(procs, outs, stats)):
        if p.returncode != 0 or s is None:
            raise RuntimeError('stretch run of %s, rank %d, exited %d:\n%s'
                               % (tree, r, p.returncode,
                                  err.decode(errors='replace')[-3000:]))
        s['parts_s'] = _parts(started[r], s['marks'], exited)
        s['timing_lines'] = [
            ln for ln in err.decode(errors='replace').splitlines()
            if ln.startswith('[timing] ')]
    return wall, stats, [out for (out, _), _ in outs]


def run(tree, input_path, reads, ranks, device=None, profile=False,
        smi='none'):
    """One stretch run at -v 0; returns its JSON record (written to stdout
    by the caller).  The output (and the empty transcript) are compared
    with the JAX package's digests recorded for (reads, 0), where there
    are."""
    d = WORK / ('run_%d' % ranks)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    os.symlink(input_path, d / 'reads.fastq.gz')
    argv = ['-i', 'reads.fastq.gz', '-o', 'out.fastq', '-v', '0', '-t', '4',
            '--stream', str(CHUNK)]
    if device:
        argv += ['--device', device]
    wall, stats, stdouts = run_child(tree, argv, d, ranks, profile)
    out_sha = file_sha(d / 'out.fastq')
    out_bytes = (d / 'out.fastq').stat().st_size
    text_sha = hashlib.sha256(stdouts[0].replace(
        str(d).encode(), b'<WORKDIR>')).hexdigest()
    want = JAX_SHA.get((reads, 0))
    shutil.rmtree(d)
    record = {
        'config': 'stretch-stream' + ('-%dranks' % ranks if ranks > 1
                                      else ''),
        'tree': 'this' if Path(tree) == ROOT else str(tree),
        'card': smi, 'reads': reads, 'read_len': READ_LEN, 'chunk': CHUNK,
        'verbosity': 0, 'ranks': ranks, 'device': device or 'card',
        'wall_s': wall, 'reads_per_s': reads / wall,
        'run_s': max(s['run_s'] for s in stats),
        # run_s as the runner measured it before it set up the card and
        # the libraries ahead of cli.main.
        'run_s_with_setup': max(
            s['run_s'] + s['parts_s']['cuda_context']
            + s['parts_s']['library_load'] for s in stats),
        'parts_s_by_rank': [s['parts_s'] for s in stats],
        'peak_rss_mib': max(s['rss_mib'] for s in stats),
        'peak_rss_mib_by_rank': [s['rss_mib'] for s in stats],
        'peak_rss_from': stats[0]['rss_from'],
        'peak_rss_mib_after_detection_by_rank': [s['detection_rss_mib']
                                                 for s in stats],
        'ru_maxrss_mib_by_rank': [s['ru_maxrss_mib'] for s in stats],
        'peak_device_mib': max(s['device_mib'] for s in stats),
        'peak_device_mib_by_rank': [s['device_mib'] for s in stats],
        'launches': {k: sum(s['launches'].get(k, 0) for s in stats)
                     for k in KERNEL_NAMES},
        'launches_by_rank': [s['launches'] for s in stats],
        'cards_by_rank': [s['cards'] for s in stats],
        'output_bytes': out_bytes, 'output_sha256': out_sha,
        'transcript_sha256': text_sha,
        'jax_output_sha256': want[0] if want else None,
        'jax_equal': (out_sha == want[0] and text_sha == want[1]
                      and not any(stdouts[1:])) if want else None}
    if profile:
        busy = sum(s['busy_s'] for s in stats)
        record.update(profiled=True, device_busy_s=busy,
                      device_idle_share=1 - busy / record['run_s'])
    return record


def build_kernels(tree):
    """Builds the kernels of checkout `tree` in a child (so that no run's
    wall holds nvcc)."""
    subprocess.run([sys.executable, '-c', 'from porechop_tpu_torch.ops '
                    'import kernels; kernels.build()'], cwd=tree,
                   env=dict(os.environ, PYTHONPATH=str(tree)), check=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reads', type=int, default=1_000_000)
    ap.add_argument('--multihost', action='store_true',
                    help='also run the input as two ranks')
    ap.add_argument('--root', default=None,
                    help='another checkout to run beside this one')
    ap.add_argument('--pairs', type=int, default=1,
                    help='runs of each tree with --root, alternating')
    ap.add_argument('--profile', action='store_true',
                    help='one more run of this tree under torch.profiler')
    ap.add_argument('--device', default=None,
                    help='the children\'s --device (e.g. cpu)')
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    smi = card()
    print(smi, flush=True)
    trees = [ROOT] + ([Path(args.root).resolve()] if args.root else [])
    if args.device is None:
        for tree in trees:
            build_kernels(tree)
    input_path, made_s = make_input(args.reads)
    print('input: %s, %d reads, written in %.1f s' % (input_path, args.reads,
                                                      made_s), flush=True)
    ranks = (1, 2) if args.multihost else (1,)
    walls = {(tree, n): [] for tree in trees for n in ranks}
    wins = {(tree, n): 0 for tree in trees for n in ranks}
    failed = []
    for pair in range(args.pairs if args.root else 1):
        order = trees if pair % 2 == 0 else trees[::-1]
        for n in ranks:
            got = {}
            for tree in order:
                record = run(tree, input_path, args.reads, n, args.device,
                             smi=smi)
                record['pair'] = pair
                print(json.dumps(record), flush=True)
                if record['jax_equal'] is False:
                    failed.append(record)
                got[tree] = record['wall_s']
                walls[(tree, n)].append(record['wall_s'])
            wins[min(got, key=got.get), n] += 1
    if args.profile:
        record = run(ROOT, input_path, args.reads, 1, args.device,
                     profile=True, smi=smi)
        print(json.dumps(record), flush=True)
        if record['jax_equal'] is False:
            failed.append(record)
    if args.root:
        print(json.dumps({'summary': [{
            'tree': 'this' if tree == ROOT else str(tree), 'ranks': n,
            'walls_s': walls[(tree, n)],
            'median_wall_s': statistics.median(walls[(tree, n)]),
            'pairs_won': wins[(tree, n)]} for tree, n in walls],
            'card': smi}), flush=True)
    if failed:
        print('stretch_torch: %d runs differ from the JAX package'
              % len(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
