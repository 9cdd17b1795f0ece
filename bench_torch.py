#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (porechop_tpu_torch) on one
NVIDIA GPU, the port's counterpart of bench.py and tools/bench_curve.py.
Run from the repository root:

    python3 bench_torch.py                        # 8,192 x 10 kb, -v 0
    python3 bench_torch.py --profile              # and one profiled run
    python3 bench_torch.py --sizes 512,2048,4096,8192
    python3 bench_torch.py --root build/parent --pairs 10

Workload: bench.py's, `-i reads.fastq -o out.fastq -v 0` at the default
threads on write_fastq(synth_reads(8192, 10000, seed=0)), the input whose
SHA-256 and the JAX package's output digest chip_smoke.py records
(--reads, --read-len, --seed and --verbosity 1 change it).  It builds the
kernels and the native engine in a child first, so that no wall holds
nvcc or g++, then runs the trimmer in fresh processes through
stretch_torch.RUNNER: --warmups runs (default one) and --runs runs on
the card, --runs under PORECHOP_TPU_FORCE_HOST=1 (the port's host
engine; no card looked for), and one under PORECHOP_TPU_TIMING=1 for the
phase walls.

It prints the card's name and power limit, then one JSON line: `value`,
the reads over the median time inside cli.main on the card (the card's
context and the libraries set up before it), with that time's quartiles;
`process_reads_per_s`, over the median fresh-process wall; `startup_s`,
the median of each part of a fresh process (interpreter start-up,
`import torch`, importing the port, CUDA context, library load, run,
exit);
the peaks of device memory and RSS; `vs_baseline`, `value` over the same
figure under PORECHOP_TPU_FORCE_HOST=1 in the same call; `phases_s` from
the traced run and its `timing_overhead_s`; `correct`: every output
equals the JAX package's digest where one is recorded (8,192 x 10 kb,
seed 0), else the forced-host run's.  Reference Porechop's figure from
bench.py rides along with its provenance and is divided into nothing.

--profile adds one run under torch.profiler: the device's busy seconds
and idle share.  --sizes runs the card and the forced host at each size
(one JSON line each) and ends with the smallest size at which the card
wins.  --root DIR --pairs N runs another checkout beside this one on the
card, alternating which goes first, and ends with each tree's median,
quartiles and pairs won.  There is no fallback: a missing or failed card,
a failed child or a digest that differs exits non-zero, and the host's
number never stands in the card's place.  --device cpu runs the card's
side on the CPU, for tests and small sizes only.
"""

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke
import stretch_torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'bench'
READS, READ_LEN, SEED = 8192, 10000, 0
PHASES = ('load', 'detect', 'endtrim', 'middle', 'output')
FORCE_HOST = {'PORECHOP_TPU_FORCE_HOST': '1'}
# Reference Porechop (rrwick/Porechop v0.2.4) on 10 kb reads by input size,
# as bench.py carries it (REF_READS_PER_S_BY_SIZE): measured on another
# host, so it is reported beside the port's figures and divides nothing.
REFERENCE_READS_PER_S = {512: 61.2, 2048: 58.0, 4096: 56.1, 8192: 57.6,
                         16384: 71.1}
REFERENCE_FROM = '2-vCPU build host, 2026-08-20, not this host'
BASELINE = 'porechop_tpu_torch, PORECHOP_TPU_FORCE_HOST=1, this host'


def build(tree, device=None):
    """Builds the native engine of checkout `tree` and, unless the card's
    side runs on `device` (the CPU), its kernels, in a child."""
    code = 'from porechop_tpu_torch import native; native.build()'
    if device is None:
        code += ('\nfrom porechop_tpu_torch.ops import kernels\n'
                 'kernels.build()')
    subprocess.run([sys.executable, '-c', code], cwd=tree,
                   env=dict(os.environ, PYTHONPATH=str(tree)), check=True)


def make_workload(reads, read_len, seed):
    """WORK/input_<reads>_<read_len>_<seed>/reads.fastq, written anew from
    synth_reads and, for chip_smoke.py's input, checked against its
    recorded digest."""
    from porechop_tpu_torch.utils.synth import synth_reads
    d = WORK / ('input_%d_%d_%d' % (reads, read_len, seed))
    known = (reads, read_len, seed) == (READS, READ_LEN, SEED)
    with contextlib.redirect_stdout(sys.stderr):
        chip_smoke.make_input('bench', d,
                              lambda: synth_reads(reads, read_len,
                                                  seed=seed),
                              chip_smoke.READS_SHA if known else None)
    return d / 'reads.fastq'


def jax_digests(reads, read_len, seed, verbosity):
    """(output, stdout) SHA-256 of the JAX package's run where recorded:
    the output at chip_smoke.py's input, the empty stdout of -v 0 (the -v 1
    transcript was recorded at -t 4 and names the threads)."""
    out = (chip_smoke.OUT_SHA[verbosity]
           if (reads, read_len, seed) == (READS, READ_LEN, SEED) else None)
    text = chip_smoke.STDOUT_SHA[0] if verbosity == 0 else None
    return out, text


def run_once(tree, input_path, argv, env=None, profile=False):
    """One fresh process of checkout `tree` (stretch_torch.run_child) on
    input_path; returns its record."""
    d = WORK / 'run'
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    os.symlink(input_path, d / 'reads.fastq')
    wall, (s,), (stdout,) = stretch_torch.run_child(tree, argv, d,
                                                    profile=profile, env=env)
    record = {
        'wall_s': wall, 'run_s': s['run_s'], 'parts_s': s['parts_s'],
        'rss_mib': s['rss_mib'], 'device_mib': s['device_mib'],
        'launches': sum(s['launches'].values()), 'busy_s': s['busy_s'],
        'timing_lines': s['timing_lines'],
        'output_sha256': stretch_torch.file_sha(d / 'out.fastq'),
        'stdout_sha256': hashlib.sha256(stdout.replace(
            str(d).encode(), b'<WORKDIR>')).hexdigest()}
    shutil.rmtree(d)
    return record


def runs(tree, input_path, argv, n, on_card, env=None):
    """n runs; on the card's side each must launch kernels (unless on the
    CPU), under the forced host none may, nor hold device memory."""
    out = []
    for _ in range(n):
        r = run_once(tree, input_path, argv, env)
        if on_card and not r['launches']:
            raise RuntimeError('a run on the card launched no kernel')
        if not on_card and (r['launches'] or r['device_mib']):
            raise RuntimeError('a forced-host run used the card: %d '
                               'launches, %.1f MiB' % (r['launches'],
                                                       r['device_mib']))
        out.append(r)
    return out


def spread(values):
    """Median, quartiles (inclusive) and count of values, with values."""
    values = list(values)
    q1, _, q3 = (statistics.quantiles(values, n=4, method='inclusive')
                 if len(values) > 1 else values * 3)
    return {'median': statistics.median(values), 'q1': q1, 'q3': q3,
            'n': len(values), 'all': values}


def side(records, reads):
    """One side's figures: reads/s over the median run_s and over the
    median fresh-process wall, their spreads, the median of each part of
    a fresh process and the peaks."""
    run_s = spread(r['run_s'] for r in records)
    wall_s = spread(r['wall_s'] for r in records)
    return {
        'reads_per_s': reads / run_s['median'], 'run_s': run_s,
        'process_reads_per_s': reads / wall_s['median'],
        'process_s': wall_s,
        'startup_s': {p: statistics.median(r['parts_s'][p] for r in records)
                      for p, *_ in stretch_torch.PARTS},
        'peak_rss_mib': max(r['rss_mib'] for r in records),
        'peak_device_mib': max(r['device_mib'] for r in records)}


def phases(lines):
    """{label: seconds} of a traced run's `[timing] phase` lines."""
    got = {}
    for ln in lines:
        parts = ln.split()
        if parts[1] == 'phase':
            got[parts[2]] = float(parts[3].rstrip('s'))
    return got


def check(records, want_out, want_text):
    """Whether every record's output and stdout equal the wanted digests
    (None: those of the first record)."""
    want_out = want_out or records[0]['output_sha256']
    want_text = want_text or records[0]['stdout_sha256']
    return all(r['output_sha256'] == want_out
               and r['stdout_sha256'] == want_text for r in records)


def reference(reads, read_len):
    if read_len != 10000 or reads not in REFERENCE_READS_PER_S:
        return None
    return {'reads_per_s': REFERENCE_READS_PER_S[reads], 'reads': reads,
            'read_len': read_len, 'measured_on': REFERENCE_FROM,
            'source': 'bench.py REF_READS_PER_S_BY_SIZE'}


def cli_argv(args, card_side):
    """The CLI's arguments in a run's directory: on the card's side with
    --device when the bench was given one."""
    argv = ['-i', 'reads.fastq', '-o', 'out.fastq', '-v',
            str(args.verbosity)]
    return argv + (['--device', args.device]
                   if card_side and args.device else [])


def card_and_host(args, reads, input_path, warm_up):
    """The card's side (after the warm-ups, if asked) and the forced
    host's at one size; returns (card records, host records, correct)."""
    card_argv, argv = cli_argv(args, True), cli_argv(args, False)
    if warm_up:
        runs(ROOT, input_path, card_argv, args.warmups, args.device is None)
    card = runs(ROOT, input_path, card_argv, args.runs, args.device is None)
    host = runs(ROOT, input_path, argv, args.runs, False, FORCE_HOST)
    want_out, want_text = jax_digests(reads, args.read_len, args.seed,
                                      args.verbosity)
    # Without a JAX digest the host engine's output is the reference: its
    # bytes are held against the JAX package's in the CPU tests.
    want_out = want_out or host[0]['output_sha256']
    want_text = want_text or host[0]['stdout_sha256']
    return card, host, check(card + host, want_out, want_text)


def workload_fields(args, reads, smi):
    return {'card': smi, 'device': args.device or 'card', 'reads': reads,
            'read_len': args.read_len, 'seed': args.seed,
            'verbosity': args.verbosity}


def bench(args, smi):
    """The default mode: one JSON line."""
    input_path = make_workload(args.reads, args.read_len, args.seed)
    card_argv = cli_argv(args, True)
    card, host, correct = card_and_host(args, args.reads, input_path,
                                        warm_up=True)
    traced = run_once(ROOT, input_path, card_argv,
                      {'PORECHOP_TPU_TIMING': '1'})
    extra = [traced]
    c, h = side(card, args.reads), side(host, args.reads)
    line = {
        'metric': 'reads/s trimming %d x %d bp synthetic nanopore reads '
                  '(detection + end trim + middle scan + output) inside '
                  'porechop_tpu_torch.cli.main on %s, median of %d fresh '
                  'processes' % (args.reads, args.read_len,
                                 args.device or 'the card', args.runs),
        'value': c['reads_per_s'], 'unit': 'reads/s',
        'vs_baseline': c['reads_per_s'] / h['reads_per_s'],
        'baseline': BASELINE, 'baseline_value': h['reads_per_s'],
        **{k: v for k, v in c.items() if k != 'reads_per_s'},
        'baseline_figures': h,
        'phases_s': phases(traced['timing_lines']),
        'timing_overhead_s': traced['run_s'] - c['run_s']['median'],
        'reference_porechop': reference(args.reads, args.read_len),
        **workload_fields(args, args.reads, smi)}
    if args.profile:
        prof = run_once(ROOT, input_path, card_argv, profile=True)
        extra.append(prof)
        # On the CPU there is no device to be busy: not measured.
        on_card = args.device is None
        line.update(profiled_run_s=prof['run_s'],
                    device_busy_s=prof['busy_s'] if on_card else None,
                    device_idle_share=(1 - prof['busy_s'] / prof['run_s']
                                       if on_card else None))
    if list(line['phases_s']) != list(PHASES):
        raise RuntimeError('the traced run printed the phases %s'
                           % list(line['phases_s']))
    line['correct'] = correct and check(extra, card[0]['output_sha256'],
                                        card[0]['stdout_sha256'])
    print(json.dumps(line), flush=True)
    return line['correct']


def sizes(args, smi):
    """bench_curve's sweep: one JSON line a size, then the crossover."""
    ok, rows = True, []
    for k, n in enumerate(int(x) for x in args.sizes.split(',')):
        input_path = make_workload(n, args.read_len, args.seed)
        card, host, correct = card_and_host(args, n, input_path,
                                            warm_up=k == 0)
        c, h = side(card, n), side(host, n)
        row = {'card_side': c, 'host': h,
               'card_over_host': c['reads_per_s'] / h['reads_per_s'],
               'card_wins': c['reads_per_s'] > h['reads_per_s'],
               'process_card_wins': (c['process_reads_per_s']
                                     > h['process_reads_per_s']),
               'reference_porechop': reference(n, args.read_len),
               'correct': correct, **workload_fields(args, n, smi)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        ok &= correct
    won = [r['reads'] for r in rows if r['card_wins']]
    won_process = [r['reads'] for r in rows if r['process_card_wins']]
    print(json.dumps({
        'crossover_reads': min(won) if won else None,
        'process_crossover_reads': min(won_process) if won_process else None,
        'sizes': [r['reads'] for r in rows], 'card': smi}), flush=True)
    return ok


def pairs(args, smi):
    """This checkout against --root on the card's side, --pairs times,
    alternating which goes first: a JSON line a run, then the summary."""
    trees = [ROOT, Path(args.root).resolve()]
    input_path = make_workload(args.reads, args.read_len, args.seed)
    argv = cli_argv(args, True)
    for tree in trees:
        runs(tree, input_path, argv, args.warmups, args.device is None)
    records = {tree: [] for tree in trees}
    wins = {tree: 0 for tree in trees}
    wins_wall = {tree: 0 for tree in trees}
    for pair in range(args.pairs):
        order = trees if pair % 2 == 0 else trees[::-1]
        got = {}
        for tree in order:
            (r,) = runs(tree, input_path, argv, 1, args.device is None)
            got[tree] = r
            records[tree].append(r)
            print(json.dumps({
                'tree': 'this' if tree == ROOT else str(tree), 'pair': pair,
                **{k: r[k] for k in ('run_s', 'wall_s', 'parts_s', 'rss_mib',
                                     'device_mib', 'output_sha256')}}),
                flush=True)
        wins[min(got, key=lambda t: got[t]['run_s'])] += 1
        wins_wall[min(got, key=lambda t: got[t]['wall_s'])] += 1
    want_out, want_text = jax_digests(args.reads, args.read_len, args.seed,
                                      args.verbosity)
    correct = check([r for t in trees for r in records[t]], want_out,
                    want_text)
    summary = []
    for tree in trees:
        s = side(records[tree], args.reads)
        summary.append({'tree': 'this' if tree == ROOT else str(tree),
                        'pairs_won': wins[tree],
                        'pairs_won_by_wall': wins_wall[tree], **s})
    print(json.dumps({'summary': summary, 'pairs': args.pairs,
                      'correct': correct,
                      **workload_fields(args, args.reads, smi)}), flush=True)
    return correct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reads', type=int, default=READS)
    ap.add_argument('--read-len', type=int, default=READ_LEN)
    ap.add_argument('--seed', type=int, default=SEED)
    ap.add_argument('--verbosity', type=int, choices=(0, 1), default=0)
    ap.add_argument('--runs', type=int, default=5,
                    help='fresh processes a side (and a size)')
    ap.add_argument('--warmups', type=int, default=1,
                    help='untimed runs on the card first (a tree, with '
                         '--root)')
    ap.add_argument('--profile', action='store_true',
                    help='one more run under torch.profiler')
    ap.add_argument('--sizes', default=None,
                    help='comma-separated read counts: the card against '
                         'the forced host at each')
    ap.add_argument('--root', default=None,
                    help='another checkout to run beside this one')
    ap.add_argument('--pairs', type=int, default=10,
                    help='runs of each tree with --root, alternating')
    ap.add_argument('--device', default=None,
                    help="the card's side on this device instead (cpu)")
    args = ap.parse_args(argv)

    smi = stretch_torch.card()
    print(smi, flush=True)
    trees = [ROOT] + ([Path(args.root).resolve()] if args.root else [])
    for tree in trees:
        build(tree, args.device)
    if args.root:
        ok = pairs(args, smi)
    elif args.sizes:
        ok = sizes(args, smi)
    else:
        ok = bench(args, smi)
    if not ok:
        print('bench_torch: an output differs from its reference',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
