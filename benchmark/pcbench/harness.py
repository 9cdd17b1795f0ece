"""One run of one cell: set-up, the measured window, the check, and the
result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The cell's files are found by name: workloads/<cell>.json names its
configuration (configs/<name>.json), its generator
(generators/<name>.py) and the generator's parameters; the metrics a run
reports are BENCHMARK.json's for the cell, each read by
metrics/<metric>.py from the run's record.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

from . import check, host, jobs

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'porechop_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(name):
    """(workload, config) dicts of a cell, by name."""
    wl = load_json(os.path.join(BENCH, 'workloads', name + '.json'))
    cfg = load_json(os.path.join(BENCH, 'configs', wl['config'] + '.json'))
    return wl, cfg


def cell_metrics(bench, cell, traced):
    """Names of the metrics a run of this cell reports: BENCHMARK.json's
    end-to-end ones untraced, its per-layer ones traced."""
    key = 'per_layer' if traced else 'end_to_end'
    return [m['name'] for m in bench[key]
            if cell in m.get('workloads', [cell])]


def read_metrics(names, rec):
    out = {}
    for name in names:
        mod = load_module(os.path.join(BENCH, 'metrics', name + '.py'),
                          'metric_' + name.replace('.', '_'))
        v = mod.read(rec)
        if v is not None:
            out[name] = {'value': v, 'unit': mod.UNIT}
    return out


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules
                   if m.split('.')[0] in FORBIDDEN})


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(name, wl, cfg, metric_names, seed, seconds, traced,
             device=None, t0=None, since_start=None):
    """Runs one cell; returns the result dict (or None where the run may
    print none).  device: None runs the port as deployed (its own choice
    of the local cards, held to one card in a one-card cell) and needs as
    many cards as the cell asks for; 'cpu' runs it on the host, for the
    benchmark's own tests."""
    t0 = time.perf_counter() if t0 is None else t0
    on_card = device is None
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(ROOT, 'build', sub)
    if wl['chips'] == 1:
        # The port spreads every launch over all local cards unless told
        # not to (parallel/mesh.py); a one-card cell uses one.
        os.environ['PORECHOP_TPU_DISABLE_MESH'] = '1'
    if traced:
        os.environ['PORECHOP_TPU_TIMING'] = '1'
    if ROOT not in sys.path:
        sys.path.append(ROOT)
    t_imp = time.perf_counter()
    import torch
    from porechop_tpu_torch import cli
    from porechop_tpu_torch.ops import kernels
    from porechop_tpu_torch.parallel import mesh
    import_s = time.perf_counter() - t_imp
    cards = []
    if on_card:
        if not torch.cuda.is_available():
            say('no CUDA device: torch.cuda.is_available() is false')
            return None
        if torch.cuda.device_count() < wl['chips']:
            say('the cell needs %d cards, %d found'
                % (wl['chips'], torch.cuda.device_count()))
            return None
        cards = sorted({torch.device(d).index or 0
                        for d in mesh.local_devices()})
        if len(cards) != wl['chips']:
            say('the port would use %d cards, the cell asks for %d'
                % (len(cards), wl['chips']))
            return None
        for c in cards:
            torch.zeros(1, device='cuda:%d' % c)
    gen = load_module(os.path.join(BENCH, 'generators',
                                   wl['generator'] + '.py'),
                      'generator_' + wl['generator'])
    work = tempfile.mkdtemp(prefix='pcbench-', dir=os.environ.get('TMPDIR'))
    cwd = os.getcwd()
    try:
        t_gen = time.perf_counter()
        pool = make_pool(gen, wl, seed, work)
        os.chdir(work)
        t_warm = time.perf_counter()
        warm = jobs.run(cli.main, cfg, wl, pool[0], -1, work, device)
        if not warm.ok:
            say('warm-up job failed: %s' % warm.error)
        say('set-up: pool %.3f s, warm-up job %.3f s' % (
            t_warm - t_gen, time.perf_counter() - t_warm))
        return _window(name, wl, cfg, metric_names, seconds, traced,
                       device, cli, kernels, torch, pool, work, warm, t0,
                       since_start, import_s, cards)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def make_pool(gen, wl, seed, work):
    """The cell's distinct job files, [(path, reads, bases)]."""
    gz = int(wl['traffic'].get('gzip_level', 0)) > 0
    pool = []
    for p in range(wl['pool']):
        path = os.path.join(work, 'batch%d.fastq%s' % (p, '.gz' if gz
                                                       else ''))
        reads, bases = gen.write(path, wl['traffic'], seed, p)
        pool.append((path, reads, bases))
    return pool


def _window(name, wl, cfg, metric_names, seconds, traced, device, cli,
            kernels, torch, pool, work, warm, t0, since_start, import_s,
            cards):
    from . import trace
    on_card = device is None
    rec = {'cell': name, 'import_s': import_s}
    recorder = spans = dtrace = None
    if traced:
        recorder = trace.LaunchRecorder(kernels).__enter__()
        spans = trace.PhaseSpans(cli).__enter__()
        if on_card:
            dtrace = trace.DeviceTrace().__enter__()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    setup_end = time.perf_counter()
    rec['setup_s'] = (since_start or 0.0) + (setup_end - t0)
    done = []
    try:
        with host.RssSampler() as rss:
            first = time.perf_counter()
            k = 0
            while k == 0 or time.perf_counter() - first < seconds:
                done.append(jobs.run(cli.main, cfg, wl,
                                     pool[k % len(pool)], k, work, device))
                k += 1
        rec['peak_rss_bytes'] = rss.peak
    finally:
        if dtrace is not None:
            dtrace.__exit__(None, None, None)
        if spans is not None:
            spans.__exit__(None, None, None)
        if recorder is not None:
            recorder.__exit__(None, None, None)
    # The window's time is its CLI calls' (jobs.run): the harness's work
    # between them, reading outputs back, is no user's.
    rec['window_s'] = sum(j.seconds for j in done)
    rec['bases'] = sum(j.bases for j in done)
    rec['jobs'] = len(done)
    peak_dev = max((torch.cuda.max_memory_allocated(c) for c in cards),
                   default=0)
    for j in done:
        if not j.ok:
            say('job %d failed: %s' % (j.index, j.error))
    breakdown = None
    if traced:
        rec['phases'] = {}
        for j in done:
            for ph, s in j.phases.items():
                rec['phases'][ph] = rec['phases'].get(ph, 0.0) + s
        rec['launches'] = recorder.launches()
        if dtrace is not None:
            breakdown = _device_record(rec, dtrace, spans, cards,
                                       [(j.start, j.end) for j in done])
    recorder = spans = dtrace = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # The check: every job against the reference's run on its file.
    t_check = time.perf_counter()
    ref_device = 'cuda:%d' % cards[0] if on_card else 'cpu'
    stages = {}
    outcomes = check.reference([p[0] for p in pool], cfg, ref_device,
                               timings=stages)
    numbers = check.compare(done, outcomes)
    correct, table = check.verdict(numbers)
    check_s = time.perf_counter() - t_check
    metrics = read_metrics(metric_names, rec)
    result = {
        'correct': correct and warm.ok,
        'attempted': len(done),
        'failed': sum(1 for j in done if not j.ok),
        'metrics': metrics,
        'device': {
            'platform': 'gpu' if on_card else 'cpu',
            'kind': torch.cuda.get_device_name(cards[0]) if on_card else 'cpu',
            'count': len(cards),
            'memory_peak_bytes': int(peak_dev),
        },
    }
    if traced and 'busy_s' in rec:
        result['device']['busy_s'] = rec['busy_s']
        result['device']['window_s'] = rec['trace_window_s']
    if breakdown is not None:
        result['breakdown'] = breakdown
    say('job seconds: %s' % ' '.join('%.3f' % j.seconds for j in done))
    say('window: %d jobs, %.0f bases in %.3f s; setup %.3f s (import %.3f '
        's); check %.1f s over %d files (%s)' % (
            len(done), rec['bases'], rec['window_s'], rec['setup_s'],
            import_s, check_s, len(outcomes),
            ', '.join('%s %.2f' % kv for kv in stages.items())))
    if traced:
        say('launches: %s' % ', '.join(
            '%s %d' % kv for kv in sorted(collections.Counter(
                x[0] for x in rec['launches']).items())))
    result['checks'] = table
    return result


def _device_record(rec, dtrace, spans, cards, job_spans):
    """Fills rec's device numbers from the trace, over the jobs' CLI calls
    (host clock spans); returns the breakdown."""
    from . import trace
    events, marker = dtrace.events()
    per_card, overlap = trace.busy(events)
    if marker is not None:
        def to_us(t):
            return marker + (t - dtrace.host0) * 1e6
        windows = [(to_us(a), to_us(b)) for a, b in job_spans]
    else:
        windows = [(min(e[2] for e in events), max(e[3] for e in events))]
    lo, hi = windows[0][0], windows[-1][1]
    rec['card_busy_s'] = {}
    for c in cards:
        iv = per_card.get(c, [])
        inside = sum(max(0.0, min(e, b) - max(s, a))
                     for a, b in windows for s, e in iv)
        rec['card_busy_s'][c] = inside * 1e-6
    rec['busy_s'] = sum(rec['card_busy_s'].values()) / len(cards)
    rec['trace_window_s'] = sum(b - a for a, b in windows) * 1e-6
    if len(cards) > 1:
        rec['overlap_share'] = overlap
    port = [e for e in events if any(k in e[1] for k in trace.PORT_KERNELS)]
    rec['port_kernel_s'] = sum(e[3] - e[2] for e in port) * 1e-6
    by_name = {}
    for _, nm, s, e in events:
        if s >= lo and e <= hi:
            key = trace.short_name(nm)
            by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    gaps = []
    if marker is not None and cards[0] in per_card:
        host_spans = [(n, to_us(s), to_us(e)) for n, s, e in spans.spans]
        idle = collections.Counter()
        for a, b in windows:
            idle.update(trace.idle_by_phase(per_card[cards[0]], a, b,
                                            host_spans))
        gaps = sorted(((n, v * 1e-6) for n, v in idle.items()),
                      key=lambda x: -x[1])[:10]
    return {'device_ops': [list(x) for x in ops],
            'idle_gaps': [list(x) for x in gaps]}


def main(argv=None):
    t0 = time.perf_counter()
    since_start = host.seconds_since_process_start()
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    wl, cfg = cell_files(args.workload)
    names = cell_metrics(bench, args.workload, bool(args.trace))
    if since_start is None:
        say('no process start time in /proc: set-up counted from the '
            "harness's first line")
    try:
        result = run_cell(args.workload, wl, cfg, names, args.seed,
                          args.seconds, bool(args.trace), None, t0,
                          since_start)
    except Exception:
        traceback.print_exc()
        return 1
    if result is None:
        return 2
    found = forbidden_modules()
    if found:
        say('modules of JAX or the JAX package were loaded: %s'
            % ', '.join(found))
        return 3
    for k, v in result['checks'].items():
        say('check %s %s limit %s' % (k, v['value'], v['limit']))
    print(json.dumps(result), flush=True)
    return 0
