"""The control of the check: the reference put in the program's place with
one guarantee of the configuration broken, at a cell's own size, judged
by the check's own comparison.  It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13
                                 [--device cuda:0]

The broken guarantee: Porechop's positions come from SeqAn's traceback,
in which a tie between the diagonal and a gap goes to the diagonal; the
control gives it to the gap (reference/align.py, variant
'gap_beats_diagonal'), the step a faster kernel that elects a cell's
move by value alone would take.  For each seed it builds the cell's pool
as a run does, runs the reference and the control on every file of it,
and prints the check's numbers with the control's outputs as the
program's, and how many records differ.  The benchmark's runs never run
it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pcbench import check, harness, jobs  # noqa: E402


def control_jobs(outcomes):
    """Job records carrying the control's outcomes as a job's."""
    out = []
    for k, (path, o) in enumerate(sorted(outcomes.items())):
        job = jobs.Job()
        job.index, job.file, job.ok, job.error = k, path, True, None
        job.streams = check.digests(o)
        job.adapters, job.orientation = list(o.adapter_lines), o.orientation
        out.append(job)
    return out


def records(outcome):
    return [r for name in sorted(outcome.streams)
            for r in outcome.streams[name].split(b'\n@')]


def run(cell, seeds, device):
    wl, cfg = harness.cell_files(cell)
    gen = harness.load_module(os.path.join(harness.BENCH, 'generators',
                                           wl['generator'] + '.py'),
                              'generator_' + wl['generator'])
    rows = []
    for seed in seeds:
        work = tempfile.mkdtemp(prefix='pcbench-control-',
                                dir=os.environ.get('TMPDIR'))
        try:
            pool = harness.make_pool(gen, wl, seed, work)
            files = [p[0] for p in pool]
            t = time.perf_counter()
            ref = check.reference(files, cfg, device)
            t_ref = time.perf_counter() - t
            ctl = check.reference(files, cfg, device,
                                  variant='gap_beats_diagonal')
            numbers = check.compare(control_jobs(ctl), ref)
            correct, _ = check.verdict(numbers)
            diff = 0
            for p in files:
                a, b = records(ref[p]), records(ctl[p])
                diff += sum(x != y for x, y in zip(a, b)) + abs(len(a)
                                                                - len(b))
            row = dict(cell=cell, seed=seed, correct=correct,
                       records_differing=diff, reference_s=t_ref, **numbers)
            print(json.dumps(row), flush=True)
            rows.append(row)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--device', default='cuda:0')
    args = ap.parse_args(argv)
    run(args.workload, [int(s) for s in args.seeds.split(',')], args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
