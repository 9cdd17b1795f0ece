"""Milliseconds per input Mb of the three alignment phases' per-read host
work: the port's detect, endtrim and middle phase spans less the spans
nested in them (planner and waits; porechop_tpu_torch/utils/spans.py),
summed over the window's jobs.  With planner.host_ms_per_mb and
device.wait_ms_per_mb it makes up phases.ms_per_mb."""

import importlib.util
import os

UNIT = 'ms/Mb'
SOURCE = 'program_span'
LAYER = 'phases'
MOVES = 'mbases_per_s'

_spec = importlib.util.spec_from_file_location(
    'program_spans', os.path.join(os.path.dirname(__file__),
                                  'program_spans.py'))
program_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(program_spans)


def read(rec):
    jobs = program_spans.window_jobs(rec)
    if jobs is None or not rec.get('bases'):
        return None
    return program_spans.per_mb(
        rec, program_spans.phase_seconds(jobs)
        - program_spans.span_seconds(jobs))
