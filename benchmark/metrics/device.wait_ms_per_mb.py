"""Milliseconds per input Mb that the host spent blocked on the card
inside the three alignment phases: the port's `wait` spans (every copy
back, and the stream synchronisation before each upload;
porechop_tpu_torch/utils/spans.py), summed over the window's jobs.  The
card's time that the host could not hide."""

import importlib.util
import os

UNIT = 'ms/Mb'
SOURCE = 'program_span'
LAYER = 'device'
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
        rec, program_spans.span_seconds(jobs, program_spans.WAIT))
