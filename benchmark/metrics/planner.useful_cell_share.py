"""Percent of the cells the kernels were launched over (lanes x L x A)
that the lanes' own lengths need (read_len x adapter_len), over every
launch of the window, from the port's own launch records: the needed
cells counted on the host where each launch is enqueued
(porechop_tpu_torch/utils/spans.py)."""

import importlib.util
import os

UNIT = '%'
SOURCE = 'program_counter'
LAYER = 'planner'
MOVES = 'mbases_per_s'

_spec = importlib.util.spec_from_file_location(
    'program_spans', os.path.join(os.path.dirname(__file__),
                                  'program_spans.py'))
program_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(program_spans)


def read(rec):
    jobs = program_spans.window_jobs(rec)
    if jobs is None:
        return None
    launched = sum(j['cells']['launched_sized'] for j in jobs)
    if not launched:
        return None
    return 100.0 * sum(j['cells']['needed'] for j in jobs) / launched
