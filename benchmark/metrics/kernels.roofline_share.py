"""Percent of the port's kernel time that their floor accounts for: the
sum over the window's launches of kernel_floor.floor_s over the sum of
the port's kernels' durations in the profiler's trace."""

import importlib.util
import os

UNIT = '%'
SOURCE = 'device_trace'
LAYER = 'kernels'
MOVES = 'mbases_per_s'

_spec = importlib.util.spec_from_file_location(
    'kernel_floor', os.path.join(os.path.dirname(__file__), 'kernel_floor.py'))
kernel_floor = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_floor)


def read(rec):
    busy = rec.get('port_kernel_s')
    launches = rec.get('launches') or []
    floors = [kernel_floor.floor_s(*x) for x in launches]
    floors = [f for f in floors if f is not None]
    if not busy or not floors:
        return None
    return 100.0 * sum(floors) / busy
