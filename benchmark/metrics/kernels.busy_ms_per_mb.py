"""Milliseconds of the port's kernels (dp_wave_kernel, bits_fold_kernel,
dp_walk_kernel) in the profiler's trace per input Mb."""

UNIT = 'ms/Mb'
SOURCE = 'device_trace'
LAYER = 'kernels'
MOVES = 'mbases_per_s'


def read(rec):
    busy = rec.get('port_kernel_s')
    if not busy or not rec.get('bases'):
        return None
    return busy * 1e3 / (rec['bases'] / 1e6)
