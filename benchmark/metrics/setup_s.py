"""Seconds from the interpreter's start to the window's: imports, the
CUDA context, the kernels' build or load, the pool of job files, and one
warm-up job."""

UNIT = 's'
SOURCE = 'host_clock'


def read(rec):
    return rec.get('setup_s')
