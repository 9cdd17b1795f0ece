"""Seconds that `import torch` and the port's CLI module take, on the
harness's clock around the two imports."""

UNIT = 's'
SOURCE = 'host_clock'
LAYER = 'process start-up'
MOVES = 'setup_s'


def read(rec):
    return rec.get('import_s')
