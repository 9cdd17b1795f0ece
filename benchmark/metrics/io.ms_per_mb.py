"""Milliseconds of reading and writing per input Mb: the port's
`[timing] phase load` and `output` lines (PORECHOP_TPU_TIMING), summed
over the window's jobs."""

UNIT = 'ms/Mb'
SOURCE = 'program_span'
LAYER = 'reading and writing'
MOVES = 'mbases_per_s'


def read(rec):
    ph = rec.get('phases') or {}
    if 'load' not in ph or 'output' not in ph or not rec.get('bases'):
        return None
    return (ph['load'] + ph['output']) * 1e3 / (rec['bases'] / 1e6)
