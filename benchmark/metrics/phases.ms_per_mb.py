"""Milliseconds of the three alignment phases per input Mb: the port's
`[timing] phase detect`, `endtrim` and `middle` lines, summed over the
window's jobs."""

UNIT = 'ms/Mb'
SOURCE = 'program_span'
LAYER = 'phases'
MOVES = 'mbases_per_s'


def read(rec):
    ph = rec.get('phases') or {}
    names = ('detect', 'endtrim', 'middle')
    if not all(n in ph for n in names) or not rec.get('bases'):
        return None
    return sum(ph[n] for n in names) * 1e3 / (rec['bases'] / 1e6)
