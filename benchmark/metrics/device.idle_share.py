"""Percent of the traced window in which a card ran nothing: one less the
union of its device activity's intervals inside the jobs' CLI calls over
those calls' wall, the mean over the cards the run used."""

UNIT = '%'
SOURCE = 'device_trace'
LAYER = 'device'
MOVES = 'mbases_per_s'


def read(rec):
    busy = rec.get('card_busy_s')
    window = rec.get('trace_window_s')
    if not busy or not window:
        return None
    return 100.0 * (1 - sum(busy.values()) / len(busy) / window)
