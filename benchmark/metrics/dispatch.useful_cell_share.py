"""Percent of the cells the kernels were launched over (lanes x L x A)
that the lanes' own lengths need (read_len x adapter_len), over every
launch of the window, from the harness's wrapper around the kernel entry
points."""

UNIT = '%'
SOURCE = 'program_counter'
LAYER = 'planner'
MOVES = 'mbases_per_s'


def read(rec):
    counted = [x for x in rec.get('launches') or [] if x[4] is not None]
    launched = sum(B * L * A for _, B, L, A, *_ in counted)
    if not launched:
        return None
    return 100.0 * sum(x[4] for x in counted) / launched
