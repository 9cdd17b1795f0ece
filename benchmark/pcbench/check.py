"""How `correct` is decided: every job of the window against the plain
reference's run on the same file (benchmark/reference/), compared
exactly.

Per job the reference gives the adapter lines of the matching sets (and
with barcodes the kit's orientation) and the bytes of every output
stream.  Compared numbers, each with its limit:

  jobs_failed     jobs of the window whose CLI call raised or exited with
                  an error; limit 0
  outputs_wrong   jobs whose output streams (names, and the SHA-1 of each
                  one's bytes, decompressed where gzipped) differ from the
                  reference's; limit 0
  adapters_wrong  jobs whose transcript lists other adapter sets, or
                  another barcode orientation, than the reference; limit 0

An exact comparison has the limit 0: Porechop's output is byte for byte.
"""

from __future__ import annotations

import hashlib

LIMITS = {'jobs_failed': 0, 'outputs_wrong': 0, 'adapters_wrong': 0}


def options(config):
    from reference.porechop import Options
    return Options(**config.get('reference_options', {}))


def reference(paths, config, device, variant='seqan', timings=None):
    """{path: reference Outcome} of each distinct file."""
    from reference import porechop as rp
    opts = options(config)
    return {p: rp.run(p, opts, device, variant, timings)
            for p in sorted(set(paths))}


def digests(outcome):
    return {name: (hashlib.sha1(b).hexdigest(), len(b))
            for name, b in outcome.streams.items()}


def compare(jobs, outcomes):
    """The compared numbers of a window's jobs against {path: Outcome}:
    jobs on files without an outcome are not compared, but count when
    they failed."""
    want = {p: (digests(o), o.adapter_lines, o.orientation)
            for p, o in outcomes.items()}
    failed = outputs = adapters = 0
    for job in jobs:
        if not job.ok:
            failed += 1
            continue
        if job.file not in want:
            continue
        streams, lines, orientation = want[job.file]
        if job.streams != streams:
            outputs += 1
        if [tuple(x) for x in job.adapters] != [tuple(x) for x in lines] \
                or job.orientation != orientation:
            adapters += 1
    return {'jobs_failed': failed, 'outputs_wrong': outputs,
            'adapters_wrong': adapters}


def verdict(numbers):
    """(correct, {name: {'value', 'limit'}})."""
    table = {k: {'value': numbers[k], 'limit': LIMITS[k]} for k in LIMITS}
    return all(numbers[k] <= LIMITS[k] for k in LIMITS), table
