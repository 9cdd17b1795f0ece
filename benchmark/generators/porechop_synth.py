"""The benchmark's one traffic generator: Porechop batch files of
synthetic nanopore reads, from a workload's parameters and a seed.

A frozen copy of the port's `utils/synth.py` (`synth_reads`,
`synth_barcoded`, `_mutate`), so that a change to the program cannot move
the inputs: the same parameters and seed give the same bytes.  The native
barcodes' full sequences come from the benchmark's own adapter table.
Departures from synth.py:
  - every file holds the same work whatever the seed: the same set of
    read lengths, and the same number of start adapters, end adapters,
    chimeras and barcodes (the rate times the reads, rounded), placed by
    permutations drawn from the seed, so that seeds change the order of
    the work and not its amount;
  - read lengths may follow a gamma distribution (Badread's model of
    fragment lengths; Wick 2019, doi:10.21105/joss.01316): a file's n
    bodies are the distribution's (k + 1/2)/n quantiles, rounded, at
    least 1 base;
  - a read's start and end adapters are present at rates of their own.

Parameters (a workload's "traffic" object):
  kind                "ligation" (SQK-NSK007 ends) or "barcoded" (native
                      barcodes in their ligation context)
  reads               reads per file (a batch file of the basecaller)
  read_len            bases of every read's body, or:
  length_mean, length_sd
                      the gamma distribution of the bodies' lengths
  start_adapter_rate  share of reads that carry their start adapter
  end_adapter_rate    share of reads that carry their end adapter
  chimera_rate        share of reads with an end + start pair in the middle
  error_rate          substitutions, deletions and insertions per base
  barcodes            barcoded: the barcode numbers drawn from
  no_barcode_rate     barcoded: share of reads with plain SQK-NSK007 ends
  gzip_level          0: plain FASTQ; 1-9: gzipped at that level
"""

from __future__ import annotations

import gzip

import numpy as np

NSK007_START = 'AATGTACTTCGTTCAGTTACGTATTGCT'
NSK007_END = 'GCAATACGTAACTGAACGAAGT'
BASES = np.frombuffer(b'ACGT', dtype=np.uint8)


def _mutate(rng, seq, error_rate):
    """Substitutions, deletions and insertions at error_rate per base
    (synth.py's rule; a sequence's draws are taken at once)."""
    r = rng.random(len(seq))
    new = BASES[rng.integers(0, 4, len(seq))].tobytes().decode('ascii')
    out = []
    for ch, x, b in zip(seq, r.tolist(), new):
        if x < error_rate * 0.6:
            out.append(b)
        elif x < error_rate * 0.8:
            continue
        elif x < error_rate:
            out.append(ch)
            out.append(b)
        else:
            out.append(ch)
    return ''.join(out)


def exactly(rng, n, rate):
    """n flags, round(rate * n) of them set, at places drawn from rng."""
    flags = np.zeros(n, dtype=bool)
    flags[rng.permutation(n)[:int(round(rate * n))]] = True
    return flags


def body_lengths(traffic, n):
    """The n body lengths of a file (int64), in a fixed order: read_len
    each, or the gamma distribution's (k + 1/2)/n quantiles."""
    if 'length_mean' not in traffic:
        return np.full(n, int(traffic['read_len']), dtype=np.int64)
    from scipy.special import gammaincinv
    mean, sd = float(traffic['length_mean']), float(traffic['length_sd'])
    shape, scale = (mean / sd) ** 2, sd * sd / mean
    q = gammaincinv(shape, (np.arange(n) + 0.5) / n) * scale
    return np.maximum(np.rint(q), 1).astype(np.int64)


def _blocks(rng, lengths, extra):
    """Each read's body (a string) and a quality block to cut from."""
    ends = np.cumsum(lengths)
    flat = BASES[rng.integers(0, 4, int(ends[-1]) if len(ends) else 0,
                              dtype=np.uint8)].tobytes().decode('ascii')
    bodies = [flat[e - n:e] for e, n in zip(ends.tolist(), lengths.tolist())]
    quals = rng.integers(43, 73, int(lengths.max(initial=0)) + extra,
                         dtype=np.uint8).tobytes().decode('ascii')
    return bodies, quals


def _with_chimera(rng, seq, end, start, error_rate):
    mid = len(seq) // 2
    return (seq[:mid] + _mutate(rng, end, error_rate)
            + _mutate(rng, start, error_rate) + seq[mid:])


def synth_reads(rng, lengths, start_rate=0.9, end_rate=0.9,
                chimera_rate=0.05, error_rate=0.1):
    """(name, seq, quals) of ligation reads (utils/synth.synth_reads),
    bodies of the given lengths in an order drawn from rng."""
    n = len(lengths)
    bodies, quals = _blocks(rng, rng.permutation(lengths), 300)
    has_start = exactly(rng, n, start_rate)
    has_end = exactly(rng, n, end_rate)
    chimeric = exactly(rng, n, chimera_rate)
    reads = []
    for k in range(n):
        seq = bodies[k]
        if has_start[k]:
            seq = _mutate(rng, NSK007_START, error_rate) + seq
        if has_end[k]:
            seq = seq + _mutate(rng, NSK007_END, error_rate)
        if chimeric[k]:
            seq = _with_chimera(rng, seq, NSK007_END, NSK007_START,
                                error_rate)
        reads.append(('read_%05d' % k, seq, quals[:len(seq)]))
    return reads


def synth_barcoded(rng, lengths, barcodes=range(1, 13), no_barcode_rate=0.1,
                   start_rate=1.0, end_rate=1.0, chimera_rate=0.05,
                   error_rate=0.1):
    """(name, seq, quals) of natively barcoded reads
    (utils/synth.synth_barcoded): each read's start and end constructs
    (its barcode's full native-barcode sequences, or plain SQK-NSK007
    ends) present at start_rate and end_rate."""
    from reference.porechop import full_native_barcode, load_table
    table = load_table()
    full = [full_native_barcode(table, b) for b in barcodes]
    n = len(lengths)
    bodies, quals = _blocks(rng, rng.permutation(lengths), 400)
    plain = exactly(rng, n, no_barcode_rate)
    has_start = exactly(rng, n, start_rate)
    has_end = exactly(rng, n, end_rate)
    chimeric = exactly(rng, n, chimera_rate)
    # The barcoded reads take the kit's barcodes in turn, in an order
    # drawn from rng.
    coded = np.nonzero(~plain)[0]
    which = np.zeros(n, dtype=np.int64)
    which[coded] = rng.permutation(np.arange(len(coded)) % len(full))
    reads = []
    for k in range(n):
        if plain[k]:
            start, end = NSK007_START, NSK007_END
        else:
            a = full[which[k]]
            start, end = a.start[1], a.end[1]
        seq = bodies[k]
        if has_start[k]:
            seq = _mutate(rng, start, error_rate) + seq
        if has_end[k]:
            seq = seq + _mutate(rng, end, error_rate)
        if chimeric[k]:
            seq = _with_chimera(rng, seq, end, start, error_rate)
        reads.append(('read_%05d' % k, seq, quals[:len(seq)]))
    return reads


def file_rng(seed, index):
    """The generator of a run's index-th file: one stream per (seed,
    file), for any whole-number seed."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), int(index)]))


def write(path, traffic, seed, index):
    """Writes the index-th batch file of a run with this seed to path;
    returns (reads, bases) in it."""
    rng = file_rng(seed, index)
    lengths = body_lengths(traffic, int(traffic['reads']))
    kind = traffic['kind']
    common = dict(chimera_rate=traffic.get('chimera_rate', 0.05),
                  error_rate=traffic.get('error_rate', 0.1))
    if kind == 'ligation':
        reads = synth_reads(
            rng, lengths, start_rate=traffic.get('start_adapter_rate', 0.9),
            end_rate=traffic.get('end_adapter_rate', 0.9), **common)
    elif kind == 'barcoded':
        reads = synth_barcoded(
            rng, lengths,
            barcodes=traffic.get('barcodes', list(range(1, 13))),
            no_barcode_rate=traffic.get('no_barcode_rate', 0.1),
            start_rate=traffic.get('start_adapter_rate', 1.0),
            end_rate=traffic.get('end_adapter_rate', 1.0), **common)
    else:
        raise ValueError('unknown traffic kind %r' % kind)
    text = ''.join('@%s\n%s\n+\n%s\n' % r for r in reads).encode('ascii')
    level = int(traffic.get('gzip_level', 0))
    if level:
        text = gzip.compress(text, compresslevel=level, mtime=0)
    with open(path, 'wb') as f:
        f.write(text)
    return len(reads), sum(len(r[1]) for r in reads)
