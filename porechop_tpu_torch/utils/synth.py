"""Synthetic nanopore-read generator for benchmarks and stress tests.

Produces a deterministic FASTQ that exercises every pipeline phase the way
real nanopore data does: most reads carry (possibly truncated, error-laden)
SQK-NSK007 ligation adapters on their ends, a few are chimeric with a
mid-read adapter, and the rest are clean.  Reference behaviour being
benchmarked: the three alignment phases of porechop/porechop.py:286-595.
"""

from __future__ import annotations

import numpy as np

# SQK-NSK007 start/end adapters (reference porechop/adapters.py:79-82).
NSK007_START = 'AATGTACTTCGTTCAGTTACGTATTGCT'
NSK007_END = 'GCAATACGTAACTGAACGAAGT'

BASES = np.frombuffer(b'ACGT', dtype=np.uint8)


def _mutate(rng, seq: str, error_rate: float) -> str:
    """Apply substitutions/indels at the given per-base error rate."""
    out = []
    for ch in seq:
        r = rng.random()
        if r < error_rate * 0.6:                      # substitution
            out.append(chr(BASES[rng.integers(4)]))
        elif r < error_rate * 0.8:                    # deletion
            continue
        elif r < error_rate:                          # insertion
            out.append(ch)
            out.append(chr(BASES[rng.integers(4)]))
        else:
            out.append(ch)
    return ''.join(out)


def synth_reads(n_reads: int = 512, read_len: int = 10_000, seed: int = 0,
                adapter_rate: float = 0.9, chimera_rate: float = 0.05,
                error_rate: float = 0.1):
    """Returns a list of (name, seq, quals) tuples.  Bodies and quality
    strings are generated with vectorized numpy byte ops so multi-100k-read
    files synthesize in seconds."""
    rng = np.random.default_rng(seed)
    bodies = BASES[rng.integers(0, 4, (n_reads, read_len))]
    quals_block = (33 + rng.integers(10, 40, (n_reads, read_len + 300))
                   ).astype(np.uint8)
    reads = []
    for k in range(n_reads):
        seq = bodies[k].tobytes().decode('ascii')
        if rng.random() < adapter_rate:
            seq = _mutate(rng, NSK007_START, error_rate) + seq
        if rng.random() < adapter_rate:
            seq = seq + _mutate(rng, NSK007_END, error_rate)
        if rng.random() < chimera_rate:
            mid = len(seq) // 2
            insert = (_mutate(rng, NSK007_END, error_rate)
                      + _mutate(rng, NSK007_START, error_rate))
            seq = seq[:mid] + insert + seq[mid:]
        quals = quals_block[k, :len(seq)].tobytes().decode('ascii')
        reads.append(('read_%05d' % k, seq, quals))
    return reads


# (reads, length) parts of the long-read set (chip_smoke.py,
# profile_torch.py --long): 2,560 reads, 67.3 Mb, read N50 40 kb, longest
# 200 kb, at every window rung from 8,192 to 262,144.
LONG_READ_PARTS = ((512, 8_000), (1_024, 16_000), (512, 24_000),
                   (256, 40_000), (128, 64_000), (96, 100_000),
                   (32, 200_000))


def synth_mixed(parts, **kwargs):
    """Reads of several lengths in one set: synth_reads(n, length, seed=k,
    **kwargs) for the k-th (n, length) of `parts` (k from 1), concatenated,
    permuted with numpy seed 0 and renamed read_%05d in the new order."""
    reads = [r for k, (n, length) in enumerate(parts, 1)
             for r in synth_reads(n, length, seed=k, **kwargs)]
    order = np.random.default_rng(0).permutation(len(reads))
    return [('read_%05d' % i, reads[k][1], reads[k][2])
            for i, k in enumerate(order)]


def write_fastq(path: str, reads) -> None:
    with open(path, 'w') as f:
        for name, seq, quals in reads:
            f.write('@%s\n%s\n+\n%s\n' % (name, seq, quals))


def ensure_fastq_streamed(path: str, n_reads: int, read_len: int,
                          seed: int = 0, chunk: int = 50_000, **kwargs) -> str:
    """Chunked, RESUMABLE synthesis straight to disk (gzipped when the path
    ends .gz): the 1M-read stretch file never fits the build host's RAM as
    one list, and takes longer to generate than one sitting — each chunk
    lands as its own part file, and completed parts are skipped on re-run.
    Concatenated gzip members are a single valid gzip stream, so the final
    file is plain `cat` of the parts.  Deterministic for a given
    (n_reads, read_len, seed, chunk)."""
    import gzip
    import hashlib
    import os
    import shutil
    if os.path.isfile(path):
        return path
    gz = path.endswith('.gz')
    # Key the part directory by the full parameter set: resuming with a
    # different seed/chunk/kwargs must NOT splice old-parameter parts into
    # the new corpus.
    params = repr((n_reads, read_len, seed, chunk, sorted(kwargs.items())))
    tag = hashlib.sha1(params.encode()).hexdigest()[:12]
    part_dir = '%s.parts-%s' % (path, tag)
    os.makedirs(part_dir, exist_ok=True)
    digits = len(str(max(n_reads - 1, 1)))
    parts = []
    for lo in range(0, n_reads, chunk):
        part = os.path.join(part_dir, 'part_%09d%s' % (lo,
                                                       '.gz' if gz else ''))
        parts.append(part)
        if os.path.isfile(part):
            continue
        n = min(chunk, n_reads - lo)
        tmp = part + '.tmp'
        opener = gzip.open if gz else open
        with opener(tmp, 'wb') as f:
            for name, seq, quals in synth_reads(n, read_len,
                                                seed=seed + lo, **kwargs):
                idx = lo + int(name.split('_')[1])
                f.write(('@read_%0*d\n%s\n+\n%s\n'
                         % (digits, idx, seq, quals)).encode('ascii'))
        os.replace(tmp, part)
    tmp = path + '.tmp%d' % os.getpid()
    with open(tmp, 'wb') as out:
        for part in parts:
            with open(part, 'rb') as f:
                shutil.copyfileobj(f, out)
    os.replace(tmp, path)
    shutil.rmtree(part_dir)
    return path


def ensure_fastq(path: str, **kwargs) -> str:
    import os
    if not os.path.isfile(path):
        write_fastq(path, synth_reads(**kwargs))
    return path
