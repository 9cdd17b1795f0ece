"""The pieces of the reference aligner's specification that the pipeline
uses: Dna5 encoding, the percent-identity round trip, and the DP's
minus-infinity.

The full executable specification (both host aligners and the derivation of
SeqAn's tie rules) lives with the JAX package in porechop_tpu/ops/spec.py;
this package keeps its own copy of only what it runs.
"""

from __future__ import annotations

import numpy as np

# MinValue<int>/2 (SeqAn dp_cell.h:117-124): the DP's minus-infinity.
NEG = -(2 ** 30)

# Dna5 encoding: everything that is not ACGTU (including '-') is N; SeqAn's
# char->Dna5 translation maps 'U'/'u' to T.
_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate('ACGT'):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
_CODE[ord('U')] = _CODE[ord('u')] = 3


def encode(seq: str) -> np.ndarray:
    """Encode a sequence string to Dna5 codes A,C,G,T,N -> 0..4."""
    return _CODE[np.frombuffer(seq.encode('ascii'), dtype=np.uint8)]


def encode_many(seqs) -> list:
    """Bulk twin of encode: one join + one table lookup for a whole list.
    Returns a list of per-sequence views into one freshly-allocated code
    array; the views are writable and disjoint, so callers (the middle
    phase masks hits in place) may mutate them safely."""
    if not seqs:
        return []
    codes = _CODE[np.frombuffer(''.join(seqs).encode('ascii'),
                                dtype=np.uint8)]
    offs = np.cumsum([len(s) for s in seqs])
    return np.split(codes, offs[:-1])


def seqan_pct(matches: int, length: int) -> float:
    """Percent identity with the reference's round trip through
    C++ std::to_string (6 decimals) and Python float()."""
    if length <= 0:
        return float('nan')
    return float('%.6f' % (100.0 * matches / length))
