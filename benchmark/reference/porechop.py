"""Porechop v0.2.4's trimming rules over one input file, as plain Python
and PyTorch: adapter-set detection, the barcode kit's orientation, end
trimming with barcode calling, the middle pass and the output records.

The rules follow Porechop's own code as its survey cites it
(porechop.py:286-734, nanopore_read.py:21-498).  The adapter table is a
frozen data copy (adapters.json); the alignments are align.py's.  Two
shortcuts are exact, not approximations:

* A hit (full-adapter identity >= t percent) needs matches m >= t F / 100
  over an adapter span of F >= adapter length columns; every other column
  costs at most c = max(-mismatch, -gap open, -gap extend), so the
  alignment's score is at least ((match + c) t - 100 c) F / 100.  Where a
  lane's best score is below that at F = adapter length, no hit is
  possible, and only the lanes above it are aligned with their traceback.
* An identity compared with an integral threshold is compared as the
  rational 100 m / len: Porechop's six-decimal rounding cannot cross the
  threshold unless the two are equal, since |100 m - t len| >= 1.

Nothing here imports the program under test.
"""

from __future__ import annotations

import gzip
import json
import os
import time

import numpy as np

import torch

from . import align as aln

_HERE = os.path.dirname(os.path.abspath(__file__))


class AdapterSet:
    """One adapter set of Porechop's table."""

    def __init__(self, name, start=None, end=None):
        self.name = name
        self.start = tuple(start) if start else ()
        self.end = tuple(end) if end else ()
        self.best_start = 0.0
        self.best_end = 0.0

    def best(self):
        return max(self.best_start, self.best_end)

    def is_barcode(self):
        return self.name.startswith('Barcode ')

    def direction(self):
        return 'reverse' if '_rev' in self.start[0] else 'forward'

    def barcode_name(self):
        names = [self.name] + [s[0] for s in (self.start, self.end) if s]
        return sorted(names, key=len)[0].replace(' ', '_')


def load_table():
    with open(os.path.join(_HERE, 'adapters.json')) as f:
        return [AdapterSet(e['name'], e['start'], e['end'])
                for e in json.load(f)]


def _by_name(table, name):
    return [x for x in table if x.name == name][0]


def full_native_barcode(table, k):
    bc = _by_name(table, 'Barcode %d (reverse)' % k)
    return AdapterSet(
        'Native barcoding %d (full sequence)' % k,
        ('NB%02d_start' % k, 'AATGTACTTCGTTCAGTTACGTATTGCTAAGGTTAA'
         + bc.start[1] + 'CAGCACCT'),
        ('NB%02d_end' % k, 'AGGTGCTG' + bc.end[1]
         + 'TTAACCTTAGCAATACGTAACTGAACGAAGT'))


_RAPID_TAIL = 'GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA'


def full_rapid_barcode(table, k, new):
    bc = _by_name(table, 'Barcode %d (forward)' % k)
    mid = 'GCTTGGGTGTTTAACC' if new else 'TATTGCT'
    return AdapterSet(
        'Rapid barcoding %d (full sequence, %s)' % (k, 'new' if new else
                                                    'old'),
        ('RB%02d_full' % k, 'AATGTACTTCGTTCAGTTACG' + mid + bc.start[1]
         + _RAPID_TAIL))


# ---------------------------------------------------------------------------
# Input
# ---------------------------------------------------------------------------

class Reads:
    """A file's reads: names, sequences (upper case, U read as T for RNA
    reads) and qualities padded with '+'."""

    def __init__(self, path):
        with open(path, 'rb') as f:
            raw = f.read()
        if raw[:3] == b'\x1f\x8b\x08':
            raw = gzip.decompress(raw)
        lines = raw.split(b'\n')
        if lines and lines[-1] == b'':
            lines.pop()
        if len(lines) % 4:
            raise ValueError('%s: not 4-line FASTQ records' % path)
        self.names = [x[1:].decode().strip() for x in lines[0::4]]
        seqs = [x.decode().strip().upper() for x in lines[1::4]]
        quals = [x.decode().strip() for x in lines[3::4]]
        self.rna = []
        for k, s in enumerate(seqs):
            u = s.count('U')
            rna = bool(u) and u > s.count('T')
            if rna:
                seqs[k] = s.replace('U', 'T')
            self.rna.append(rna)
            if len(quals[k]) < len(seqs[k]):
                quals[k] += '+' * (len(seqs[k]) - len(quals[k]))
        self.seqs = seqs
        self.quals = quals

    def __len__(self):
        return len(self.seqs)


# ---------------------------------------------------------------------------
# Batched alignment over (window, adapter) pairs
# ---------------------------------------------------------------------------

# Lanes x columns per block of a score pass; lanes x columns x rows (the
# trace bits' bytes) per block of an alignment pass.
SCORE_CELLS = 1 << 27
BITS_BYTES = 1 << 30

_FIELDS = ('score', 'read_start', 'read_end', 'matches', 'aligned_len',
           'full_len')


class Lanes:
    """Alignment lanes: window win[k] of (mat, lens) against adapter
    ad[k] of `adapters` (strings).  Lanes run grouped by adapter length,
    in blocks; results come back in lane order."""

    def __init__(self, mat, lens, win, ad, adapters, scheme, device):
        self.mat, self.lens, self.scheme, self.device = (mat, lens, scheme,
                                                         device)
        self.win = torch.as_tensor(win, dtype=torch.int64)
        self.ad = torch.as_tensor(ad, dtype=torch.int64)
        self.codes = [aln.encode(a) for a in adapters]
        alen = torch.tensor([len(c) for c in self.codes], dtype=torch.int64)
        self.alen = alen[self.ad] if len(self.ad) else alen[:0]

    def _groups(self, per_lane_bytes):
        """(lane indices, A, width) blocks: one adapter length each, lanes
        longest first (and of one adapter together, so that a block of
        one adapter takes its substitution rows directly), a block holding
        lanes down to half its longest, as many as per_lane_bytes(width,
        A) allows."""
        out = []
        lane_len = self.lens[self.win.to(self.device)].cpu() \
            if len(self.win) else self.win
        for A in sorted(set(self.alen.tolist())):
            idx = (self.alen == A).nonzero()[:, 0]
            idx = idx[torch.argsort(self.ad[idx], stable=True)]
            idx = idx[torch.argsort(lane_len[idx], descending=True,
                                    stable=True)]
            neg = (-lane_len[idx]).numpy()
            lo = 0
            while lo < len(idx):
                width = max(int(-neg[lo]), 1)
                half = int(np.searchsorted(neg, -width / 2, side='right'))
                hi = min(len(idx), lo + max(1, per_lane_bytes(width, A)),
                         max(lo + 1, half))
                out.append((idx[lo:hi], A, width))
                lo = hi
        return out

    def _inputs(self, idx, A, width):
        w = self.win[idx].to(self.device)
        rows = self.mat[w, :width].contiguous()
        rl = self.lens[w]
        a = self.ad[idx]
        table = torch.stack([self.codes[k] for k in
                             sorted(set(a.tolist()))])
        pos = {k: q for q, k in enumerate(sorted(set(a.tolist())))}
        sel = torch.tensor([pos[k] for k in a.tolist()], dtype=torch.int64)
        adps = table[sel].to(self.device)
        al = torch.full((len(idx),), A, dtype=torch.int64,
                        device=self.device)
        same = len(pos) == 1
        return rows, rl, adps, al, same

    def scores(self):
        """Best score of each lane (host int64)."""
        out = torch.zeros(len(self.win), dtype=torch.int64)
        for idx, A, width in self._groups(
                lambda width, A: SCORE_CELLS // width):
            rows, rl, adps, al, same = self._inputs(idx, A, width)
            out[idx] = aln.score(rows, rl, adps, al, self.scheme,
                                 same).cpu()
        return out

    def align(self, variant='seqan'):
        """align.Result of each lane (host)."""
        n = len(self.win)
        out = {k: torch.zeros(n, dtype=torch.int64) for k in _FIELDS}
        for idx, A, width in self._groups(
                lambda width, A: BITS_BYTES // ((width + 1) * (A + 1))):
            rows, rl, adps, al, _ = self._inputs(idx, A, width)
            r = aln.align(rows, rl, adps, al, self.scheme, variant)
            for k in _FIELDS:
                out[k][idx] = getattr(r, k)
        return aln.Result(**out)


def hit_floor(scheme, threshold):
    """100 x the least score per adapter base that a hit at `threshold`
    percent needs (see the module's docstring)."""
    match, mismatch, gap_open, gap_ext = scheme
    c = max(-mismatch, -gap_open, -gap_ext)
    return (match + c) * threshold - 100 * c


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

class Options:
    """Porechop's options that the rules read, with its defaults."""

    def __init__(self, **kw):
        self.end_size = 150
        self.extra_end_trim = 2
        self.end_threshold = 75.0
        self.min_trim_size = 4
        self.adapter_threshold = 90.0
        self.check_reads = 10000
        self.middle_threshold = 90.0
        self.extra_middle_trim_good_side = 10
        self.extra_middle_trim_bad_side = 100
        self.min_split_read_size = 1000
        self.barcode_threshold = 75.0
        self.barcode_diff = 5.0
        self.barcodes = False
        self.discard_middle = False
        self.scheme = (3, -6, -5, -2)
        for k, v in kw.items():
            if not hasattr(self, k):
                raise KeyError(k)
            setattr(self, k, v)
        if self.barcodes:
            self.discard_middle = True


def _windows(seqs, end_size, device):
    """(matrix, lengths) of every read's start window (row 2k) and end
    window (row 2k + 1)."""
    wins = []
    for s in seqs:
        wins.append(s[:end_size])
        wins.append(s[-end_size:])
    return aln.pack(wins, device)


def detect(reads, opts, table, device, variant='seqan'):
    """Phase 1: the matching adapter sets, in table order, with their best
    identities; the check reads are the file's first opts.check_reads."""
    n = min(len(reads), opts.check_reads)
    mat, lens = _windows(reads.seqs[:n], opts.end_size, device)
    sets = [AdapterSet(x.name, x.start, x.end) for x in table]
    floor100 = hit_floor(opts.scheme, opts.adapter_threshold)
    # Distinct (side, sequence) groups; a side's windows are rows 2k
    # (start) or 2k + 1 (end).
    groups = []
    for s in sets:
        for side, pair in (('start', s.start), ('end', s.end)):
            if pair and (side, pair[1]) not in groups:
                groups.append((side, pair[1]))

    def lanes(gs):
        win = [2 * r + (side == 'end') for side, _ in gs for r in range(n)]
        ad = [g for g in range(len(gs)) for _ in range(n)]
        return Lanes(mat, lens, win, ad, [q for _, q in gs], opts.scheme,
                     device)

    top = lanes(groups).scores().reshape(len(groups), n).max(1).values \
        if n else torch.full((len(groups),), -1)
    alive = {g: 100 * int(top[k]) >= floor100 * len(g[1])
             for k, g in enumerate(groups)}
    # Exact identities for every side of a set that may pass.
    need = []
    for s in sets:
        gs = ([('start', s.start[1])] if s.start else []) + \
            ([('end', s.end[1])] if s.end else [])
        if any(alive[g] for g in gs):
            need += [g for g in gs if g not in need]
    exact = {}
    if need and n:
        r = lanes(need).align(variant)
        m = r.matches.reshape(len(need), n)
        f = r.full_len.reshape(len(need), n)
        key = torch.where(f > 0, m.double() / f.clamp(min=1).double(), -1.0)
        best = key.argmax(1)
        for k, g in enumerate(need):
            q = int(best[k])
            exact[g] = (aln.pct(int(m[k, q]), int(f[k, q]))
                        if int(f[k, q]) > 0 else 0.0)
    for s in sets:
        if s.start:
            s.best_start = exact.get(('start', s.start[1]), 0.0)
        if s.end:
            s.best_end = exact.get(('end', s.end[1]), 0.0)
    matching = [s for s in sets if s.best() >= opts.adapter_threshold]
    return _fix_up_1d2(matching)


def _fix_up_1d2(matching):
    names = [x.name for x in matching]
    if ('1D^2 part 1' in names and '1D^2 part 2' in names
            and 'SQK-MAP006 Short' in names):
        def score_of(n):
            return [x for x in matching if x.name == n][0].best()
        if (score_of('1D^2 part 1') >= score_of('SQK-MAP006 Short')
                and score_of('1D^2 part 2') >= score_of('SQK-MAP006 Short')):
            matching = [x for x in matching if x.name != 'SQK-MAP006 Short']
    return matching


def barcode_orientation(matching):
    """Porechop's choose_barcoding_kit; None where it would stop with an
    error."""
    f_or = r_or = f_and = r_and = 0
    for s in matching:
        low = s.name.lower()
        if 'barcode' in low:
            if '(forward)' in low:
                f_or += s.best()
                f_and += s.best_start + s.best_end
            elif '(reverse)' in low:
                r_or += s.best()
                r_and += s.best_start + s.best_end
    if f_or == 0 and r_or == 0:
        return None
    if f_or > r_or:
        return 'forward'
    if r_or > f_or:
        return 'reverse'
    if f_and > r_and:
        return 'forward'
    if r_and > f_and:
        return 'reverse'
    return None


def add_full_barcode_sets(matching, table):
    names = [x.name for x in matching]
    for k in range(1, 97):
        if 'SQK-NSK007' in names and 'Barcode %d (reverse)' % k in names:
            matching.append(full_native_barcode(table, k))
        if 'Rapid' in names and 'Barcode %d (forward)' % k in names:
            if 'RBK004_upstream' in names:
                matching.append(full_rapid_barcode(table, k, True))
            elif 'SQK-NSK007' in names:
                matching.append(full_rapid_barcode(table, k, False))
    return matching


class ReadState:
    __slots__ = ('start_trim', 'end_trim', 'start_bc', 'end_bc', 'call',
                 'middle_trims')

    def __init__(self):
        self.start_trim = 0
        self.end_trim = 0
        self.start_bc = {}
        self.end_bc = {}
        self.call = 'none'
        self.middle_trims = []


def trim_ends(reads, states, matching, orientation, opts, device,
              variant='seqan'):
    """Phase 2: end trims and, with barcodes, each read's barcode call."""
    mat, lens = _windows(reads.seqs, opts.end_size, device)
    n = len(reads)
    start_sets = [m for m in matching if m.start]
    end_sets = [m for m in matching if m.end]
    groups = []
    for side, sets in (('start', start_sets), ('end', end_sets)):
        for m in sets:
            g = (side, (m.start if side == 'start' else m.end)[1])
            if g not in groups:
                groups.append(g)
    win = [2 * r + (side == 'end') for side, _ in groups for r in range(n)]
    ad = [g for g in range(len(groups)) for _ in range(n)]
    r = Lanes(mat, lens, win, ad, [q for _, q in groups], opts.scheme,
              device).align(variant)
    col = {g: k for k, g in enumerate(groups)}
    fields = {k: getattr(r, k).reshape(len(groups), n).tolist()
              for k in ('matches', 'aligned_len', 'read_start', 'read_end',
                        'full_len')}
    thr = opts.end_threshold
    for k, st in enumerate(states):
        for side, sets in (('start', start_sets), ('end', end_sets)):
            for m in sets:
                g = col[(side, (m.start if side == 'start' else m.end)[1])]
                mt, alen = fields['matches'][g][k], fields['aligned_len'][g][k]
                rs, re = fields['read_start'][g][k], fields['read_end'][g][k]
                partial_ok = alen > 0 and 100 * mt > thr * alen
                if side == 'start':
                    if (partial_ok and re != opts.end_size
                            and re - rs >= opts.min_trim_size):
                        st.start_trim = max(st.start_trim,
                                            re + opts.extra_end_trim)
                else:
                    if (partial_ok and rs != 0
                            and re - rs >= opts.min_trim_size):
                        st.end_trim = max(st.end_trim,
                                          (opts.end_size - rs)
                                          + opts.extra_end_trim)
                if (opts.barcodes and m.is_barcode()
                        and m.direction() == orientation):
                    full = (aln.pct(mt, fields['full_len'][g][k])
                            if rs != -1 else 0.0)
                    bcs = st.start_bc if side == 'start' else st.end_bc
                    bcs[m.barcode_name()] = full
        if opts.barcodes:
            st.call = _barcode_call(st, opts)


def _barcode_call(st, opts):
    key = lambda x: x[1]                                   # noqa: E731
    starts = sorted(st.start_bc.items(), reverse=True, key=key)
    ends = sorted(st.end_bc.items(), reverse=True, key=key)
    none = ('none', 0.0)
    combined, seen = [], set()
    for name, score in sorted(starts + ends, reverse=True, key=key):
        if name not in seen:
            combined.append((name, score))
            seen.add(name)
    best = combined[0] if combined else none
    second = combined[1] if len(combined) > 1 else none
    if (best[1] >= opts.barcode_threshold
            and best[1] >= second[1] + opts.barcode_diff):
        return best[0]
    return 'none'


def _trimmed(seq, st):
    if not st.start_trim and not st.end_trim:
        return seq
    return seq[st.start_trim:len(seq) - st.end_trim]


def split_middles(reads, states, matching, opts, device, variant='seqan'):
    """Phase 3: each read's middle trim intervals.  Per read, adapters in
    order: align the masked read; on a hit mask it and align the same
    adapter again, else go on to the next adapter."""
    adapters = []
    for m in matching:
        if m.start:
            adapters.append(m.start)
        if m.end and (not m.start or m.end[1] != m.start[1]):
            adapters.append(m.end)
    start_names = {m.start[0] for m in matching if m.start}
    end_names = {m.end[0] for m in matching if m.end}
    n_ad = len(adapters)
    if not n_ad or not len(reads):
        return
    mat, lens = aln.pack([_trimmed(s, st) for s, st in
                        zip(reads.seqs, states)], device)
    thr = opts.middle_threshold
    floor100 = hit_floor(opts.scheme, thr)
    seqs = [q for _, q in adapters]

    def run(lanes):
        """{(read, adapter): (hit, rs, re)} for (read, adapter) lanes on
        the reads as masked now."""
        win = [r for r, _ in lanes]
        ad = [a for _, a in lanes]
        sc = Lanes(mat, lens, win, ad, seqs, opts.scheme, device).scores()
        alen = torch.tensor([len(seqs[a]) for a in ad], dtype=torch.int64)
        cand = (100 * sc >= floor100 * alen).nonzero()[:, 0].tolist()
        out = {lane: (False, 0, 0) for lane in lanes}
        if cand:
            res = Lanes(mat, lens, [win[c] for c in cand],
                        [ad[c] for c in cand], seqs, opts.scheme,
                        device).align(variant)
            for q, c in enumerate(cand):
                f = int(res.full_len[q])
                hit = (int(res.read_start[q]) != -1 and f > 0
                       and 100 * int(res.matches[q]) >= thr * f)
                out[lanes[c]] = (hit, int(res.read_start[q]),
                                 int(res.read_end[q]))
        return out

    def apply(r, a, rs, re):
        mat[r, rs:re] = aln.N_CODE
        name = adapters[a][0]
        lo = rs - (opts.extra_middle_trim_bad_side if name in start_names
                   else opts.extra_middle_trim_good_side)
        hi = re + (opts.extra_middle_trim_bad_side if name in end_names
                   else opts.extra_middle_trim_good_side)
        states[r].middle_trims.append((lo, hi))

    # Round 0: every pair on the unmasked reads; a read's alignments up to
    # its first hit are exactly these.
    first = run([(r, a) for r in range(len(reads)) for a in range(n_ad)])
    pend = []
    for r in range(len(reads)):
        for a in range(n_ad):
            hit, rs, re = first[(r, a)]
            if hit:
                apply(r, a, rs, re)
                pend.append((r, a))
                break
    while pend:
        res = run(pend)
        nxt = []
        for r, a in pend:
            hit, rs, re = res[(r, a)]
            if hit:
                apply(r, a, rs, re)
                nxt.append((r, a))
            elif a + 1 < n_ad:
                nxt.append((r, a + 1))
        pend = nxt


def _merge(ranges):
    out = []
    for s, e in sorted(ranges):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _split_name(name, k):
    if ' ' not in name:
        return name + '_' + str(k)
    return name.replace(' ', '_' + str(k) + ' ', 1)


def fastq_record(reads, k, st, opts):
    """The text Porechop writes for read k (possibly several split parts,
    possibly nothing)."""
    name, seq, qual = reads.names[k], reads.seqs[k], reads.quals[k]

    def dna(s):
        return s.replace('T', 'U') if reads.rna[k] else s

    if not st.middle_trims:
        seq, qual = _trimmed(seq, st), _trimmed(qual, st)
        if not seq:
            return ''
        return '@' + name + '\n' + dna(seq) + '\n+\n' + qual + '\n'
    if opts.discard_middle:
        return ''
    tseq, tqual = _trimmed(seq, st), _trimmed(qual, st)
    n = len(tseq)
    parts, pos = [], 0
    for s, e in _merge(st.middle_trims):
        s, e = max(s, 0), min(e, n)
        if e <= s:
            continue
        if s > pos:
            parts.append((tseq[pos:s], tqual[pos:s]))
        pos = max(pos, e)
    if pos < n:
        parts.append((tseq[pos:], tqual[pos:]))
    out = ''
    for i, (ps, pq) in enumerate(p for p in parts
                                 if len(p[0]) >= opts.min_split_read_size):
        out += ('@' + _split_name(name, i + 1) + '\n' + dna(ps) + '\n+\n'
                + pq + '\n')
    return out


class Outcome:
    """What a Porechop run on one file gives: the adapter lines of the
    matching sets (name, sequence, in the order the end-trimming banner
    lists them), the barcode orientation, and the output streams by name
    ('stdout', or a bin's file name) as bytes."""

    def __init__(self, adapter_lines, orientation, streams):
        self.adapter_lines = adapter_lines
        self.orientation = orientation
        self.streams = streams


def run(path, opts, device, variant='seqan', timings=None):
    """Porechop on one FASTQ file (plain or gzipped): its Outcome.
    timings: a dict that gets each stage's seconds added."""
    clock = _Stages(timings, device)
    table = load_table()
    reads = Reads(path)
    states = [ReadState() for _ in range(len(reads))]
    clock('load')
    matching = detect(reads, opts, table, device, variant)
    clock('detect')
    orientation = None
    if opts.barcodes:
        orientation = barcode_orientation(matching)
        if orientation is None:
            raise RuntimeError('Porechop would stop: no barcode orientation')
    matching = add_full_barcode_sets(matching, table)
    lines = []
    for m in matching:
        for pair in (m.start, m.end):
            if pair:
                lines.append(pair)
    if matching:
        trim_ends(reads, states, matching, orientation, opts, device,
                  variant)
        clock('ends')
        split_middles(reads, states, matching, opts, device, variant)
        clock('middle')
    streams = {}
    if opts.barcodes:
        texts = {}
        for k, st in enumerate(states):
            rec = fastq_record(reads, k, st, opts)
            if rec:
                texts.setdefault(st.call, []).append(rec)
        streams = {name + '.fastq': ''.join(v).encode()
                   for name, v in texts.items()}
    else:
        streams['stdout'] = ''.join(
            fastq_record(reads, k, st, opts)
            for k, st in enumerate(states)).encode()
    clock('output')
    return Outcome(lines, orientation, streams)


class _Stages:
    """Adds the seconds since the last call to timings[stage]."""

    def __init__(self, timings, device):
        self.timings = timings
        self.sync = (torch.cuda.synchronize if str(device).startswith('cuda')
                     else (lambda: None))
        self.t = time.perf_counter()

    def __call__(self, stage):
        if self.timings is None:
            return
        self.sync()
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - self.t
        self.t = now

