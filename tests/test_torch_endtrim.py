"""Phase 2's decisions (porechop_tpu_torch/pipeline/phases.py
find_adapters_at_read_ends) on the CPU, against the per-(read, set) loop
that made them one pair at a time, kept here as the oracle with the
Read.determine_barcode it called.  Both run on the same synthetic result
arrays, with AlignJobs stubbed; every Read field, the pairs handed to
AlignJobs, the printed text at each verbosity and the dump lines must
agree.  Then the span recorder's end-trim counters on a small barcoded
CLI run."""

import contextlib
import io

import numpy as np
import pytest

import porechop_tpu_torch.cli as torch_cli
from porechop_tpu_torch.adapters import (ADAPTERS, Adapter,
                                         make_full_native_barcode_adapter)
from porechop_tpu_torch.ops import spec
from porechop_tpu_torch.pipeline import phases
from porechop_tpu_torch.pipeline.model import Read
from porechop_tpu_torch.utils import spans
from porechop_tpu_torch.utils.synth import synth_barcoded, write_fastq

from .test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

END_SIZE = 150
EXTRA = 2
END_THRESHOLD = 75.0
MIN_TRIM = 4
BARCODE_THRESHOLD = 75.0
BARCODE_DIFF = 5.0
SCHEME = (3, -6, -5, -2)
FIELDS = ('start_trim_amount', 'end_trim_amount', 'start_adapter_alignments',
          'end_adapter_alignments', 'start_barcode_scores',
          'end_barcode_scores', 'best_start_barcode', 'best_end_barcode',
          'second_best_start_barcode', 'second_best_end_barcode',
          'barcode_call')
# (verbosity, collect_dumps)
MODES = ((0, 0), (1, 0), (2, 0), (3, 0), (0, 2), (0, 3))


# --- the oracle: the per-(read, set) loop and Read.determine_barcode ---

def determine_barcode(read, barcode_threshold, barcode_diff,
                      require_two_barcodes):
    start_scores = sorted(read.start_barcode_scores.items(),
                          reverse=True, key=lambda x: x[1])
    end_scores = sorted(read.end_barcode_scores.items(),
                        reverse=True, key=lambda x: x[1])
    if len(start_scores) >= 1:
        read.best_start_barcode = start_scores[0]
    if len(start_scores) >= 2:
        read.second_best_start_barcode = start_scores[1]
    if len(end_scores) >= 1:
        read.best_end_barcode = end_scores[0]
    if len(end_scores) >= 2:
        read.second_best_end_barcode = end_scores[1]

    call = 'none'
    if require_two_barcodes:
        ok = (read.best_start_barcode[1] >= barcode_threshold
              and read.best_end_barcode[1] >= barcode_threshold
              and read.best_start_barcode[1] >=
              read.second_best_start_barcode[1] + barcode_diff
              and read.best_end_barcode[1] >=
              read.second_best_end_barcode[1] + barcode_diff
              and read.best_start_barcode[0] == read.best_end_barcode[0])
        if ok:
            call = read.best_start_barcode[0]
    else:
        combined = []
        seen = set()
        for name, score in sorted(start_scores + end_scores,
                                  reverse=True, key=lambda x: x[1]):
            if name not in seen:
                combined.append((name, score))
                seen.add(name)
        best = combined[0] if combined else ('none', 0.0)
        second = combined[1] if len(combined) >= 2 else ('none', 0.0)
        if best[1] >= barcode_threshold and best[1] >= second[1] + barcode_diff:
            call = best[0]
    read.barcode_call = call
    if (read.albacore_barcode_call is not None
            and read.barcode_call != read.albacore_barcode_call):
        read.barcode_call = 'none'


def oracle_end_trim(reads, matching_sets, verbosity, end_size,
                    extra_trim_size, end_threshold, scoring_scheme_vals,
                    print_dest, min_trim_size, check_barcodes,
                    barcode_threshold, barcode_diff, require_two_barcodes,
                    forward_or_reverse_barcodes, collect_dumps=0):
    AlignJobs = phases.AlignJobs
    if verbosity > 0:
        phases.print_end_trim_header(matching_sets, print_dest)

    read_count = len(reads)
    if verbosity == 1:
        phases.output_progress_line(0, read_count, print_dest)

    start_sets = [m for m in matching_sets if m.start_sequence]
    end_sets = [m for m in matching_sets if m.end_sequence]

    windows = spec.encode_many(
        [s for read in reads
         for s in (read.seq[:end_size], read.seq[-end_size:])])
    adapter_seqs, adapter_idx = [], {}

    def aidx(seq):
        if seq not in adapter_idx:
            adapter_idx[seq] = len(adapter_seqs)
            adapter_seqs.append(spec.encode(seq))
        return adapter_idx[seq]

    pairs = []
    for ri in range(read_count):
        for m in start_sets:
            pairs.append((2 * ri, aidx(m.start_sequence[1])))
        for m in end_sets:
            pairs.append((2 * ri + 1, aidx(m.end_sequence[1])))
    jobs_per_read = max(1, len(start_sets) + len(end_sets))
    prog = phases.HarvestProgress(read_count,
                                  len(start_sets) + len(end_sets),
                                  lambda k: k // jobs_per_read, print_dest,
                                  enabled=verbosity == 1)
    res = AlignJobs(windows, adapter_seqs, np.array(pairs, dtype=np.int64),
                    scoring_scheme_vals).run(progress=prog) if pairs else None

    k = 0
    per_read_lines = []
    for read in reads:
        for m in start_sets:
            full_score = res['full_pct'][k]
            partial_score = res['partial_pct'][k]
            read_start = int(res['read_start'][k])
            read_end = int(res['read_end_excl'][k])
            k += 1
            if (partial_score > end_threshold and read_end != end_size
                    and read_end - read_start >= min_trim_size):
                trim_amount = read_end + extra_trim_size
                read.start_trim_amount = max(read.start_trim_amount,
                                             trim_amount)
                read.start_adapter_alignments.append(
                    (m, full_score, partial_score, read_start, read_end))
            if (check_barcodes and m.is_barcode()
                    and m.barcode_direction() == forward_or_reverse_barcodes):
                read.start_barcode_scores[m.get_barcode_name()] = full_score
        for m in end_sets:
            full_score = res['full_pct'][k]
            partial_score = res['partial_pct'][k]
            read_start = int(res['read_start'][k])
            read_end = int(res['read_end_excl'][k])
            k += 1
            if (partial_score > end_threshold and read_start != 0
                    and read_end - read_start >= min_trim_size):
                trim_amount = (end_size - read_start) + extra_trim_size
                read.end_trim_amount = max(read.end_trim_amount, trim_amount)
                read.end_adapter_alignments.append(
                    (m, full_score, partial_score, read_start, read_end))
            if (check_barcodes and m.is_barcode()
                    and m.barcode_direction() == forward_or_reverse_barcodes):
                read.end_barcode_scores[m.get_barcode_name()] = full_score
        if check_barcodes:
            determine_barcode(read, barcode_threshold, barcode_diff,
                              require_two_barcodes)
        dump_level = verbosity if verbosity > 1 else collect_dumps
        if dump_level == 2:
            per_read_lines.append(read.formatted_start_and_end_seq(
                end_size, extra_trim_size, check_barcodes))
        elif dump_level > 2:
            per_read_lines.append(read.full_start_end_output(
                end_size, extra_trim_size, check_barcodes))

    if verbosity == 1:
        prog.finish()
    elif verbosity > 1:
        for line in per_read_lines:
            print(line, file=print_dest)
    if verbosity > 0:
        print('', file=print_dest)
    return per_read_lines


# --- inputs ---

class StubJobs:
    """AlignJobs with results drawn from a seed over a few values on and
    beside each threshold, so that boundaries and equal scores recur.
    Records what each instance was handed."""

    seed = 0
    calls = []

    def __init__(self, windows, adapters, pairs, scheme, device=None):
        self.calls.append((windows, adapters, pairs))
        self.P = len(pairs)

    def run(self, progress=None):
        rng = np.random.default_rng(self.seed)
        P = self.P
        start = rng.choice([-1, 0, 1, 3, 60, END_SIZE - MIN_TRIM], P)
        span = rng.choice([MIN_TRIM - 1, MIN_TRIM, MIN_TRIM + 1, 30], P)
        end = np.minimum(start + span, END_SIZE)
        end = np.where(rng.random(P) < 0.15, END_SIZE, end)
        partial = rng.choice([END_THRESHOLD - 0.1, END_THRESHOLD,
                              END_THRESHOLD + 0.1, 90.0], P)
        full = rng.choice([70.0, BARCODE_THRESHOLD, 80.0, 85.0, 90.0,
                           100.0 / 3], P)
        failed = start == -1
        if progress is not None:
            progress(np.arange(P))
        return {'full_pct': np.where(failed, 0.0, full),
                'partial_pct': np.where(failed, 0.0, partial),
                'read_start': start,
                'read_end_excl': np.where(failed, 0, end)}


def _set(name):
    return next(a for a in ADAPTERS if a.name == name)


def _reverse_barcoded():
    sets = [_set('SQK-NSK007')] + [_set('Barcode %d (reverse)' % i)
                                   for i in range(1, 5)]
    return sets + [make_full_native_barcode_adapter(i) for i in range(1, 5)]


def _forward_barcoded():
    return ([_set('SQK-NSK007'), _set('Rapid')]
            + [_set('Barcode %d (forward)' % i) for i in range(1, 5)])


def _start_only():
    bc = _set('Barcode 7 (reverse)')
    return [_set('Rapid'), _set('RBK004_upstream'),
            Adapter(bc.name, start_sequence=bc.start_sequence)]


def _end_only():
    nsk = _set('SQK-NSK007')
    return [Adapter('NSK007 end', end_sequence=nsk.end_sequence),
            Adapter('cDNA end', end_sequence=_set('cDNA SSP').end_sequence)]


def _shared():
    """Two sets on one adapter sequence, and two barcode sets under one
    barcode name (BC01) with other sequences."""
    nsk = _set('SQK-NSK007')
    bc = _set('Barcode 1 (reverse)')
    other = _set('Barcode 2 (reverse)')
    return [nsk, Adapter('NSK007 copy', start_sequence=('copy_start',
                                                         nsk.start_sequence[1]),
                         end_sequence=nsk.end_sequence),
            bc, other,
            Adapter('Barcode 1 (reverse) again',
                    start_sequence=(bc.start_sequence[0],
                                    other.end_sequence[1]),
                    end_sequence=(bc.end_sequence[0],
                                  other.start_sequence[1])),
            _set('Barcode 3 (reverse)')]


# (sets, n_reads, check_barcodes, require_two, direction, albacore calls);
# a case whose name ends in _diff0 runs at barcode_diff 0, where the order
# of equal scores decides the call.
CASES = {
    'ligation': (lambda: [_set('SQK-NSK007')], 120, False, False,
                 'reverse', None),
    'reverse': (_reverse_barcoded, 160, True, False, 'reverse', None),
    'reverse_two': (_reverse_barcoded, 160, True, True, 'reverse', None),
    'forward': (_forward_barcoded, 160, True, False, 'forward', None),
    'forward_two': (_forward_barcoded, 160, True, True, 'forward', None),
    'reverse_with_forward_sets': (_forward_barcoded, 60, True, False,
                                  'reverse', None),
    'albacore': (_reverse_barcoded, 160, True, False, 'reverse',
                 (None, 'none', 'BC01', 'BC02')),
    'albacore_two': (_reverse_barcoded, 160, True, True, 'reverse',
                     (None, 'BC01', 'BC03')),
    'no_end_sets': (_start_only, 120, True, False, 'reverse', None),
    'no_end_sets_two': (_start_only, 120, True, True, 'reverse', None),
    'no_start_sets': (_end_only, 120, True, False, 'reverse', None),
    'zero_reads': (_reverse_barcoded, 0, True, False, 'reverse', None),
    'shared': (_shared, 160, True, False, 'reverse', ('BC01', None)),
    'shared_two': (_shared, 160, True, True, 'reverse', None),
    'reverse_diff0': (_reverse_barcoded, 160, True, False, 'reverse', None),
    'reverse_two_diff0': (_reverse_barcoded, 160, True, True, 'reverse',
                          None),
    'shared_diff0': (_shared, 160, True, False, 'reverse', None),
}


# The cases whose reads get a barcode call other than 'none' (the others
# lack barcode sets in the direction, or an end to agree under require_two).
CALLING = ('reverse', 'reverse_two', 'forward', 'forward_two', 'albacore',
           'albacore_two', 'no_end_sets', 'shared', 'shared_two',
           'reverse_diff0', 'reverse_two_diff0', 'shared_diff0')


def _reads(n, albacore, seed):
    """n reads from 60 bp (shorter than an end window) to 700 bp."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        length = int(rng.choice([60, 150, 290, 301, 700]))
        seq = ''.join('ACGT'[x] for x in rng.integers(0, 4, length))
        read = Read('read_%d extra' % i, seq, 'I' * length)
        if albacore:
            read.albacore_barcode_call = albacore[i % len(albacore)]
        reads.append(read)
    return reads


def _run(fn, case, mode, seed):
    make_sets, n, check, two, direction, albacore = CASES[case]
    diff = 0.0 if case.endswith('_diff0') else BARCODE_DIFF
    verbosity, collect = mode
    reads = _reads(n, albacore, seed)
    out = io.StringIO()
    StubJobs.seed = seed
    StubJobs.calls = []
    lines = fn(reads, make_sets(), verbosity, END_SIZE, EXTRA, END_THRESHOLD,
               SCHEME, out, MIN_TRIM, check, BARCODE_THRESHOLD, diff,
               two, direction, collect_dumps=collect)
    return reads, out.getvalue(), lines, StubJobs.calls


def _new(reads, sets, verbosity, end_size, extra, end_threshold, scheme,
         out, min_trim, check, threshold, diff, two, direction,
         collect_dumps):
    return phases.find_adapters_at_read_ends(
        reads, sets, verbosity, end_size, extra, end_threshold, scheme, out,
        min_trim, 1, check, threshold, diff, two, direction,
        collect_dumps=collect_dumps)


def _fields(read):
    """The Read's phase-2 fields, alignments with their set's name, and
    the score dicts as item lists (their key order included)."""
    got = {}
    for f in FIELDS:
        v = getattr(read, f)
        if f.endswith('alignments'):
            v = [(a[0].name,) + tuple(a[1:]) for a in v]
        elif f.endswith('scores'):
            v = list(v.items())
        got[f] = v
    return got


@pytest.mark.parametrize('case', list(CASES))
def test_array_decisions_equal_the_per_pair_loop(case, monkeypatch):
    """Every Read field, the pairs and adapters AlignJobs is handed, the
    text printed at -v 0 to 3 and the dump lines collected at levels 2
    and 3 equal the oracle's, on two seeds of results."""
    monkeypatch.setattr(phases, 'AlignJobs', StubJobs)
    saw_passes = saw_calls = False
    for seed in (11, 2 ** 31 + 7):
        for mode in MODES:
            reads, text, lines, calls = _run(_new, case, mode, seed)
            w_reads, w_text, w_lines, w_calls = _run(oracle_end_trim, case,
                                                     mode, seed)
            assert text == w_text, mode
            assert lines == w_lines, mode
            assert len(calls) == len(w_calls)
            for (win, ads, pairs), (w_win, w_ads, w_pairs) in zip(calls,
                                                                  w_calls):
                assert pairs.dtype == w_pairs.dtype
                assert pairs.shape == w_pairs.shape
                assert pairs.tobytes() == w_pairs.tobytes()
                assert [a.tobytes() for a in ads] == \
                    [a.tobytes() for a in w_ads]
                assert [x.tobytes() for x in win] == \
                    [x.tobytes() for x in w_win]
            for i, (r, w) in enumerate(zip(reads, w_reads)):
                assert _fields(r) == _fields(w), (mode, i)
            saw_passes |= any(r.start_adapter_alignments
                              or r.end_adapter_alignments for r in reads)
            saw_calls |= any(r.barcode_call != 'none' for r in reads)
    assert saw_passes == (case != 'zero_reads')
    assert saw_calls == (case in CALLING)


def test_ties_and_boundaries_occur(monkeypatch):
    """The stubbed results of the 'reverse' case hold what the oracle
    comparison has to meet: equal best scores within a side and across
    the two sides under other names, a best exactly diff above the
    second, and a pass on each threshold's edge that the loop rejects."""
    monkeypatch.setattr(phases, 'AlignJobs', StubJobs)
    reads, _, _, calls = _run(_new, 'reverse', (0, 0), 11)
    assert any(r.best_start_barcode[1] == r.second_best_start_barcode[1]
               for r in reads)
    assert any(r.best_start_barcode[1] == r.best_end_barcode[1]
               and r.best_start_barcode[0] != r.best_end_barcode[0]
               for r in reads)
    assert any(r.best_start_barcode[1]
               == r.second_best_start_barcode[1] + BARCODE_DIFF
               for r in reads)
    res = StubJobs(None, None, calls[0][2], None).run()
    assert (res['partial_pct'] == END_THRESHOLD).any()
    assert (res['read_end_excl'] == END_SIZE).any()
    assert (res['read_end_excl'] - res['read_start'] == MIN_TRIM).any()
    assert (res['read_start'] == 0).any()


def test_counters_on_a_barcoded_run(tmp_path, monkeypatch):
    """On a small barcoded CLI run under PORECHOP_TPU_TIMING, the job's
    endtrim.pairs_decided is the phase's reads x (start + end sets) and
    endtrim.pairs_passed the alignments its reads hold, beside detection's
    planner.product_lanes (tests/test_torch_product.py); the `[spans]`
    summary prints both."""
    path = tmp_path / 'reads.fastq'
    write_fastq(str(path), synth_barcoded(12, 600, seed=9,
                                          barcodes=range(1, 3)))
    seen = []
    real = torch_cli.find_adapters_at_read_ends

    def watched(reads, matching_sets, *args, **kwargs):
        out = real(reads, matching_sets, *args, **kwargs)
        seen.append((len(reads) * sum(bool(m.start_sequence)
                                      + bool(m.end_sequence)
                                      for m in matching_sets),
                     sum(len(r.start_adapter_alignments)
                         + len(r.end_adapter_alignments) for r in reads)))
        return out
    monkeypatch.setattr(torch_cli, 'find_adapters_at_read_ends', watched)
    monkeypatch.setenv('PORECHOP_TPU_TIMING', '1')
    monkeypatch.chdir(tmp_path)
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        torch_cli.main(['-i', str(path), '-b', 'bins', '-t', '2', '-v', '1'],
                       device='cpu')
    (decided, passed), = seen
    (rec,) = spans.last_jobs(1)
    assert decided > 12 * 2 and passed > 0
    assert rec['counts'] == {'endtrim.pairs_decided': decided,
                             'endtrim.pairs_passed': passed,
                             'planner.product_lanes': 12 * sum(
                                 bool(a.start_sequence) + bool(a.end_sequence)
                                 for a in ADAPTERS
                                 if '(full sequence)' not in a.name)}
    head = '[spans] job %d count ' % rec['job']
    lines = err.getvalue().splitlines()
    assert head + 'endtrim.pairs_decided %d' % decided in lines
    assert head + 'endtrim.pairs_passed %d' % passed in lines
