"""The pipeline phases, re-expressed as dense batched device launches
(counterpart of porechop_tpu/pipeline/phases.py).

The reference runs one FFI alignment call per (read, adapter) pair inside a
thread pool (porechop/porechop.py:286-595).  Here every phase builds one
AlignJobs batch (ops/dispatch.py), launches it on the device, and then
applies the reference's decision logic on the host, over whole result
arrays where it allows (phase 2) and else in the reference's per-read,
per-adapter order, so all outputs (including verbosity text and progress
lines) are byte-identical to a single-threaded reference run.
Every phase takes the `device` its launches run on (default: the card;
a list of device entries splits each launch's lanes, ops/dispatch.py).
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from ..adapters import (ADAPTERS, make_full_native_barcode_adapter,
                        make_new_full_rapid_barcode_adapter,
                        make_old_full_rapid_barcode_adapter)
from ..ops import spec
from ..ops import middle
from ..ops.dispatch import (AlignJobs, Product, score_path_available,
                            seqan_pct_vec, stats_path_active)
from ..ops.kernels import score_prefilter_coef
from ..utils import spans
from ..utils.fastx import load_fasta_or_fastq
from ..utils.text import bold_underline, int_to_str, print_table, red
from .model import Read

END_CODE_N = 4


# ---------------------------------------------------------------------------
# Loading (reference porechop.py:224-283)
# ---------------------------------------------------------------------------

def load_reads(input_file_or_directory, verbosity, print_dest, check_read_count):
    if os.path.isfile(input_file_or_directory):
        if verbosity > 0:
            print('\n' + bold_underline('Loading reads'), flush=True, file=print_dest)
            print(input_file_or_directory, flush=True, file=print_dest)
        records, read_type = load_fasta_or_fastq(input_file_or_directory)
        if read_type == 'FASTA':
            reads = [Read(x[2], x[1], '') for x in records]
        else:
            reads = [Read(x[4], x[1], x[3]) for x in records]
        check_reads = reads[:check_read_count]

    elif os.path.isdir(input_file_or_directory):
        if verbosity > 0:
            print('\n' + bold_underline('Searching for FASTQ files'),
                  flush=True, file=print_dest)
        fastqs = sorted(os.path.join(dir_path, f)
                        for dir_path, _, filenames in os.walk(input_file_or_directory)
                        for f in filenames
                        if f.lower().endswith('.fastq')
                        or f.lower().endswith('.fastq.gz'))
        if not fastqs:
            sys.exit('Error: could not find fastq files in '
                     + input_file_or_directory)
        reads, check_reads = [], []
        read_type = 'FASTQ'
        check_reads_per_file = int(round(check_read_count / len(fastqs)))
        for fastq_file in fastqs:
            if verbosity > 0:
                print(fastq_file, flush=True, file=print_dest)
            records, _ = load_fasta_or_fastq(fastq_file)
            file_reads = [Read(x[4], x[1], x[3]) for x in records]
            albacore_barcode = get_albacore_barcode_from_path(fastq_file)
            for read in file_reads:
                read.albacore_barcode_call = albacore_barcode
            reads += file_reads
            check_reads += file_reads[:check_reads_per_file]
        if verbosity > 0:
            print('', flush=True, file=print_dest)
    else:
        sys.exit('Error: could not find ' + input_file_or_directory)

    if verbosity > 0:
        print(int_to_str(len(reads)) + ' reads loaded\n\n', flush=True,
              file=print_dest)
    return reads, check_reads, read_type


def get_albacore_barcode_from_path(albacore_path):
    if '/unclassified/' in albacore_path:
        return 'none'
    matches = re.findall('/barcode(\\d\\d)/', albacore_path)
    if matches:
        return 'BC' + matches[-1]
    return None


# ---------------------------------------------------------------------------
# Phase 1: adapter-set detection (reference porechop.py:286-327)
# ---------------------------------------------------------------------------

def find_matching_adapter_sets(check_reads, verbosity, end_size,
                               scoring_scheme_vals, print_dest,
                               adapter_threshold, threads, exact_scores=True,
                               device=None, stats_merge=None):
    """stats_merge: optional (gm, gl) -> (gm, gl) hook that merges the
    per-(set, side) best (matches, full_len) stats across processes, the
    multi-process collective (parallel/multihost.py).  Every process must
    call it, with the same adapter database so the entry order matches.

    exact_scores: when False (the caller will never display per-set
    scores and never weighs them against each other), sub-threshold sets
    may report 0.0 instead of their true best identity: a score-only
    prefilter pass rejects whole (set, side) groups via the provable bound
    (ops/kernels.score_prefilter_coef; each group shares one adapter, so
    the bound is one number per group), and only surviving groups run the
    exact stat-carrying pass.  The >= adapter_threshold selection and
    fix_up_1d2_sets read only sets that PASSED the threshold, whose values
    the exact pass computed.  choose_barcoding_kit sums both sides'
    scores, so barcode runs need exact_scores=True."""
    read_count = len(check_reads)
    if verbosity > 0:
        print(bold_underline('Looking for known adapter sets'), flush=True,
              file=print_dest)
        output_progress_line(0, read_count, print_dest)

    search_adapters = [a for a in ADAPTERS if '(full sequence)' not in a.name]
    for a in search_adapters:       # fresh scores per run
        a.best_start_score = 0.0
        a.best_end_score = 0.0

    # One dense batch: every check read's two end windows against every
    # adapter-set start/end sequence, handed to the planner as a product
    # of the two axes (a list of (read x set) pairs costs more host time
    # than the DP itself at --check_reads scale).
    windows = spec.encode_many(
        [s for read in check_reads
         for s in (read.seq[:end_size], read.seq[-end_size:])])
    adapter_seqs = []
    adapter_idx = {}
    entries = []   # (set_idx, side, adapter_idx)
    for si, aset in enumerate(search_adapters):
        for side, seq_pair in (('start', aset.start_sequence),
                               ('end', aset.end_sequence)):
            if not seq_pair:
                continue
            seq = seq_pair[1]
            if seq not in adapter_idx:
                adapter_idx[seq] = len(adapter_seqs)
                adapter_seqs.append(spec.encode(seq))
            entries.append((si, side, adapter_idx[seq]))

    # Progress ticks as launches harvest.  The jobs are the product of
    # the check reads (rows: their two windows) and the entries (columns),
    # read-major, so each launch is a contiguous range of jobs and its
    # harvest completes a prefix of reads: the frontier advances DURING
    # the phase instead of only at its end (VERDICT r4 task 5).  The
    # planner tells it each row's resolved jobs, or on the flat route the
    # job indices (job k belongs to check read k // n_entries).
    prog = HarvestProgress(read_count, len(entries),
                           lambda k: k // max(len(entries), 1), print_dest,
                           enabled=verbosity > 0)
    if entries:
        gm = np.zeros(len(entries), dtype=np.int64)
        gl = np.ones(len(entries), dtype=np.int64)
        if read_count:
            E = len(entries)
            jobs = Product(
                np.arange(2 * read_count, dtype=np.int64).reshape(-1, 2),
                [0 if side == 'start' else 1 for _, side, _ in entries],
                [ai for _, _, ai in entries], np.arange(E))
            # Group-reduced execution: per (set, side) only the best identity
            # leaves the device — the per-pair results are never materialized
            # host-side (reference semantics: max over check reads of the
            # full adapter %id, nanopore_read.py:155-164).
            coef = score_prefilter_coef(adapter_threshold,
                                        *scoring_scheme_vals)
            if (not exact_scores and coef > 0
                    and score_path_available(scoring_scheme_vals)):
                # Prefilter pass: per-group max SCORE via the score-only
                # kernels (~2x the stat-carrying pass); a group whose best
                # score is below coef * its adapter length provably has
                # best identity below the threshold.  Survivors (typically
                # the 2-10 truly-present sets) re-run exactly.
                gsc = AlignJobs(windows, adapter_seqs, jobs,
                                scoring_scheme_vals,
                                device=device).run_group_score_max(
                                    None, E, progress=prog)
                alens_e = np.array([len(adapter_seqs[ai])
                                    for _, _, ai in entries], np.int64)
                surv = gsc.astype(np.float64) >= coef * alens_e
                if surv.any():
                    res = AlignJobs(windows, adapter_seqs,
                                    jobs.columns(surv), scoring_scheme_vals,
                                    device=device).run_group_max(None, E)
                    gm, gl = res['matches'], res['full_len']
            else:
                res = AlignJobs(windows, adapter_seqs, jobs,
                                scoring_scheme_vals,
                                device=device).run_group_max(
                                    None, E, progress=prog)
                gm, gl = res['matches'], res['full_len']
        if stats_merge is not None:
            gm, gl = stats_merge(gm, gl)
        best = seqan_pct_vec(gm, np.maximum(gl, 1))
        for e, (si, side, ai) in enumerate(entries):
            aset = search_adapters[si]
            if side == 'start':
                aset.best_start_score = max(aset.best_start_score, best[e])
            else:
                aset.best_end_score = max(aset.best_end_score, best[e])

    prog.finish()

    return [x for x in search_adapters
            if x.best_start_or_end_score() >= adapter_threshold]


def print_detection_block(n_check, print_dest):
    """The -v 1 text of phase 1 for n_check reads, printed after the fact
    (reference porechop.py:286-327): header and progress."""
    print(bold_underline('Looking for known adapter sets'), flush=True,
          file=print_dest)
    for r in range(n_check + 1):
        output_progress_line(r, n_check, print_dest)
    output_progress_line(n_check, n_check, print_dest, end_newline=True)


# ---------------------------------------------------------------------------
# Host-side set surgery (reference porechop.py:330-435)
# ---------------------------------------------------------------------------

def choose_barcoding_kit(adapter_sets, verbosity, print_dest):
    forward_start_or_end, reverse_start_or_end = 0, 0
    forward_start_and_end, reverse_start_and_end = 0, 0
    for aset in adapter_sets:
        if 'barcode' in aset.name.lower():
            if '(forward)' in aset.name.lower():
                forward_start_or_end += aset.best_start_or_end_score()
                forward_start_and_end += aset.best_start_score + aset.best_end_score
            elif '(reverse)' in aset.name.lower():
                reverse_start_or_end += aset.best_start_or_end_score()
                reverse_start_and_end += aset.best_start_score + aset.best_end_score
    if forward_start_or_end == 0 and reverse_start_or_end == 0:
        sys.exit('Error: no barcodes were found, so Porechop cannot perform '
                 'barcode demultiplexing')
    orientation = None
    if forward_start_or_end > reverse_start_or_end:
        orientation = 'forward'
    elif reverse_start_or_end > forward_start_or_end:
        orientation = 'reverse'
    elif forward_start_and_end > reverse_start_and_end:
        orientation = 'forward'
    elif reverse_start_and_end > forward_start_and_end:
        orientation = 'reverse'
    if orientation is None:
        sys.exit('Error: Porechop could not determine barcode orientation')
    if verbosity > 0:
        print('\nBarcodes determined to be in ' + orientation + ' orientation',
              file=print_dest)
    return orientation


def fix_up_1d2_sets(matching_sets):
    names = [x.name for x in matching_sets]
    if ('1D^2 part 1' in names and '1D^2 part 2' in names
            and 'SQK-MAP006 Short' in names):
        def score_of(n):
            return [x for x in matching_sets
                    if x.name == n][0].best_start_or_end_score()
        if (score_of('1D^2 part 1') >= score_of('SQK-MAP006 Short')
                and score_of('1D^2 part 2') >= score_of('SQK-MAP006 Short')):
            matching_sets = [x for x in matching_sets
                             if x.name != 'SQK-MAP006 Short']
    return matching_sets


def display_adapter_set_results(matching_sets, verbosity, print_dest):
    if verbosity < 1:
        return
    table = [['Set', 'Best read start %ID', 'Best read end %ID']]
    row_colours = {}
    matching_set_names = [x.name for x in matching_sets]
    search_adapters = [a for a in ADAPTERS if '(full sequence)' not in a.name]
    for aset in search_adapters:
        table.append([aset.name, '%.1f' % aset.best_start_score,
                      '%.1f' % aset.best_end_score])
        if aset.name in matching_set_names:
            row_colours[len(table) - 1] = 'green'
    print_table(table, print_dest, alignments='LRR', row_colour=row_colours,
                fixed_col_widths=[35, 8, 8])


def add_full_barcode_adapter_sets(matching_sets):
    names = [x.name for x in matching_sets]
    for i in range(1, 97):
        if all(x in names for x in ['SQK-NSK007',
                                    'Barcode ' + str(i) + ' (reverse)']):
            matching_sets.append(make_full_native_barcode_adapter(i))
        if all(x in names for x in ['Rapid', 'Barcode ' + str(i) + ' (forward)']):
            if 'RBK004_upstream' in names:
                matching_sets.append(make_new_full_rapid_barcode_adapter(i))
            elif 'SQK-NSK007' in names:
                matching_sets.append(make_old_full_rapid_barcode_adapter(i))
    return matching_sets


# ---------------------------------------------------------------------------
# Phase 2: end trimming + barcode scoring (reference porechop.py:438-514,
# nanopore_read.py:166-208)
# ---------------------------------------------------------------------------

def find_adapters_at_read_ends(reads, matching_sets, verbosity, end_size,
                               extra_trim_size, end_threshold,
                               scoring_scheme_vals, print_dest, min_trim_size,
                               threads, check_barcodes, barcode_threshold,
                               barcode_diff, require_two_barcodes,
                               forward_or_reverse_barcodes, device=None,
                               collect_dumps=0):
    """collect_dumps > 0 (with verbosity 0): build and RETURN the per-read
    v2/v3 dump lines at that level without printing anything; the
    multi-process runtime gathers each rank's lines and re-emits them in
    global read order (parallel/multihost.py)."""
    if verbosity > 0:
        print_end_trim_header(matching_sets, print_dest)

    read_count = len(reads)
    if verbosity == 1:
        output_progress_line(0, read_count, print_dest)

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

    # Pairs read-major, each read's start sets in order, then its end
    # sets; the per-set constants are worked out once a call.
    n_start = len(start_sets)
    jobs_per_read = n_start + len(end_sets)
    sets = start_sets + end_sets
    set_ai = np.array([aidx(m.start_sequence[1]) for m in start_sets]
                      + [aidx(m.end_sequence[1]) for m in end_sets],
                      dtype=np.int64)
    pairs = np.empty((read_count * jobs_per_read, 2), dtype=np.int64)
    pairs[:, 0] = (2 * np.repeat(np.arange(read_count, dtype=np.int64),
                                 jobs_per_read)
                   + np.tile(np.arange(jobs_per_read) >= n_start, read_count))
    pairs[:, 1] = np.tile(set_ai, read_count)
    # Progress ticks as chunks harvest (job k belongs to read
    # k // jobs_per_read).
    prog = HarvestProgress(read_count, jobs_per_read,
                           lambda k: k // jobs_per_read, print_dest,
                           enabled=verbosity == 1)
    res = AlignJobs(windows, adapter_seqs, pairs, scoring_scheme_vals,
                    device=device).run(progress=prog) if len(pairs) else None

    # The decisions (nanopore_read.py:166-208) over the (reads, sets)
    # result matrices; per-read Python work only for the pairs that pass.
    n_passed = 0
    if res is not None:
        shape = (read_count, jobs_per_read)
        full = res['full_pct'].reshape(shape)
        partial = res['partial_pct'].reshape(shape)
        read_start = res['read_start'].reshape(shape)
        read_end = res['read_end_excl'].reshape(shape)
        on_start = np.arange(jobs_per_read) < n_start
        passed = ((partial > end_threshold)
                  & np.where(on_start, read_end != end_size, read_start != 0)
                  & (read_end - read_start >= min_trim_size))
        trim = np.where(on_start, read_end,
                        end_size - read_start) + extra_trim_size
        rows, cols = np.nonzero(passed)
        n_passed = len(rows)
        for r, j, f, p, s, e, t in zip(
                rows.tolist(), cols.tolist(), full[rows, cols].tolist(),
                partial[rows, cols].tolist(),
                read_start[rows, cols].tolist(),
                read_end[rows, cols].tolist(), trim[rows, cols].tolist()):
            read = reads[r]
            if j < n_start:
                read.start_trim_amount = max(read.start_trim_amount, t)
                read.start_adapter_alignments.append((sets[j], f, p, s, e))
            else:
                read.end_trim_amount = max(read.end_trim_amount, t)
                read.end_adapter_alignments.append((sets[j], f, p, s, e))
        if check_barcodes:
            call_barcodes(reads, full, sets, n_start,
                          forward_or_reverse_barcodes, barcode_threshold,
                          barcode_diff, require_two_barcodes)
    spans.count('endtrim.pairs_decided', len(pairs))
    spans.count('endtrim.pairs_passed', n_passed)

    per_read_lines = []
    dump_level = verbosity if verbosity > 1 else collect_dumps
    if dump_level == 2:
        per_read_lines = [read.formatted_start_and_end_seq(
            end_size, extra_trim_size, check_barcodes) for read in reads]
    elif dump_level > 2:
        per_read_lines = [read.full_start_end_output(
            end_size, extra_trim_size, check_barcodes) for read in reads]

    if verbosity == 1:
        prog.finish()
    elif verbosity > 1:
        for line in per_read_lines:
            print(line, file=print_dest)
    if verbosity > 0:
        print('', file=print_dest)
    return per_read_lines


def call_barcodes(reads, full, sets, n_start, direction, threshold, diff,
                  require_two):
    """Each read's barcode scores, best and second-best barcode at each
    end, and call (nanopore_read.py:166-208, 399-473), from the full %id
    matrix (reads x sets, the first n_start columns the start sets').

    A side's scores are the dict the reference fills set by set: a name's
    first set places it, its last one scores it.  Every order is a stable
    descending sort of the columns, start columns before end columns, as
    the reference's sorted(..., reverse=True) over the dicts leaves ties.
    Without require_two the call weighs the first entry of the order over
    both ends against the first after it under another name."""
    s_names, s_cols = _score_columns(sets[:n_start], 0, direction)
    e_names, e_cols = _score_columns(sets[n_start:], n_start, direction)
    ns = len(s_names)
    n = ns + len(e_names)
    R = len(reads)
    rows = np.arange(R)
    # Column n, ('none', 0.0), stands in for an absent entry.
    names = s_names + e_names + ['none']
    scores = np.concatenate([full[:, s_cols + e_cols], np.zeros((R, 1))],
                            axis=1)
    ids_of = {}
    ids = np.array([ids_of.setdefault(x, len(ids_of)) for x in names])

    def ranked(lo, hi):
        """Columns lo..hi-1 of each row in a stable descending order,
        then column n twice."""
        order = lo + np.argsort(-scores[:, lo:hi], axis=1, kind='stable')
        return np.concatenate([order, np.full((R, 2), n)], axis=1)

    # Each end's best and second-best columns.
    top = np.concatenate([ranked(0, ns)[:, :2], ranked(ns, n)[:, :2]],
                         axis=1)
    top_scores = scores[rows[:, None], top]
    if require_two:
        v = top_scores.T
        best = top[:, 0]
        ok = ((v[0] >= threshold) & (v[2] >= threshold)
              & (v[0] >= v[1] + diff) & (v[2] >= v[3] + diff)
              & (ids[best] == ids[top[:, 2]]))
    else:
        order = ranked(0, n)
        other = ids[order] != ids[order[:, :1]]
        best = order[:, 0]
        second = order[rows, other.argmax(axis=1)]
        ok = ((scores[rows, best] >= threshold)
              & (scores[rows, best] >= scores[rows, second] + diff))
    for read, s_row, e_row, t, v, b, k in zip(
            reads, scores[:, :ns].tolist(), scores[:, ns:n].tolist(),
            top.tolist(), top_scores.tolist(), best.tolist(), ok.tolist()):
        read.start_barcode_scores = dict(zip(s_names, s_row))
        read.end_barcode_scores = dict(zip(e_names, e_row))
        read.best_start_barcode = (names[t[0]], v[0])
        read.second_best_start_barcode = (names[t[1]], v[1])
        read.best_end_barcode = (names[t[2]], v[2])
        read.second_best_end_barcode = (names[t[3]], v[3])
        call = names[b] if k else 'none'
        # Albacore-agreement veto (nanopore_read.py:471-473).
        if (read.albacore_barcode_call is not None
                and call != read.albacore_barcode_call):
            call = 'none'
        read.barcode_call = call


def _score_columns(sets, offset, direction):
    """The names a side's barcode-score dict holds, in insertion order,
    and the column of the last set that writes each."""
    col = {}
    for j, m in enumerate(sets):
        if m.is_barcode() and m.barcode_direction() == direction:
            col[m.get_barcode_name()] = offset + j
    return list(col), list(col.values())


def print_end_trim_header(matching_sets, print_dest):
    """The phase-2 banner + red adapter list (porechop.py:441-457 era
    text)."""
    print(bold_underline('Trimming adapters from read ends'),
          file=print_dest)
    name_len = max(max(len(x.start_sequence[0])
                       if x.start_sequence else 0 for x in matching_sets),
                   max(len(x.end_sequence[0])
                       if x.end_sequence else 0 for x in matching_sets))
    for mset in matching_sets:
        if mset.start_sequence:
            print('  ' + mset.start_sequence[0].rjust(name_len) + ': '
                  + red(mset.start_sequence[1]), file=print_dest)
        if mset.end_sequence:
            print('  ' + mset.end_sequence[0].rjust(name_len) + ': '
                  + red(mset.end_sequence[1]), file=print_dest)
    print('', file=print_dest)


def display_read_end_trimming_summary(reads, verbosity, print_dest):
    if verbosity < 1:
        return
    start_trim_total = sum(x.start_trim_amount for x in reads)
    start_trim_count = sum(1 if x.start_trim_amount else 0 for x in reads)
    end_trim_count = sum(1 if x.end_trim_amount else 0 for x in reads)
    end_trim_total = sum(x.end_trim_amount for x in reads)
    end_trim_summary_counts(len(reads), start_trim_count, start_trim_total,
                            end_trim_count, end_trim_total, print_dest)


def end_trim_summary_counts(n_reads, start_count, start_total, end_count,
                            end_total, print_dest):
    """The counts lines of display_read_end_trimming_summary."""
    print(int_to_str(start_count).rjust(len(int_to_str(n_reads)))
          + ' / ' + int_to_str(n_reads)
          + ' reads had adapters trimmed from their start ('
          + int_to_str(start_total) + ' bp removed)', file=print_dest)
    print(int_to_str(end_count).rjust(len(int_to_str(n_reads)))
          + ' / ' + int_to_str(n_reads)
          + ' reads had adapters trimmed from their end ('
          + int_to_str(end_total) + ' bp removed)', file=print_dest)
    print('\n', file=print_dest)


def trim_counts(reads):
    """The counters that the phase-2 and phase-3 summaries print: reads
    trimmed at the start and their bp, the same at the end, and reads with
    middle adapters."""
    return [sum(1 for x in reads if x.start_trim_amount),
            sum(x.start_trim_amount for x in reads),
            sum(1 for x in reads if x.end_trim_amount),
            sum(x.end_trim_amount for x in reads),
            sum(1 for x in reads if x.middle_adapter_ranges)]


def print_end_trim_block(matching_sets, n_reads, counts, print_dest):
    """The -v 1 text of phase 2 over n_reads reads, printed after the fact
    from trim_counts (reference porechop.py:438-530): header, progress and
    summary."""
    print_end_trim_header(matching_sets, print_dest)
    for r in range(n_reads + 1):
        output_progress_line(r, n_reads, print_dest)
    print_end_trim_close(n_reads, counts, print_dest)


def print_end_trim_close(n_reads, counts, print_dest):
    """The end of phase 2's -v 1 text: the last progress line and the
    summary."""
    output_progress_line(n_reads, n_reads, print_dest, end_newline=True)
    print('', file=print_dest)
    end_trim_summary_counts(n_reads, *counts[:4], print_dest)


# ---------------------------------------------------------------------------
# Phase 3: middle adapters (reference porechop.py:533-595,
# nanopore_read.py:210-243)
# ---------------------------------------------------------------------------

def find_adapters_in_read_middles(reads, matching_sets, verbosity,
                                  middle_threshold, extra_trim_good_side,
                                  extra_trim_bad_side, scoring_scheme_vals,
                                  print_dest, threads, discard_middle,
                                  device=None, collect_dumps=0):
    """collect_dumps: see find_adapters_at_read_ends."""
    if verbosity > 0:
        verb = 'Discarding' if discard_middle else 'Splitting'
        print(bold_underline(verb + ' reads containing middle adapters'),
              file=print_dest)

    adapters = []
    for mset in matching_sets:
        if mset.start_sequence:
            adapters.append(mset.start_sequence)
        if mset.end_sequence:
            if (not mset.start_sequence
                    or mset.end_sequence[1] != mset.start_sequence[1]):
                adapters.append(mset.end_sequence)

    start_sequence_names = set()
    end_sequence_names = set()
    for mset in matching_sets:
        if mset.start_sequence:
            start_sequence_names.add(mset.start_sequence[0])
        if mset.end_sequence:
            end_sequence_names.add(mset.end_sequence[0])

    read_count = len(reads)
    if verbosity == 1:
        output_progress_line(0, read_count, print_dest)

    # Mutable masked code arrays (mask char '-' is Dna5 'N' = code 4;
    # encode_many's views are disjoint and writable, so in-place masking
    # is safe).
    masked = spec.encode_many(
        [r.get_seq_with_start_end_adapters_trimmed() for r in reads])
    a_code_list = [spec.encode(seq) for _, seq in adapters]

    # Round 0: ONE dense launch of every (read, adapter) pair against the
    # still-unmasked sequences.  The reference masks hits of earlier
    # adapters before aligning later ones (nanopore_read.py:216-243), but
    # for a read with NO hit from ANY adapter no masking ever happens, so
    # every one of its reference alignments sees exactly this input — those
    # reads (the overwhelming majority) are finished after this launch.
    n_ad = len(adapters)
    round0 = None
    # Progress ticks as round-0 chunks harvest.  Pairs are READ-major (job
    # k belongs to read k // n_ad): one read's jobs share a window rung, so
    # the dispatcher's stable bucketing keeps same-length-bucket chunks as
    # contiguous read runs and harvested chunks complete read prefixes —
    # the frontier can advance during the phase (VERDICT r4 task 5).
    # Reads still replaying when round 0 ends get their lines from
    # prog.finish().  The reference's threaded loop prints
    # finished_count + 1 (porechop.py:589, an off-by-one its single-thread
    # path lacks); reproduce whichever pattern the requested thread count
    # selects.
    prog = HarvestProgress(
        read_count, n_ad, lambda k: k // max(n_ad, 1), print_dest,
        enabled=verbosity == 1,
        line_of=(lambda r: r) if threads == 1 else (lambda r: r + 1))
    stats_only = stats_path_active(scoring_scheme_vals,
                                   prefilter=middle_threshold)
    if n_ad and read_count:
        pairs0 = np.column_stack([
            np.repeat(np.arange(read_count, dtype=np.int64), n_ad),
            np.tile(np.arange(n_ad, dtype=np.int64), read_count)])
        jobs0 = AlignJobs(masked, a_code_list, pairs0, scoring_scheme_vals,
                          device=device)
        if stats_only:
            # Winner-only coordinate recovery (VERDICT r3 task 2's idea
            # applied to the middle phase): the dense pass prices every
            # pair's full_score with the bitless stat-carrying kernel — no
            # trace-bitmap HBM write (~1 byte/cell, gigabytes at 8k-read
            # scale), no traceback walk.  Coordinates are recomputed below
            # for each hit read's FIRST hit only — the sole round-0
            # coordinates the replay ever consumes (the reference masks
            # that hit and realigns everything after it on the masked
            # read, nanopore_read.py:221-243).
            #
            # prefilter: this caller only consumes full_pct >= threshold
            # (and passing lanes' values), so the dense pass may run the
            # score-only kernel and certify sub-threshold lanes from a
            # provable score bound (dispatch.run_stats /
            # kernels.score_prefilter_coef) — the exact stats re-run covers
            # only the surviving lanes.
            round0 = jobs0.run_stats(progress=prog,
                                     prefilter=middle_threshold)
        else:
            round0 = jobs0.run(progress=prog)
        fp0 = round0['full_pct'].reshape(read_count, n_ad)
        hit_any = (fp0 >= middle_threshold).any(axis=1)
        fallback = [ri for ri in range(read_count) if hit_any[ri]]
    else:
        fallback = []

    # Reads with >= 1 hit replay the reference's exact per-read
    # adapter-by-adapter, mask-and-retry order (nanopore_read.py:216-243).
    # Reads are independent, so the replay is a per-read state machine
    # (current adapter index + masked sequence) advanced in GLOBAL rounds:
    # every pending (read, adapter) alignment across all reads and all
    # adapters batches into one launch per round, so the launch count is
    # the longest single read's chain (adapters + hits), not the sum of
    # per-adapter iteration counts.
    #
    # Round-0 results stand in until a read's first mask: per read, scan
    # adapters in order against round0 (computed on the unmasked sequence —
    # exactly what the reference would align) until the first hit; apply
    # that hit, then everything after runs on freshly masked sequences.
    def apply_hit(ri, ai, read_start, read_end, full_score):
        masked[ri][read_start:read_end] = END_CODE_N
        reads[ri].add_middle_hit(adapters[ai][0], read_start, read_end,
                                 full_score, extra_trim_good_side,
                                 extra_trim_bad_side, start_sequence_names,
                                 end_sequence_names)

    # Each fallback read's FIRST hit adapter (scanning in reference order
    # against the round-0 full scores — all computed on the unmasked
    # sequence, exactly what the reference would align first).
    first_ai = {}
    for ri in fallback:
        for ai in range(n_ad):
            if fp0[ri, ai] >= middle_threshold:
                first_ai[ri] = ai
                break
    if stats_only and first_ai:
        # Coordinate pass for the hits only: one small launch (typically
        # ~the chimera rate x read_count jobs) through the full engine.
        items = sorted(first_ai.items())
        cres = AlignJobs([masked[ri] for ri, _ in items], a_code_list,
                         np.column_stack([
                             np.arange(len(items), dtype=np.int64),
                             np.array([ai for _, ai in items], np.int64)]),
                         scoring_scheme_vals, device=device).run()
        coords = {ri: (int(cres['read_start'][n]),
                       int(cres['read_end_excl'][n]))
                  for n, (ri, _) in enumerate(items)}
    else:
        coords = {ri: (int(round0['read_start'][ri * n_ad + ai]),
                       int(round0['read_end_excl'][ri * n_ad + ai]))
                  for ri, ai in first_ai.items()}

    pend = []   # (ri, ai): the next alignment each in-flight read needs
    for ri in fallback:
        ai = first_ai[ri]
        rs, re = coords[ri]
        apply_hit(ri, ai, rs, re, fp0[ri, ai])
        pend.append((ri, ai))           # re-align same adapter, now masked

    # The device replay takes every replay set under a scheme the kernels
    # take, unless the run is forced to the host; the rest replays in host
    # rounds.  Both take each round's decisions from middle.replay_step.
    use_device_replay = bool(pend) and middle.replays_on_device(
        scoring_scheme_vals)
    while pend and not use_device_replay:
        # Host rounds (porechop_tpu/pipeline/phases.py:651-666): each round
        # aligns every in-flight read's next job through AlignJobs's host
        # route.
        lane_ai = np.array([ai for _, ai in pend], np.int64)
        res = AlignJobs([masked[ri] for ri, _ in pend], a_code_list,
                        np.column_stack([
                            np.arange(len(pend), dtype=np.int64), lane_ai]),
                        scoring_scheme_vals, device=device).run()
        hit, nxt, live = middle.replay_step(res['full_pct'], lane_ai,
                                            middle_threshold, n_ad)
        for n in np.nonzero(hit)[0]:
            apply_hit(pend[n][0], int(lane_ai[n]), int(res['read_start'][n]),
                      int(res['read_end_excl'][n]), res['full_pct'][n])
        pend = [(pend[n][0], int(nxt[n])) for n in np.nonzero(live)[0]]

    if pend:
        # Device-resident replay (ops/middle.py): the replay set's masked
        # reads upload ONCE; every round ships only (lane, adapter row,
        # mask scalars) down and the 7-tuple fields back.  apply_hit's
        # mask of the host copy is not read again: the runner masks its
        # own on the device (ms, me).
        runner = middle.ReplayRunner([masked[ri] for ri, _ in pend],
                                     a_code_list, scoring_scheme_vals,
                                     device=device)
        lane_ri = [ri for ri, _ in pend]
        lane_ai = np.array([ai for _, ai in pend], np.int32)
        active = np.ones(len(pend), bool)
        ms = np.zeros(len(pend), np.int32)   # round-0 hit already masked
        me = np.zeros(len(pend), np.int32)
        while active.any():
            a_idx = np.where(active, lane_ai, runner.dummy_row())
            res = runner.round(a_idx.astype(np.int32), ms, me)
            ms[:] = 0
            me[:] = 0
            lanes = np.nonzero(active)[0]
            hit, nxt, live = middle.replay_step(res['full_pct'][lanes],
                                                lane_ai[lanes],
                                                middle_threshold, n_ad)
            for n in lanes[hit]:
                ms[n] = int(res['read_start'][n])
                me[n] = int(res['read_end_excl'][n])
                apply_hit(lane_ri[n], int(lane_ai[n]), int(ms[n]),
                          int(me[n]), res['full_pct'][n])
            lane_ai[lanes] = nxt
            active[lanes] = live

    if verbosity == 1:
        prog.finish()
        print('', flush=True, file=print_dest)
    dump_level = verbosity if verbosity > 1 else collect_dumps
    dump_lines = []
    if dump_level > 1:
        for read in reads:
            if read.middle_adapter_ranges:
                dump_lines.append(read.middle_adapter_results(dump_level))
    if verbosity > 1:
        for line in dump_lines:
            print(line, file=print_dest, flush=True)
    return dump_lines


def display_read_middle_trimming_summary(reads, discard_middle, verbosity,
                                         print_dest):
    if verbosity < 1:
        return
    middle_trim_count = sum(1 if x.middle_adapter_ranges else 0 for x in reads)
    middle_summary_counts(middle_trim_count, len(reads), discard_middle,
                          print_dest)


def middle_summary_counts(middle_trim_count, n_reads, discard_middle,
                          print_dest):
    verb = 'discarded' if discard_middle else 'split'
    print(int_to_str(middle_trim_count) + ' / ' + int_to_str(n_reads)
          + ' reads were ' + verb + ' based on middle adapters\n\n',
          file=print_dest)


def print_middle_block(n_reads, middle_count, discard_middle, threads,
                       print_dest):
    """The -v 1 text of phase 3 over n_reads reads, printed after the fact
    (reference porechop.py:533-604, with the threaded progress
    off-by-one): banner, progress and summary."""
    verb = 'Discarding' if discard_middle else 'Splitting'
    print(bold_underline(verb + ' reads containing middle adapters'),
          file=print_dest)
    output_progress_line(0, n_reads, print_dest)
    for r in range(1, n_reads + 1):
        output_progress_line(r if threads == 1 else r + 1, n_reads,
                             print_dest)
    output_progress_line(n_reads, n_reads, print_dest, end_newline=True)
    print('', flush=True, file=print_dest)
    middle_summary_counts(middle_count, n_reads, discard_middle, print_dest)


# ---------------------------------------------------------------------------
# Progress line (reference porechop.py:737-748)
# ---------------------------------------------------------------------------

class HarvestProgress:
    """Emits the reference's per-read progress lines WHILE a batched phase
    computes (reference porechop.py:737-748 ticks every 10 reads), instead
    of replaying them all after the launch finishes (VERDICT r3 weak #5:
    a terminal showed nothing for the whole phase wall time).

    The dispatcher calls it with resolved job indices as chunks harvest;
    `read_of` maps a job index to its read index.  A product of jobs
    (ops/dispatch.Product, whose rows are the reads) calls it with read
    indices and how many of each read's jobs resolved.  A read's line
    prints once every one of its jobs has resolved AND every earlier
    read's lines have printed — lines are only ever emitted in increasing
    read order, so the captured byte stream is identical to the post-hoc
    replay (and to the reference's)."""

    def __init__(self, read_count, jobs_per_read, read_of, print_dest,
                 enabled=True, line_of=None):
        self.enabled = enabled
        self.read_count = read_count
        self.read_of = read_of
        self.print_dest = print_dest
        self.line_of = line_of or (lambda r: r)
        if self.enabled:
            self.remaining = np.full(read_count, jobs_per_read, np.int64)
            self.frontier = 0        # reads whose lines have printed

    def __call__(self, idxs, counts=None):
        if not self.enabled or len(idxs) == 0:
            return
        if counts is None:
            r = self.read_of(np.asarray(idxs, dtype=np.int64))
            np.add.at(self.remaining, r, -1)
        else:
            self.remaining[idxs] -= counts
        f = self.frontier
        while f < self.read_count and self.remaining[f] <= 0:
            f += 1
        for k in range(self.frontier + 1, f + 1):
            output_progress_line(self.line_of(k), self.read_count,
                                 self.print_dest)
        self.frontier = f

    def finish(self):
        """Prints any lines still outstanding plus the reference's final
        100% line with its newline."""
        if not self.enabled:
            return
        for k in range(self.frontier + 1, self.read_count + 1):
            output_progress_line(self.line_of(k), self.read_count,
                                 self.print_dest)
        self.frontier = self.read_count
        output_progress_line(self.read_count, self.read_count,
                             self.print_dest, end_newline=True)


def output_progress_line(completed, total, print_dest, end_newline=False,
                         step=10):
    if step > 1 and completed % step != 0 and completed != total:
        return
    progress_str = int_to_str(completed) + ' / ' + int_to_str(total)
    percent = 100.0 * completed / total if total > 0 else 0.0
    progress_str += ' (' + '%.1f' % percent + '%)'
    end_char = '\n' if end_newline else ''
    print('\r' + progress_str, end=end_char, flush=True, file=print_dest)
