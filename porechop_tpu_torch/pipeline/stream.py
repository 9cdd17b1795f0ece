"""Bounded-memory streaming runner for large inputs (counterpart of
porechop_tpu/pipeline/stream.py).

The reference (and the default path here, mirroring it) loads every read
into memory and runs the three phases over the whole list
(porechop/porechop.py:33-79).  For multi-million-read production inputs
this runner instead:

1. runs adapter-set detection on the --check_reads sample (identical to the
   default path: the sample is the file's head),
2. then streams the remaining records in chunks: end-trim + middle-scan +
   serialize + write, dropping each chunk before loading the next.

Activated with the (hidden) --stream <chunk_size> flag or
PORECHOP_TPU_STREAM=<chunk_size>.  Verbosity 0 and 1 are supported with
byte-identical output to the in-memory path: the v1 text is re-sequenced;
phase-2 progress prints live as chunks finish their phase 2 (phase 3 is
silent inside chunks), while the phase-2 summary, the whole phase-3 block,
and the output section (including the barcode counts table, rebuilt from
accumulated counters) print after the last chunk, in the reference's
order.  Totals for progress come from a cheap record-counting pre-pass.
Verbosity >= 2 needs per-read dumps in input order mid-stream, so the run
takes the in-memory path instead (on the same device).

Each chunk is parsed, computed and written in turn on the calling thread,
so at most one chunk of reads is alive besides the detection sample.  The
JAX package parses ahead in a reader thread; on an H100 host that was no
faster, on plain input nor on gzipped input (PERF.md section 7).
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

from ..utils.fastx import get_compression_type, get_sequence_file_type
from ..utils.text import bold_underline, int_to_str
from .model import Read
from .output import (finish_bins, gzip_command_for, gzip_into,
                     print_output_banner, print_output_done, resolve_format)
from .phases import (find_adapters_at_read_ends,
                     find_adapters_in_read_middles,
                     get_albacore_barcode_from_path, output_progress_line,
                     print_end_trim_close, print_end_trim_header,
                     print_middle_block, trim_counts)


def stream_chunk_size(args) -> int | None:
    """The configured chunk size, or None when streaming doesn't apply.

    At -v >= 2 this is None and the caller runs the in-memory path on the
    same device: the package's rule (the dumps must print in input order),
    not a fallback from the device."""
    raw = getattr(args, 'stream', None) or os.environ.get(
        'PORECHOP_TPU_STREAM')
    if not raw:
        return None
    if args.verbosity > 1 or not (os.path.isfile(args.input)
                                  or os.path.isdir(args.input)):
        return None
    try:
        n = int(raw)
    except (TypeError, ValueError):
        return None
    return n if n > 0 else None


def list_fastqs(directory):
    """Sorted recursive *.fastq/*.fastq.gz search (reference
    porechop.py:241-249); exits when none are found."""
    fastqs = sorted(os.path.join(dir_path, f)
                    for dir_path, _, filenames in os.walk(directory)
                    for f in filenames
                    if f.lower().endswith('.fastq')
                    or f.lower().endswith('.fastq.gz'))
    if not fastqs:
        sys.exit('Error: could not find fastq files in ' + directory)
    return fastqs


def input_read_type(input_) -> str:
    """'FASTA'/'FASTQ' for a file; directories are always FASTQ
    (reference porechop.py:241-283 searches only fastq files)."""
    if os.path.isdir(input_):
        return 'FASTQ'
    return get_sequence_file_type(input_)


def _iter_records(path):
    """Yields (name, seq, quals_or_None) streaming from disk."""
    kind = get_sequence_file_type(path)
    if get_compression_type(path) == 'gz':
        import gzip
        fh = gzip.open(path, 'rt')
    else:
        fh = open(path, 'rt')
    with fh:
        if kind == 'FASTQ':
            while True:
                header = fh.readline()
                if not header:
                    return
                header = header.strip()
                if not header:
                    continue
                seq = fh.readline().strip()
                fh.readline()
                quals = fh.readline().strip()
                yield header[1:], seq, quals
        else:
            name, parts = None, []
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith('>'):
                    if name:
                        yield name, ''.join(parts), None
                    name, parts = line[1:], []
                else:
                    parts.append(line)
            if name:
                yield name, ''.join(parts), None


def count_records(path) -> int:
    """Cheap record-counting pre-pass (for v1 progress totals).  Accepts a
    file or an Albacore-style directory."""
    if os.path.isdir(path):
        return sum(count_records(f) for f in list_fastqs(path))
    return sum(1 for _ in _iter_records(path))


def iter_input_records(input_):
    """Yields raw (name, seq, quals_or_None, albacore_barcode) tuples from
    a file or a directory (sorted file order, per-file Albacore barcode
    tags; reference porechop.py:241-283).  Raw so range-filtered callers
    (the multi-process partition) can skip records without paying Read
    construction (seq.upper() + RNA scan copy the whole sequence)."""
    if os.path.isdir(input_):
        for path in list_fastqs(input_):
            albacore = get_albacore_barcode_from_path(path)
            for name, seq, quals in _iter_records(path):
                yield name, seq, quals, albacore
    else:
        for name, seq, quals in _iter_records(input_):
            yield name, seq, quals, None


def _make_read(name, seq, quals, albacore):
    r = Read(name, seq, quals or '')
    if albacore is not None:
        r.albacore_barcode_call = albacore
    return r


def iter_input_reads(input_, record_range=None):
    """Yields Read objects streaming from a file or a directory; with
    record_range=(lo, hi), only those of records lo to hi - 1."""
    for idx, rec in enumerate(iter_input_records(input_)):
        if record_range is not None:
            if idx < record_range[0]:
                continue            # skipped records stay raw tuples
            if idx >= record_range[1]:
                return
        yield _make_read(*rec)


def collect_check_reads(input_, check_read_count, record_range=None):
    """The --check_reads detection sample: the file head for file input,
    per-file heads for directory input (reference porechop.py:228-283).
    record_range=(lo, hi) materializes only that slice of the sample (the
    multi-process partition); the full sample is still only scanned, never
    held.  Returns (check_reads, n_check_total)."""
    out = []
    if os.path.isdir(input_):
        fastqs = list_fastqs(input_)
        check_per_file = int(round(check_read_count / len(fastqs)))
        idx = 0
        for path in fastqs:
            albacore = get_albacore_barcode_from_path(path)
            for j, (name, seq, quals) in enumerate(_iter_records(path)):
                if j >= check_per_file:
                    break
                if record_range is None or (record_range[0] <= idx
                                            < record_range[1]):
                    out.append(_make_read(name, seq, quals, albacore))
                idx += 1
        return out, idx
    idx = 0
    for name, seq, quals in _iter_records(input_):
        if idx >= check_read_count:
            break
        if record_range is None or record_range[0] <= idx < record_range[1]:
            out.append(Read(name, seq, quals or ''))
        idx += 1
    return out, idx


def print_load_text(input_, print_dest, total=None) -> int:
    """The v1 'Loading reads' block with GLOBAL totals (reference
    porechop.py:224-283 text for file and directory inputs); returns the
    record count."""
    if os.path.isdir(input_):
        print('\n' + bold_underline('Searching for FASTQ files'),
              flush=True, file=print_dest)
        fastqs = list_fastqs(input_)
        if total is None:
            total = 0
            for f in fastqs:
                print(f, flush=True, file=print_dest)
                total += count_records(f)
        else:
            for f in fastqs:
                print(f, flush=True, file=print_dest)
        print('', flush=True, file=print_dest)
    else:
        print('\n' + bold_underline('Loading reads'), flush=True,
              file=print_dest)
        print(input_, flush=True, file=print_dest)
        if total is None:
            total = count_records(input_)
    print(int_to_str(total) + ' reads loaded\n\n', flush=True,
          file=print_dest)
    return total


def run_streaming(args, matching_sets, forward_or_reverse_barcodes,
                  read_type, chunk_size, total_reads=None,
                  record_range=None, device=None):
    """Phases 2+3 + output over chunks; verbosity 0 or 1.  device: where
    the alignments run (default: the card).

    record_range=(lo, hi): process only that record slice (the
    multi-process composition: each rank streams its own block into a part
    sink; the caller re-points args.output/barcode_dir at the part and pins
    args.format to the plain format).  Returns (counts, bins): the
    trim_counts of every read, and {bin: (reads, bases)}.

    One loop reads, computes and writes each chunk in turn.  The JAX
    package overlaps parsing and writing with the compute in a reader and
    a writer thread; on an H100 host that pipeline was slower than this
    loop, and a reader thread alone on gzipped input was no faster
    (PERF.md), since parsing and serializing hold the GIL that the launch
    path needs."""
    check_barcodes = args.barcode_dir is not None
    verbosity = args.verbosity
    dest = args.print_dest
    out_format = resolve_format(args.format, args.output, read_type,
                                args.barcode_dir, args.input)
    gzipped_out = out_format.endswith('.gz') and (
        args.output is not None or args.barcode_dir is not None)
    plain_format = out_format[:-3] if gzipped_out else out_format

    if verbosity > 0 and total_reads is None:
        total_reads = count_records(args.input)

    sinks = {}

    def sink_for(name):
        if name not in sinks:
            if args.barcode_dir is not None:
                if not os.path.isdir(args.barcode_dir):
                    os.makedirs(args.barcode_dir)
                sinks[name] = open(os.path.join(
                    args.barcode_dir, name + '.' + plain_format), 'wt')
            elif args.output is None:
                sinks[name] = sys.stdout
            else:
                sinks[name] = open(args.output + ('.tmp' if gzipped_out
                                                  else ''), 'wt')
        return sinks[name]

    bin_read_counts = defaultdict(int)
    bin_base_counts = defaultdict(int)
    counts = [0] * 5
    done = 0

    if verbosity > 0 and matching_sets:
        print_end_trim_header(matching_sets, dest)
        output_progress_line(0, total_reads, dest)

    def compute_chunk(reads):
        if not matching_sets:
            return
        find_adapters_at_read_ends(
            reads, matching_sets, 0, args.end_size, args.extra_end_trim,
            args.end_threshold, args.scoring_scheme_vals, dest,
            args.min_trim_size, args.threads, check_barcodes,
            args.barcode_threshold, args.barcode_diff,
            args.require_two_barcodes, forward_or_reverse_barcodes,
            device=device)
        if verbosity > 0:
            # Live phase-2 progress over the global index range (every
            # 10th + the final one, like output_progress_line's step).
            for r in range(done + 1, done + len(reads) + 1):
                output_progress_line(r, total_reads, dest)
        if not args.no_split:
            find_adapters_in_read_middles(
                reads, matching_sets, 0, args.middle_threshold,
                args.extra_middle_trim_good_side,
                args.extra_middle_trim_bad_side, args.scoring_scheme_vals,
                dest, args.threads, args.discard_middle, device=device)

    def write_chunk(reads):
        for read in reads:
            if args.barcode_dir is not None:
                name = read.barcode_call
                if args.discard_unassigned and name == 'none':
                    continue
            else:
                name = '__out__'
            if plain_format == 'fasta':
                s = read.get_fasta(args.min_split_read_size,
                                   args.discard_middle, args.untrimmed)
            else:
                s = read.get_fastq(args.min_split_read_size,
                                   args.discard_middle, args.untrimmed)
            if s:
                sink_for(name).write(s)
                bin_read_counts[name] += 1
                if args.untrimmed:
                    bin_base_counts[name] += len(read.seq)
                else:
                    bin_base_counts[name] += (
                        read.seq_length_with_start_end_adapters_trimmed())

    def chunks():
        chunk = []
        for read in iter_input_reads(args.input, record_range):
            chunk.append(read)
            if len(chunk) == chunk_size:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    try:
        for chunk in chunks():
            compute_chunk(chunk)
            write_chunk(chunk)
            counts = [a + b for a, b in zip(counts, trim_counts(chunk))]
            done += len(chunk)
            del chunk                   # before the next one is parsed
    finally:
        for fh in sinks.values():
            if fh is not sys.stdout:
                fh.close()

    # Deferred v1 text: phase-2 close + summary, then the whole phase-3
    # block, in the reference's order (porechop.py:517-604).
    if verbosity > 0 and matching_sets:
        print_end_trim_close(total_reads, counts, dest)
        if not args.no_split:
            print_middle_block(total_reads, counts[4], args.discard_middle,
                               args.threads, dest)
    elif verbosity > 0:
        print('No adapters found - output reads are unchanged from input '
              'reads\n', file=dest)

    # Output section (reference porechop.py:607-704 text order).
    if verbosity > 0:
        print_output_banner(args.untrimmed, args.barcode_dir, args.output,
                            dest)
    gzip_cmd = (gzip_command_for(args.threads, verbosity, dest)
                if gzipped_out else 'gzip')
    bins = {k: (bin_read_counts[k], bin_base_counts[k])
            for k in bin_read_counts}
    if args.barcode_dir is not None:
        finish_bins(bins, args.barcode_dir, plain_format, gzipped_out,
                    gzip_cmd, verbosity, dest)
    else:
        if gzipped_out:
            gzip_into(gzip_cmd, args.output + '.tmp', args.output)
        if verbosity > 0:
            print_output_done(args.output, dest)
    if verbosity > 0:
        print('', flush=True, file=dest)
    return counts, bins
