"""Command-line interface (counterpart of porechop_tpu/cli.py).

Flags, defaults, validation rules, help semantics and output routing mirror
the reference CLI exactly (porechop/porechop.py:33-221); the compute behind
them runs on batched device launches instead of a host thread pool.  The
--threads flag is accepted for compatibility; it controls output compression
(pigz) parallelism, while alignment parallelism comes from batching.

The alignments of the schemes the kernels take run on the CUDA cards
unless the caller names other devices: main(argv, device=...) or the
hidden --device flag, each a device or a list of device entries whose
shares of every launch's lanes split over them ('cuda:0,cuda:1',
'cpu,cpu'; ops/dispatch.py).  With none named, a single process takes
every local card (parallel/mesh.local_devices) and a multi-process run
(parallel/multihost.py) gives each rank the card cuda:(rank % cards).
Other schemes, and launches too small to pay for a card, run on the host
(ops/dispatch.py); under PORECHOP_TPU_FORCE_HOST=1 every alignment does,
and no card is looked for.

Instruments, read when main runs (the JAX package's switches):
PORECHOP_TPU_TIMING=1 prints the phase walls on stderr (`[timing] phase
<label> <s>`: load, detect, endtrim, middle, output; a --stream run
prints the five summed over its chunks after its last one), and the
planner its own `[timing]` lines.  It also turns on the in-program
recorder (utils/spans.py) for the call: the phases as spans, the
planner's host work, copies, launches and waits on the card as spans
nested in them, a record of every kernel launch with the cells its lanes
need, and the resident set size at each phase's end; at the call's end
(also a failed one) one record joins the buffer that
utils.spans.last_jobs(n) reads, and stderr gets `[spans] job <id> ...`
lines: its wall, each phase (with the RSS), each span name's self time
and count, and its launches and cells.  PORECHOP_TPU_PROFILE=<dir> runs
the pipeline under torch.profiler and writes one Chrome trace JSON into
<dir> (with the switch above, the spans as ranges in it);
PORECHOP_TPU_LOAD_STATS=<path> makes each rank of a multi-process run
write what it parsed (parallel/multihost.py).  main also applies the
allocator tuning (utils/malloc_tune.py; PORECHOP_TPU_NO_MALLOC_TUNE=1
opts out).
"""

import argparse
import copy
import multiprocessing
import os
import sys
import time

from .ops.dispatch import force_host, resolve_devices, timing
from .parallel import mesh, multihost
from .pipeline import stream as stream_mod
from .pipeline.output import output_reads
from .pipeline.phases import (add_full_barcode_adapter_sets,
                              choose_barcoding_kit,
                              display_adapter_set_results,
                              display_read_end_trimming_summary,
                              display_read_middle_trimming_summary,
                              end_trim_summary_counts,
                              find_adapters_at_read_ends,
                              find_adapters_in_read_middles,
                              find_matching_adapter_sets, fix_up_1d2_sets,
                              load_reads, middle_summary_counts,
                              print_detection_block, print_end_trim_block,
                              print_end_trim_header, print_middle_block,
                              trim_counts)
from .utils import malloc_tune, spans
from .utils.text import TrimmerHelpFormatter, bold_underline
from .version import __version__


def main(argv=None, device=None):
    """Runs the trimmer.  device: where the alignments run (a torch device,
    its name, or a list of device entries, as a list or comma-separated);
    default the --device flag, else the local CUDA cards."""
    malloc_tune.configure()
    spans.begin_job(timing())
    ok = False
    try:
        args = get_arguments(argv)
        profile_dir = os.environ.get('PORECHOP_TPU_PROFILE')
        prof = _start_profile() if profile_dir else None
        try:
            _run_pipeline(args, device if device is not None
                          else args.device)
        finally:
            if prof is not None:
                _write_profile(prof, profile_dir)
        multihost.finish()
        ok = True
    finally:
        spans.end_job(ok)


def _start_profile():
    """A started torch.profiler session: host activity, and the cards'
    unless every job runs on the host."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if not force_host() and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _write_profile(prof, profile_dir):
    """Stops the session and writes its Chrome trace into profile_dir,
    named by process and time so that ranks and runs do not collide."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, 'trace.%d.%d.json' % (os.getpid(), time.time_ns())))


def _mark(label, seconds):
    """The PORECHOP_TPU_TIMING phase-wall line (porechop_tpu/cli.py
    _mark), the exporter of the phase spans.  Each phase ends with its
    results on the host already, so none needs a synchronise."""
    print('[timing] phase %-10s %.3fs' % (label, seconds), file=sys.stderr,
          flush=True)


def _run_pipeline(args, device_name):
    device = resolve_devices(device_name)    # raises without a card
    # The process group must exist before the streaming branch: with both
    # --stream and a coordinator set, each rank streams its own record
    # range.
    mh = multihost.maybe_init()
    # Under PORECHOP_TPU_FORCE_HOST every job runs on the host: no card is
    # looked for.
    on_cards = device_name is None and not force_host()
    if mh:
        if on_cards:
            device = [multihost.rank_device()]
        if multihost.rank() > 0:
            args.print_dest = open(os.devnull, 'w')
    elif on_cards:
        device = mesh.local_devices()
    chunk_size = stream_mod.stream_chunk_size(args)
    if chunk_size:
        return _run_streaming_pipeline(args, chunk_size, device, mh)

    # Multi-process: each rank counts records cheaply, then parses only its
    # contiguous block; the detection stats merge globally.  Rank 0
    # re-emits the full reference transcript: at -v 1 from global
    # counters, at -v >= 2 with the per-read dumps gathered from all ranks
    # in read order.
    with spans.phase('load', _mark):
        if mh:
            reads, check_reads, read_type, n_total, n_check = \
                multihost.load_reads_block(args.input, args.verbosity,
                                           args.print_dest, args.check_reads)
        else:
            reads, check_reads, read_type = load_reads(args.input,
                                                       args.verbosity,
                                                       args.print_dest,
                                                       args.check_reads)
            n_check = len(check_reads)
    with spans.phase('detect', _mark):
        matching_sets, forward_or_reverse_barcodes = _find_adapter_sets(
            args, check_reads, n_check, device, mh)
    phase_verbosity = 0 if mh else args.verbosity

    if matching_sets:
        with spans.phase('endtrim', _mark):
            check_barcodes = (args.barcode_dir is not None)
            dumps2 = find_adapters_at_read_ends(
                reads, matching_sets, phase_verbosity,
                args.end_size, args.extra_end_trim, args.end_threshold,
                args.scoring_scheme_vals, args.print_dest,
                args.min_trim_size, args.threads, check_barcodes,
                args.barcode_threshold, args.barcode_diff,
                args.require_two_barcodes, forward_or_reverse_barcodes,
                device=device, collect_dumps=args.verbosity if mh else 0)
            display_read_end_trimming_summary(reads, phase_verbosity,
                                              args.print_dest)
        with spans.phase('middle', _mark):
            dumps3 = []
            if not args.no_split:
                dumps3 = find_adapters_in_read_middles(
                    reads, matching_sets, phase_verbosity,
                    args.middle_threshold, args.extra_middle_trim_good_side,
                    args.extra_middle_trim_bad_side,
                    args.scoring_scheme_vals, args.print_dest, args.threads,
                    args.discard_middle, device=device,
                    collect_dumps=args.verbosity if mh else 0)
                display_read_middle_trimming_summary(
                    reads, args.discard_middle, phase_verbosity,
                    args.print_dest)
            if mh:
                _print_phase_text(args, matching_sets, trim_counts(reads),
                                  n_total, dumps2, dumps3)
    else:
        with spans.phase('middle', _mark):
            if args.verbosity > 0:
                print('No adapters found - output reads are unchanged '
                      'from input reads\n', file=args.print_dest)

    with spans.phase('output', _mark):
        if mh:
            multihost.output_and_merge(reads, args, read_type)
        else:
            output_reads(reads, args.format, args.output, read_type,
                         args.verbosity, args.discard_middle,
                         args.min_split_read_size, args.print_dest,
                         args.barcode_dir, args.input, args.untrimmed,
                         args.threads, args.discard_unassigned)


def _find_adapter_sets(args, check_reads, n_check, device, mh):
    """Phase 1 and the set surgery after it; returns (matching_sets,
    forward_or_reverse_barcodes).  In a multi-process run, check_reads is
    this rank's slice of the n_check sample reads, the stats merge across
    ranks and rank 0 prints the phase's text after the merge."""
    # The prefilter may zero a sub-threshold side's score; barcode runs sum
    # both sides' scores (choose_barcoding_kit), so they need exact ones.
    matching_sets = find_matching_adapter_sets(
        check_reads, 0 if mh else args.verbosity, args.end_size,
        args.scoring_scheme_vals, args.print_dest, args.adapter_threshold,
        args.threads,
        exact_scores=args.verbosity > 0 or args.barcode_dir is not None,
        device=device,
        stats_merge=multihost.merge_detection_stats if mh else None)
    if mh and args.verbosity > 0:
        print_detection_block(n_check, args.print_dest)
    matching_sets = fix_up_1d2_sets(matching_sets)
    forward_or_reverse_barcodes = None
    if args.barcode_dir:
        forward_or_reverse_barcodes = choose_barcoding_kit(matching_sets,
                                                           args.verbosity,
                                                           args.print_dest)
    display_adapter_set_results(matching_sets, args.verbosity,
                                args.print_dest)
    matching_sets = add_full_barcode_adapter_sets(matching_sets)
    if args.verbosity > 0:
        print('\n', file=args.print_dest)
    return matching_sets, forward_or_reverse_barcodes


def _print_phase_text(args, matching_sets, counts, n_total, dumps2=(),
                      dumps3=()):
    """A multi-process run's phase-2 and phase-3 transcript on rank 0, from
    this rank's trim_counts summed over ranks (-v 1) or with every rank's
    dump lines in read order (-v 2+).  Every rank calls it."""
    if args.verbosity == 0:
        return
    tot = [int(x) for x in multihost.sum_across_ranks(counts)]
    dest = args.print_dest
    if args.verbosity == 1:
        print_end_trim_block(matching_sets, n_total, tot, dest)
        if not args.no_split:
            print_middle_block(n_total, tot[4], args.discard_middle,
                               args.threads, dest)
        return
    # The dumps stream into print_dest on rank 0 with bounded memory
    # (chunked allgather rounds; see gather_text_blocks).
    print_end_trim_header(matching_sets, dest)
    multihost.gather_text_blocks(''.join(line + '\n' for line in dumps2),
                                 sink=dest)
    print('', file=dest)
    end_trim_summary_counts(n_total, *tot[:4], dest)
    if not args.no_split:
        verb = 'Discarding' if args.discard_middle else 'Splitting'
        print(bold_underline(verb + ' reads containing middle adapters'),
              file=dest)
        multihost.gather_text_blocks(''.join(line + '\n' for line in dumps3),
                                     sink=dest)
        dest.flush()
        middle_summary_counts(tot[4], n_total, args.discard_middle, dest)


def _run_streaming_pipeline(args, chunk_size, device, mh):
    """Bounded-memory path (--stream <chunk> or PORECHOP_TPU_STREAM, -v 0/1):
    detection on the --check_reads sample (file head, or per-file heads for
    Albacore-style directory input), then chunked phases 2+3 + output.
    Byte-identical to the default path (v1 totals come from a cheap
    record-counting pre-pass).

    Multi-process: each rank streams only its contiguous record block into
    a part, detection runs on its slice of the sample with the stats
    merged across ranks, and rank 0 merges the parts and prints the
    transcript from counters summed over ranks.

    The phase spans: load (the counting pre-pass, the sample and each
    chunk's parse), detect, and per chunk endtrim, middle and output (its
    write; the transcript and the files' closing after the last chunk)."""
    with spans.phase('load'):
        read_type = stream_mod.input_read_type(args.input)
        n_total = None
        if mh or args.verbosity > 0:
            n_total = stream_mod.count_records(args.input)
        if args.verbosity > 0:
            stream_mod.print_load_text(args.input, args.print_dest,
                                       total=n_total)
        check_range = None
        if mh:
            _, n_check = stream_mod.collect_check_reads(
                args.input, args.check_reads, record_range=(0, 0))
            check_range = multihost.block_slice(n_check)
        check_reads, n_check = stream_mod.collect_check_reads(
            args.input, args.check_reads, record_range=check_range)
    with spans.phase('detect'):
        matching_sets, forward_or_reverse_barcodes = _find_adapter_sets(
            args, check_reads, n_check, device, mh)
    if not mh:
        stream_mod.run_streaming(args, matching_sets,
                                 forward_or_reverse_barcodes, read_type,
                                 chunk_size, total_reads=n_total,
                                 device=device)
        _mark_phase_sums()
        return

    block = multihost.block_slice(n_total)
    counts = []

    def write_block(dest_path, plain):
        part_args = copy.copy(args)
        part_args.format = plain
        part_args.verbosity = 0
        if args.barcode_dir is not None:
            part_args.barcode_dir = dest_path
        else:
            part_args.output = dest_path
        block_counts, bins = stream_mod.run_streaming(
            part_args, matching_sets, forward_or_reverse_barcodes,
            read_type, chunk_size, record_range=block, device=device)
        counts.extend(block_counts)
        return bins

    def phase_text():
        if matching_sets:
            _print_phase_text(args, matching_sets, counts, n_total)
        elif args.verbosity > 0:
            print('No adapters found - output reads are unchanged from '
                  'input reads\n', file=args.print_dest)

    multihost.write_block_and_merge(args, read_type, write_block,
                                    pre_merge_hook=phase_text)
    _mark_phase_sums()


def _mark_phase_sums():
    """A --stream run's five phase lines, each phase summed over the
    run's chunks (pipeline/stream.py records them per chunk)."""
    sums = spans.phase_seconds()
    if sums is not None:
        for label in spans.PHASES:
            _mark(label, sums.get(label, 0.0))


def get_arguments(argv=None):
    default_threads = min(multiprocessing.cpu_count(), 16)

    parser = argparse.ArgumentParser(
        description='Porechop: a tool for finding adapters in Oxford '
                    'Nanopore reads, trimming them from the ends and '
                    'splitting reads with internal adapters',
        formatter_class=TrimmerHelpFormatter, add_help=False)
    main_group = parser.add_argument_group('Main options')
    main_group.add_argument('-i', '--input', required=True,
                            help='FASTA/FASTQ of input reads or a directory which will be '
                                 'recursively searched for FASTQ files (required)')
    main_group.add_argument('-o', '--output',
                            help='Filename for FASTA or FASTQ of trimmed reads (if not set, '
                                 'trimmed reads will be printed to stdout)')
    main_group.add_argument('--format', choices=['auto', 'fasta', 'fastq', 'fasta.gz', 'fastq.gz'],
                            default='auto',
                            help='Output format for the reads - if auto, the '
                                 'format will be chosen based on the output filename or the input '
                                 'read format')
    main_group.add_argument('-v', '--verbosity', type=int, default=1,
                            help='Level of progress information: 0 = none, 1 = some, 2 = lots, '
                                 '3 = full - output will go to stdout if reads are saved to '
                                 'a file and stderr if reads are printed to stdout')
    main_group.add_argument('-t', '--threads', type=int, default=default_threads,
                            help='Number of threads to use for adapter alignment')

    barcode_group = parser.add_argument_group('Barcode binning settings',
                                              'Control the binning of reads based on barcodes '
                                              '(i.e. barcode demultiplexing)')
    barcode_group.add_argument('-b', '--barcode_dir',
                               help='Reads will be binned based on their barcode and saved to '
                                    'separate files in this directory (incompatible with '
                                    '--output)')
    barcode_group.add_argument('--barcode_threshold', type=float, default=75.0,
                               help='A read must have at least this percent identity to a barcode '
                                    'to be binned')
    barcode_group.add_argument('--barcode_diff', type=float, default=5.0,
                               help="If the difference between a read's best barcode identity and "
                                    "its second-best barcode identity is less than this value, it "
                                    "will not be put in a barcode bin (to exclude cases which are "
                                    "too close to call)")
    barcode_group.add_argument('--require_two_barcodes', action='store_true',
                               help='Reads will only be put in barcode bins if they have a strong '
                                    'match for the barcode on both their start and end (default: '
                                    'a read can be binned with a match at its start or end)')
    barcode_group.add_argument('--untrimmed', action='store_true',
                               help='Bin reads but do not trim them (default: trim the reads)')
    barcode_group.add_argument('--discard_unassigned', action='store_true',
                               help='Discard unassigned reads (instead of creating a "none" bin)')

    adapter_search_group = parser.add_argument_group('Adapter search settings',
                                                     'Control how the program determines which '
                                                     'adapter sets are present')
    adapter_search_group.add_argument('--adapter_threshold', type=float, default=90.0,
                                      help='An adapter set has to have at least this percent '
                                           'identity to be labelled as present and trimmed off '
                                           '(0 to 100)')
    adapter_search_group.add_argument('--check_reads', type=int, default=10000,
                                      help='This many reads will be aligned to all possible '
                                           'adapters to determine which adapter sets are present')
    adapter_search_group.add_argument('--scoring_scheme', type=str, default='3,-6,-5,-2',
                                      help='Comma-delimited string of alignment scores: match, '
                                           'mismatch, gap open, gap extend')

    end_trim_group = parser.add_argument_group('End adapter settings',
                                               'Control the trimming of adapters from read ends')
    end_trim_group.add_argument('--end_size', type=int, default=150,
                                help='The number of base pairs at each end of the read which will '
                                     'be searched for adapter sequences')
    end_trim_group.add_argument('--min_trim_size', type=int, default=4,
                                help='Adapter alignments smaller than this will be ignored')
    end_trim_group.add_argument('--extra_end_trim', type=int, default=2,
                                help='This many additional bases will be removed next to adapters '
                                     'found at the ends of reads')
    end_trim_group.add_argument('--end_threshold', type=float, default=75.0,
                                help='Adapters at the ends of reads must have at least this '
                                     'percent identity to be removed (0 to 100)')

    middle_trim_group = parser.add_argument_group('Middle adapter settings',
                                                  'Control the splitting of read from middle '
                                                  'adapters')
    middle_trim_group.add_argument('--no_split', action='store_true',
                                   help='Skip splitting reads based on middle adapters '
                                        '(default: split reads when an adapter is found in the '
                                        'middle)')
    middle_trim_group.add_argument('--discard_middle', action='store_true',
                                   help='Reads with middle adapters will be discarded (default: '
                                        'reads with middle adapters are split) (required for '
                                        'reads to be used with Nanopolish, this option is on by '
                                        'default when outputting reads into barcode bins)')
    middle_trim_group.add_argument('--middle_threshold', type=float, default=90.0,
                                   help='Adapters in the middle of reads must have at least this '
                                        'percent identity to be found (0 to 100)')
    middle_trim_group.add_argument('--extra_middle_trim_good_side', type=int, default=10,
                                   help='This many additional bases will be removed next to '
                                        'middle adapters on their "good" side')
    middle_trim_group.add_argument('--extra_middle_trim_bad_side', type=int, default=100,
                                   help='This many additional bases will be removed next to '
                                        'middle adapters on their "bad" side')
    middle_trim_group.add_argument('--min_split_read_size', type=int, default=1000,
                                   help='Post-split read pieces smaller than this many base pairs '
                                        'will not be outputted')

    # Hidden (help-suppressed, to keep --help byte-parity with the
    # reference): the torch device the alignments run on, or device
    # entries, comma-separated (default: the local CUDA cards).
    main_group.add_argument('--device', default=None, help=argparse.SUPPRESS)
    # Hidden: bounded-memory streaming with this many reads per chunk.
    # Equivalent to PORECHOP_TPU_STREAM=<n>.  See pipeline/stream.py.
    main_group.add_argument('--stream', type=int, default=None,
                            help=argparse.SUPPRESS)

    help_args = parser.add_argument_group('Help')
    help_args.add_argument('-h', '--help', action='help', default=argparse.SUPPRESS,
                           help='Show this help message and exit')
    help_args.add_argument('--version', action='version', version=__version__,
                           help="Show program's version number and exit")

    args = parser.parse_args(argv)

    try:
        scoring_scheme = [int(x) for x in args.scoring_scheme.split(',')]
    except ValueError:
        sys.exit('Error: incorrectly formatted scoring scheme')
    if len(scoring_scheme) != 4:
        sys.exit('Error: incorrectly formatted scoring scheme')
    args.scoring_scheme_vals = scoring_scheme

    if args.barcode_dir is not None and args.output is not None:
        sys.exit('Error: only one of the following options may be used: '
                 '--output, --barcode_dir')

    if args.untrimmed and args.barcode_dir is None:
        sys.exit('Error: --untrimmed can only be used with --barcode_dir')

    if args.barcode_dir is not None:
        args.discard_middle = True

    if args.output is None and args.barcode_dir is None:
        args.print_dest = sys.stderr
    else:
        args.print_dest = sys.stdout

    if args.threads < 1:
        sys.exit('Error: at least one thread required')

    return args


if __name__ == '__main__':
    main()
