"""Command-line interface (counterpart of porechop_tpu/cli.py).

Flags, defaults, validation rules, help semantics and output routing mirror
the reference CLI exactly (porechop/porechop.py:33-221); the compute behind
them runs on batched device launches instead of a host thread pool.  The
--threads flag is accepted for compatibility; it controls output compression
(pigz) parallelism, while alignment parallelism comes from batching.

The alignments run on the CUDA card unless the caller asks for another
device: main(argv, device=...) or the hidden --device flag.
"""

import argparse
import multiprocessing
import sys

from .ops.dispatch import resolve_device
from .pipeline.output import output_reads
from .pipeline.phases import (add_full_barcode_adapter_sets,
                              choose_barcoding_kit,
                              display_adapter_set_results,
                              display_read_end_trimming_summary,
                              display_read_middle_trimming_summary,
                              find_adapters_at_read_ends,
                              find_adapters_in_read_middles,
                              find_matching_adapter_sets, fix_up_1d2_sets,
                              load_reads)
from .utils.text import TrimmerHelpFormatter
from .version import __version__


def main(argv=None, device=None):
    """Runs the trimmer.  device: where the alignments run (a torch device
    or its name); default the --device flag, else the CUDA card."""
    args = get_arguments(argv)
    _run_pipeline(args, resolve_device(device if device is not None
                                       else args.device))


def _run_pipeline(args, device):
    reads, check_reads, read_type = load_reads(args.input, args.verbosity,
                                               args.print_dest,
                                               args.check_reads)
    # The prefilter may zero a sub-threshold side's score; barcode runs sum
    # both sides' scores (choose_barcoding_kit), so they need exact ones.
    exact_scores = args.verbosity > 0 or args.barcode_dir is not None
    matching_sets = find_matching_adapter_sets(check_reads, args.verbosity,
                                               args.end_size,
                                               args.scoring_scheme_vals,
                                               args.print_dest,
                                               args.adapter_threshold,
                                               args.threads,
                                               exact_scores=exact_scores,
                                               device=device)
    matching_sets = fix_up_1d2_sets(matching_sets)

    if args.barcode_dir:
        forward_or_reverse_barcodes = choose_barcoding_kit(matching_sets,
                                                           args.verbosity,
                                                           args.print_dest)
    else:
        forward_or_reverse_barcodes = None

    display_adapter_set_results(matching_sets, args.verbosity, args.print_dest)
    matching_sets = add_full_barcode_adapter_sets(matching_sets)

    if args.verbosity > 0:
        print('\n', file=args.print_dest)

    if matching_sets:
        check_barcodes = (args.barcode_dir is not None)
        find_adapters_at_read_ends(
            reads, matching_sets, args.verbosity,
            args.end_size, args.extra_end_trim, args.end_threshold,
            args.scoring_scheme_vals, args.print_dest, args.min_trim_size,
            args.threads, check_barcodes, args.barcode_threshold,
            args.barcode_diff, args.require_two_barcodes,
            forward_or_reverse_barcodes, device=device)
        display_read_end_trimming_summary(reads, args.verbosity,
                                          args.print_dest)
        if not args.no_split:
            find_adapters_in_read_middles(
                reads, matching_sets, args.verbosity,
                args.middle_threshold, args.extra_middle_trim_good_side,
                args.extra_middle_trim_bad_side, args.scoring_scheme_vals,
                args.print_dest, args.threads, args.discard_middle,
                device=device)
            display_read_middle_trimming_summary(reads, args.discard_middle,
                                                 args.verbosity,
                                                 args.print_dest)
    elif args.verbosity > 0:
        print('No adapters found - output reads are unchanged from input reads\n',
              file=args.print_dest)

    output_reads(reads, args.format, args.output, read_type,
                 args.verbosity, args.discard_middle,
                 args.min_split_read_size, args.print_dest,
                 args.barcode_dir, args.input, args.untrimmed,
                 args.threads, args.discard_unassigned)


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
    # reference): the torch device the alignments run on (default: cuda).
    main_group.add_argument('--device', default=None, help=argparse.SUPPRESS)

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
