"""Output writer: format resolution, stdout/file/barcode-bin routing and
compression (reference porechop.py:607-734).  The output section's text
and the bins' compression and table are shared with the streamed and
multi-process runs (pipeline/stream.py, parallel/multihost.py)."""

from __future__ import annotations

import os
import shutil
import subprocess
from collections import defaultdict

from ..utils.text import bold_underline, int_to_str, print_table


def resolve_format(out_format, output, read_type, barcode_dir,
                   input_filename):
    """The reference's output-format election (porechop.py:624-638):
    explicit --format, else output-filename substrings, else input type."""
    if out_format != 'auto':
        return out_format
    if output is None:
        out_format = read_type.lower()
        if barcode_dir is not None and input_filename.lower().endswith('.gz'):
            out_format += '.gz'
        return out_format
    if '.fasta.gz' in output.lower():
        return 'fasta.gz'
    if '.fastq.gz' in output.lower():
        return 'fastq.gz'
    if '.fasta' in output.lower():
        return 'fasta'
    if '.fastq' in output.lower():
        return 'fastq'
    return read_type.lower()


def gzip_command_for(threads, verbosity, print_dest=None):
    """pigz -p N when available, else gzip (porechop.py:645-651)."""
    if shutil.which('pigz'):
        if verbosity > 0:
            print('pigz found - using it to compress instead of gzip')
        return 'pigz -p ' + str(threads)
    if verbosity > 0:
        print('pigz not found - using gzip to compress')
    return 'gzip'


def gzip_into(gzip_command, src, dst):
    """Compresses the plain file src into dst and removes src."""
    subprocess.check_output(gzip_command + ' -c ' + src + ' > ' + dst,
                            stderr=subprocess.STDOUT, shell=True)
    os.remove(src)


def print_output_banner(untrimmed, barcode_dir, output, print_dest):
    """The output section's heading (porechop.py:607-616)."""
    trimmed_or_untrimmed = 'untrimmed' if untrimmed else 'trimmed'
    if barcode_dir is not None:
        verb, destination = 'Saving ', 'barcode-specific files'
    elif output is None:
        verb, destination = 'Outputting ', 'stdout'
    else:
        verb, destination = 'Saving ', 'file'
    print(bold_underline(verb + trimmed_or_untrimmed + ' reads to '
                         + destination), flush=True, file=print_dest)


def print_output_done(output, print_dest):
    """The output section's last line for stdout or -o output."""
    if output is None:
        print('Done', flush=True, file=print_dest)
    else:
        print('\nSaved result to ' + os.path.abspath(output), file=print_dest)


def finish_bins(bins, barcode_dir, plain_format, gzipped, gzip_command,
                verbosity, print_dest):
    """Compresses each written bin file when the format asks for it and
    prints the table of reads and bases per bin (porechop.py:679-704);
    bins = {name: (reads, bases)}."""
    table = [['Barcode', 'Reads', 'Bases', 'File']]
    for name in sorted(bins):
        bin_filename = os.path.join(barcode_dir, name + '.' + plain_format)
        if gzipped:
            if not os.path.isfile(bin_filename):
                continue
            bin_filename_gz = bin_filename + '.gz'
            if os.path.isfile(bin_filename_gz):
                os.remove(bin_filename_gz)
            try:
                subprocess.check_output(gzip_command + ' ' + bin_filename,
                                        stderr=subprocess.STDOUT, shell=True)
            except subprocess.CalledProcessError:
                pass                     # the reference ignores this failure
            bin_filename = bin_filename_gz
        table.append([name, int_to_str(bins[name][0]),
                      int_to_str(bins[name][1]), bin_filename])
    if verbosity > 0:
        print('')
        print_table(table, print_dest, alignments='LRRL', max_col_width=60,
                    col_separation=2)


def output_reads(reads, out_format, output, read_type, verbosity,
                 discard_middle, min_split_size, print_dest, barcode_dir,
                 input_filename, untrimmed, threads, discard_unassigned,
                 return_counts=False):
    if verbosity > 0:
        print_output_banner(untrimmed, barcode_dir, output, print_dest)

    out_format = resolve_format(out_format, output, read_type, barcode_dir,
                                input_filename)

    gzipped_out = False
    gzip_command = 'gzip'
    if out_format.endswith('.gz') and (barcode_dir is not None
                                       or output is not None):
        gzipped_out = True
        out_format = out_format[:-3]
        gzip_command = gzip_command_for(threads, verbosity, print_dest)

    if barcode_dir is not None:
        counts = _output_to_bins(reads, out_format, verbosity, discard_middle,
                                 min_split_size, print_dest, barcode_dir,
                                 untrimmed, gzipped_out, gzip_command,
                                 discard_unassigned)
        if return_counts:
            return counts
    elif output is None:
        for read in reads:
            read_str = (read.get_fasta(min_split_size, discard_middle)
                        if out_format == 'fasta'
                        else read.get_fastq(min_split_size, discard_middle))
            print(read_str, end='')
        if verbosity > 0:
            print_output_done(output, print_dest)
    else:
        if gzipped_out:
            out_filename = 'TEMP_' + str(os.getpid()) + '.fastq'
        else:
            out_filename = output
        with open(out_filename, 'wt') as out:
            for read in reads:
                read_str = (read.get_fasta(min_split_size, discard_middle)
                            if out_format == 'fasta'
                            else read.get_fastq(min_split_size, discard_middle))
                out.write(read_str)
        if gzipped_out:
            gzip_into(gzip_command, out_filename, output)
        if verbosity > 0:
            print_output_done(output, print_dest)

    if verbosity > 0:
        print('', flush=True, file=print_dest)


def _output_to_bins(reads, out_format, verbosity, discard_middle,
                    min_split_size, print_dest, barcode_dir, untrimmed,
                    gzipped_out, gzip_command, discard_unassigned):
    """Writes the reads into one file per barcode; returns the
    {name: (reads, bases)} counts (the multi-process merge adds them up)."""
    if not os.path.isdir(barcode_dir):
        os.makedirs(barcode_dir)
    barcode_files = {}
    barcode_read_counts = defaultdict(int)
    barcode_base_counts = defaultdict(int)
    for read in reads:
        barcode_name = read.barcode_call
        if discard_unassigned and barcode_name == 'none':
            continue
        if out_format == 'fasta':
            read_str = read.get_fasta(min_split_size, discard_middle, untrimmed)
        else:
            read_str = read.get_fastq(min_split_size, discard_middle, untrimmed)
        if not read_str:
            continue
        if barcode_name not in barcode_files:
            barcode_files[barcode_name] = open(
                os.path.join(barcode_dir, barcode_name + '.' + out_format), 'wt')
        barcode_files[barcode_name].write(read_str)
        barcode_read_counts[barcode_name] += 1
        if untrimmed:
            seq_length = len(read.seq)
        else:
            seq_length = read.seq_length_with_start_end_adapters_trimmed()
        barcode_base_counts[barcode_name] += seq_length

    for f in barcode_files.values():
        f.close()
    bins = {name: (barcode_read_counts[name], barcode_base_counts[name])
            for name in barcode_files}
    finish_bins(bins, barcode_dir, out_format, gzipped_out, gzip_command,
                verbosity, print_dest)
    return bins
