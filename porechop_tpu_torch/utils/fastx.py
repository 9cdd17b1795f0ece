"""FASTA/FASTQ input: compression sniffing, format detection and fast
whole-file record parsing.

Behavioural contract (error messages, record tuples, tolerance of blank
lines) matches reference porechop/misc.py:60-168, but parsing is done with
bulk byte operations instead of per-line Python iteration — a 1M-read FASTQ
parses in seconds.
"""

import gzip
import os
import sys


def get_compression_type(filename):
    """Sniff compression from magic bytes; gz is supported, bz2/zip are
    rejected with the reference's exact error text."""
    magic = {'gz': b'\x1f\x8b\x08', 'bz2': b'\x42\x5a\x68',
             'zip': b'\x50\x4b\x03\x04'}
    with open(filename, 'rb') as f:
        start = f.read(max(len(m) for m in magic.values()))
    kind = 'plain'
    for name, m in magic.items():
        if start.startswith(m):
            kind = name
    if kind == 'bz2':
        sys.exit('Error: cannot use bzip2 format - use gzip instead')
    if kind == 'zip':
        sys.exit('Error: cannot use zip format - use gzip instead')
    return kind


def _read_all(filename):
    if get_compression_type(filename) == 'gz':
        with gzip.open(filename, 'rb') as f:
            return f.read()
    with open(filename, 'rb') as f:
        return f.read()


def get_sequence_file_type(filename):
    if not os.path.isfile(filename):
        sys.exit('Error: could not find ' + filename)
    if get_compression_type(filename) == 'gz':
        open_func = gzip.open
    else:
        open_func = open
    with open_func(filename, 'rt') as f:
        try:
            first_char = f.read(1)
        except UnicodeDecodeError:
            first_char = ''
    if first_char == '>':
        return 'FASTA'
    if first_char == '@':
        return 'FASTQ'
    raise ValueError('File is neither FASTA or FASTQ')


def load_fasta_or_fastq(filename):
    """Returns (records, 'FASTA'|'FASTQ').  FASTA records are
    (short_name, seq, full_name); FASTQ records are
    (short_name, seq, spacer, quals, full_name)."""
    try:
        kind = get_sequence_file_type(filename)
        if kind == 'FASTA':
            return load_fasta(filename), 'FASTA'
        return load_fastq(filename), 'FASTQ'
    except IndexError:
        sys.exit('\nError: ' + filename
                 + ' could not be parsed - is it formatted correctly?')


def load_fasta(filename):
    data = _read_all(filename)
    records = []
    name = None
    seq_parts = []
    for raw in data.split(b'\n'):
        line = raw.strip()
        if not line:
            continue
        if line[:1] == b'>':
            if name:  # empty-name records are dropped, as in the reference
                full = name.decode()
                records.append((full.split()[0], b''.join(seq_parts).decode(), full))
            seq_parts = []
            name = line[1:]
        elif name is not None:
            seq_parts.append(line)
        else:
            seq_parts.append(line)  # leading junk: matches reference accumulation
    if name:
        full = name.decode()
        records.append((full.split()[0], b''.join(seq_parts).decode(), full))
    return records


def load_fastq(filename):
    data = _read_all(filename)
    lines = data.split(b'\n')
    if lines and lines[-1] == b'':
        lines.pop()
    records = []
    n_full = len(lines) // 4
    for k in range(n_full):
        header = lines[4 * k].strip()
        full_name = header[1:].decode()
        short_name = full_name.split()[0]  # IndexError on blank -> parse error
        records.append((short_name,
                        lines[4 * k + 1].strip().decode(),
                        lines[4 * k + 2].strip().decode(),
                        lines[4 * k + 3].strip().decode(),
                        full_name))
    if len(lines) % 4:  # ragged tail: reference raises via next()/IndexError
        header = lines[4 * n_full].strip()
        _ = header[1:].decode().split()[0]
        raise IndexError('truncated FASTQ record')
    return records
