"""Per-read state and serialization.

The batch pipeline stores alignment work in dense arrays (ops/dispatch.py);
this module holds the per-read host state those results scatter into: trim
amounts, middle-adapter intervals, barcode scores, and the exact
serialization / verbosity-formatting semantics of the reference
(porechop/nanopore_read.py:21-473).

A deliberate departure from the reference: middle trim/adapter positions are
kept as merged half-open intervals instead of Python sets of positions —
identical semantics (a set built from range() updates IS a union of
intervals), O(hits) instead of O(read length) memory, and interval splitting
replaces the reference's per-character split loop
(nanopore_read.py:76-95)."""

from __future__ import annotations

from ..utils.text import (END_FORMATTING, RED, YELLOW,
                          add_line_breaks_to_sequence, red, yellow)


def merge_intervals(ranges):
    """Union of half-open [s, e) intervals, sorted and merged."""
    out = []
    for s, e in sorted(ranges):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intervals_contain(ranges, pos):
    for s, e in ranges:
        if s <= pos < e:
            return True
        if s > pos:
            return False
    return False


class Read:
    """One input read and its trimming state (reference nanopore_read.py)."""

    __slots__ = ('name', 'seq', 'quals', 'rna', 'albacore_barcode_call',
                 'start_trim_amount', 'end_trim_amount',
                 'start_adapter_alignments', 'end_adapter_alignments',
                 'middle_adapter_ranges', 'middle_trim_ranges',
                 'middle_hit_str', 'start_barcode_scores',
                 'end_barcode_scores', 'best_start_barcode',
                 'best_end_barcode', 'second_best_start_barcode',
                 'second_best_end_barcode', 'barcode_call')

    def __init__(self, name, seq, quals):
        self.name = name
        self.seq = seq.upper()
        # RNA detection: more U than T -> treat as RNA, align as DNA
        # (nanopore_read.py:26-31); mapped back to U on output.  DNA reads
        # have zero Us, so counting Ts (a full second scan per read) only
        # happens when a U was actually seen.
        u_count = self.seq.count('U')
        if u_count and u_count > self.seq.count('T'):
            self.rna = True
            self.seq = self.seq.replace('U', 'T')
        else:
            self.rna = False
        self.quals = quals
        if len(quals) < len(seq):
            self.quals += '+' * (len(seq) - len(quals))
        self.start_trim_amount = 0
        self.end_trim_amount = 0
        self.start_adapter_alignments = []
        self.end_adapter_alignments = []
        self.middle_adapter_ranges = []
        self.middle_trim_ranges = []
        self.middle_hit_str = ''
        self.start_barcode_scores = {}
        self.end_barcode_scores = {}
        self.best_start_barcode = ('none', 0.0)
        self.best_end_barcode = ('none', 0.0)
        self.second_best_start_barcode = ('none', 0.0)
        self.second_best_end_barcode = ('none', 0.0)
        self.barcode_call = 'none'
        self.albacore_barcode_call = None

    # ---- trimming ----

    def get_seq_with_start_end_adapters_trimmed(self):
        if not self.start_trim_amount and not self.end_trim_amount:
            return self.seq
        return self.seq[self.start_trim_amount:len(self.seq) - self.end_trim_amount]

    def seq_length_with_start_end_adapters_trimmed(self):
        return len(self.get_seq_with_start_end_adapters_trimmed())

    def get_quals_with_start_end_adapters_trimmed(self):
        if not self.start_trim_amount and not self.end_trim_amount:
            return self.quals
        return self.quals[self.start_trim_amount:len(self.quals) - self.end_trim_amount]

    @property
    def has_middle_hits(self):
        return bool(self.middle_adapter_ranges)

    def add_middle_hit(self, adapter_name, read_start, read_end, full_score,
                       extra_good, extra_bad, start_names, end_names):
        """Record one middle-adapter occurrence (nanopore_read.py:224-241).
        read_end is exclusive (already +1 adjusted)."""
        self.middle_adapter_ranges = merge_intervals(
            self.middle_adapter_ranges + [(read_start, read_end)])
        self.middle_hit_str += ('  ' + adapter_name + ' (read coords: '
                                + str(read_start) + '-' + str(read_end) + ', '
                                + 'identity: ' + '%.1f' % full_score + '%)\n')
        trim_start = read_start - extra_good
        if adapter_name in start_names:
            trim_start = read_start - extra_bad
        trim_end = read_end + extra_good
        if adapter_name in end_names:
            trim_end = read_end + extra_bad
        self.middle_trim_ranges = merge_intervals(
            self.middle_trim_ranges + [(trim_start, trim_end)])

    def get_split_read_parts(self, min_split_read_size):
        """Split the end-trimmed read at middle-trim intervals; drop short
        parts.  Interval-based equivalent of nanopore_read.py:76-95."""
        seq = self.get_seq_with_start_end_adapters_trimmed()
        quals = self.get_quals_with_start_end_adapters_trimmed()
        n = len(seq)
        parts = []
        pos = 0
        for s, e in self.middle_trim_ranges:
            s = max(s, 0)
            e = min(e, n)
            if e <= s:
                continue
            if s > pos:
                parts.append((seq[pos:s], quals[pos:s]))
            pos = max(pos, e)
        if pos < n:
            parts.append((seq[pos:], quals[pos:]))
        return [p for p in parts if len(p[0]) >= min_split_read_size]

    # ---- serialization (nanopore_read.py:97-147) ----

    def get_fasta(self, min_split_read_size, discard_middle, untrimmed=False):
        if not self.middle_trim_ranges_nonempty():
            seq = self.seq if untrimmed \
                else self.get_seq_with_start_end_adapters_trimmed()
            if not seq:
                return ''
            if self.rna:
                seq = seq.replace('T', 'U')
            return ''.join(['>', self.name, '\n',
                            add_line_breaks_to_sequence(seq, 70)])
        if discard_middle:
            return ''
        out = ''
        for i, part in enumerate(self.get_split_read_parts(min_split_read_size)):
            read_name = add_number_to_read_name(self.name, i + 1)
            if not part[0]:
                return ''
            seq = add_line_breaks_to_sequence(part[0], 70)
            if self.rna:
                seq = seq.replace('T', 'U')
            out += ''.join(['>', read_name, '\n', seq])
        return out

    def get_fastq(self, min_split_read_size, discard_middle, untrimmed=False):
        if not self.middle_trim_ranges_nonempty():
            if untrimmed:
                seq, quals = self.seq, self.quals
            else:
                seq = self.get_seq_with_start_end_adapters_trimmed()
                quals = self.get_quals_with_start_end_adapters_trimmed()
            if not seq:
                return ''
            if self.rna:
                seq = seq.replace('T', 'U')
            return ''.join(['@', self.name, '\n', seq, '\n+\n', quals, '\n'])
        if discard_middle:
            return ''
        out = ''
        for i, part in enumerate(self.get_split_read_parts(min_split_read_size)):
            read_name = add_number_to_read_name(self.name, i + 1)
            seq, qual = part
            if not seq:
                return ''
            if self.rna:
                seq = seq.replace('T', 'U')
            out += ''.join(['@', read_name, '\n', seq, '\n+\n', qual, '\n'])
        return out

    def middle_trim_ranges_nonempty(self):
        """Mirrors `if not self.middle_trim_positions` — the reference
        branches on TRIM positions, not adapter positions
        (nanopore_read.py:98,123)."""
        return bool(self.middle_trim_ranges)

    # ---- verbosity formatting (nanopore_read.py:245-397) ----

    def formatted_start_seq(self, end_size, extra_trim_size):
        start_seq = self.seq[:end_size]
        if not self.start_trim_amount:
            return start_seq
        red_bases = self.start_trim_amount - extra_trim_size
        out = red(start_seq[:red_bases]) if red_bases else ''
        out += yellow(start_seq[red_bases:red_bases + extra_trim_size])
        out += start_seq[red_bases + extra_trim_size:]
        return out

    def formatted_end_seq(self, end_size, extra_trim_size):
        # Slice expressions mirror nanopore_read.py:260-273 verbatim,
        # including the red_bases == 0 corner where `[-x:-0]` is empty.
        end_seq = self.seq[-end_size:]
        if not self.end_trim_amount:
            return end_seq
        red_bases = self.end_trim_amount - extra_trim_size
        out = red(end_seq[-red_bases:]) if red_bases else ''
        out = yellow(end_seq[-(red_bases + extra_trim_size):-red_bases]) + out
        out = end_seq[:-(red_bases + extra_trim_size)] + out
        return out

    def formatted_whole_seq(self, extra_trim_size):
        if not self.start_trim_amount and not self.end_trim_amount:
            return self.seq
        red_start, red_end = 0, 0
        if self.start_trim_amount:
            red_start = self.start_trim_amount - extra_trim_size
        if self.end_trim_amount:
            red_end = self.end_trim_amount - extra_trim_size
        if red_start + red_end >= len(self.seq):
            return red(self.seq)
        start_part = red(self.seq[:red_start]) if self.start_trim_amount else ''
        end_part = red(self.seq[-red_end:]) if self.end_trim_amount else ''
        middle = self.seq[red_start:len(self.seq) - red_end]
        if len(middle) <= extra_trim_size * 2:
            middle = yellow(middle)
        else:
            if self.start_trim_amount:
                middle = yellow(middle[:extra_trim_size]) + middle[extra_trim_size:]
            if self.end_trim_amount:
                middle = middle[:-extra_trim_size] + yellow(middle[-extra_trim_size:])
        return start_part + middle + end_part

    def formatted_start_and_end_seq(self, end_size, extra_trim_size, check_barcodes):
        out = ''
        if check_barcodes:
            out += 'start: %s (%.1f%%), ' % self.best_start_barcode
            out += 'end: %s (%.1f%%), ' % self.best_end_barcode
            out += 'barcode call: ' + self.barcode_call + '   '
        if len(self.seq) <= 2 * end_size:
            out += self.formatted_whole_seq(extra_trim_size)
        else:
            out += (self.formatted_start_seq(end_size, extra_trim_size) + '...'
                    + self.formatted_end_seq(end_size, extra_trim_size))
        return out

    def full_start_end_output(self, end_size, extra_trim_size, check_barcodes):
        def aln_str(aln):
            return (aln[0].name + ', full score=' + str(aln[1])
                    + ', partial score=' + str(aln[2]) + ', read position: '
                    + str(aln[3]) + '-' + str(aln[4]))
        out = self.name + '\n'
        out += '  start: ' + self.formatted_start_seq(end_size, extra_trim_size) + '...\n'
        if self.start_adapter_alignments:
            out += '    start alignments:\n'
            for a in self.start_adapter_alignments:
                out += '      ' + aln_str(a) + '\n'
        out += '  end:   ...' + self.formatted_end_seq(end_size, extra_trim_size) + '\n'
        if self.end_adapter_alignments:
            out += '    end alignments:\n'
            for a in self.end_adapter_alignments:
                out += '      ' + aln_str(a) + '\n'
        if check_barcodes:
            out += '  Barcodes:\n'
            out += '    start barcodes:        ' + ', '.join(
                '%s (%.1f%%)' % b for b in self.start_barcode_scores.items()) + '\n'
            out += '    end barcodes:          ' + ', '.join(
                '%s (%.1f%%)' % b for b in self.end_barcode_scores.items()) + '\n'
            out += '    best start barcode:    %s (%.1f%%)\n' % self.best_start_barcode
            out += '    best end barcode:      %s (%.1f%%)\n' % self.best_end_barcode
            if self.albacore_barcode_call is not None:
                out += '    albacore barcode call: ' + self.albacore_barcode_call + '\n'
            out += '    final barcode call:    ' + self.barcode_call + '\n'
        return out

    def formatted_middle_seq(self):
        if not self.middle_adapter_ranges:
            return
        seq = self.get_seq_with_start_end_adapters_trimmed()
        trim_min = min(s for s, _ in self.middle_trim_ranges)
        trim_max = max(e - 1 for _, e in self.middle_trim_ranges)
        range_start = max(0, trim_min - 100)
        range_end = min(len(seq), trim_max + 100)
        out = '' if range_start == 0 else '(' + str(range_start) + ' bp)...'
        last_colour = None
        for i in range(range_start, range_end):
            char_colour = None
            if intervals_contain(self.middle_trim_ranges, i):
                char_colour = 'yellow'
            if intervals_contain(self.middle_adapter_ranges, i):
                char_colour = 'red'
            if char_colour != last_colour:
                out += END_FORMATTING
                if char_colour == 'yellow':
                    out += YELLOW
                if char_colour == 'red':
                    out += RED
            out += seq[i]
            last_colour = char_colour
        if last_colour is not None:
            out += END_FORMATTING
        if range_end != len(seq):
            out += '...(' + str(len(seq) - range_end) + ' bp)'
        return out

    def middle_adapter_results(self, verbosity):
        if not self.middle_adapter_ranges:
            return ''
        results = self.name + '\n' + self.middle_hit_str
        if verbosity > 1:
            results += self.formatted_middle_seq() + '\n'
        return results


def add_number_to_read_name(read_name, number):
    """Split-part naming (nanopore_read.py:494-498)."""
    if ' ' not in read_name:
        return read_name + '_' + str(number)
    return read_name.replace(' ', '_' + str(number) + ' ', 1)
