"""Terminal text utilities: ANSI colours, aligned number formatting, the
table renderer and the argparse help formatter.

Output bytes must match the reference implementation exactly (the black-box
CLI tests diff captured stdout/stderr): reference porechop/misc.py:25-57
(number formatting), :171-324 (table + colours), :327-358 (line breaks +
help formatter).
"""

import argparse
import os
import re
import shutil
import textwrap

END_FORMATTING = '\033[0m'
BOLD = '\033[1m'
UNDERLINE = '\033[4m'
RED = '\033[31m'
GREEN = '\033[32m'
YELLOW = '\033[93m'
DIM = '\033[2m'

_ANSI_RE = re.compile('\033.*?m')


def red(text):
    return RED + text + END_FORMATTING


def yellow(text):
    return YELLOW + text + END_FORMATTING


def bold_underline(text):
    return BOLD + UNDERLINE + text + END_FORMATTING


def remove_formatting(text):
    return _ANSI_RE.sub('', text)


def len_without_format(text):
    return len(remove_formatting(text))


def colour(text, spec):
    """Apply a colour spec like 'green', 'bold underline', 'red bold'."""
    spec = spec or ''
    bold = 'bold' in spec
    underline = 'underline' in spec
    base = spec.replace('bold', '').replace('underline', '')
    base = base.replace('_', '').replace(' ', '').lower()
    prefix = ''
    for name, code in (('red', RED), ('green', GREEN),
                       ('yellow', YELLOW), ('dim', DIM)):
        if name in base:
            prefix = code
            break
    if bold:
        prefix += BOLD
    if underline:
        prefix += UNDERLINE
    if not prefix:
        return text
    return prefix + text + END_FORMATTING


def int_to_str(num, max_num=0):
    """Thousands-separated integer, right-padded to the width of max_num."""
    num_str = 'n/a' if num is None else '{:,}'.format(num)
    return num_str.rjust(len('{:,}'.format(int(max_num))))


def float_to_str(num, decimals, max_num=0):
    if decimals == 0:
        return int_to_str(int(round(num)), max_num=max_num)
    if num is None:
        num_str = 'n/a'
    else:
        whole, frac = ('%.{}f'.format(decimals) % num).split('.')
        num_str = int_to_str(int(whole)) + '.' + frac
    if max_num > 0:
        num_str = num_str.rjust(len(float_to_str(max_num, decimals)))
    return num_str


def add_line_breaks_to_sequence(sequence, line_length):
    """Wrap a sequence at line_length columns; always ends with a newline."""
    if not sequence:
        return '\n'
    chunks = [sequence[p:p + line_length]
              for p in range(0, len(sequence), line_length)]
    return '\n'.join(chunks) + '\n'


def print_table(table, print_dest, alignments='', max_col_width=30,
                col_separation=3, indent=2, row_colour=None, sub_colour=None,
                row_extra_text=None, leading_newline=False,
                subsequent_indent='', return_str=False,
                header_format='underline', hide_header=False,
                fixed_col_widths=None, left_align_header=True,
                bottom_align_header=True):
    """Render a list-of-rows table with the reference's exact layout rules
    (column sizing, wrapping, alignment, colour handling, underline removal
    on wrapped header lines)."""
    n_cols = len(table[0])
    table = [row[:n_cols] + [''] * (n_cols - len(row)) for row in table]
    row_colour = row_colour or {}
    sub_colour = sub_colour or {}
    row_extra_text = row_extra_text or {}
    if leading_newline:
        print('', file=print_dest)

    alignments = (alignments + 'L' * n_cols)[:n_cols]

    if fixed_col_widths is not None:
        col_widths = fixed_col_widths
    else:
        col_widths = [0] * n_cols
        for row in table:
            col_widths = [min(max(col_widths[i], len_without_format(cell)),
                              max_col_width)
                          for i, cell in enumerate(row)]

    separator = ' ' * col_separation
    indenter = ' ' * indent
    out = ''
    for i, row in enumerate(table):
        row = [str(cell) for cell in row]
        if hide_header and i == 0:
            continue
        if fixed_col_widths is not None:
            wrapped = [textwrap.TextWrapper(subsequent_indent=subsequent_indent,
                                            width=w).wrap(cell)
                       for cell, w in zip(row, fixed_col_widths)]
        else:
            wrapper = textwrap.TextWrapper(subsequent_indent=subsequent_indent,
                                           width=max_col_width)
            wrapped = [wrapper.wrap(cell) for cell in row]
        height = max(len(c) for c in wrapped)
        if i == 0 and bottom_align_header:
            wrapped = [[''] * (height - len(c)) + c for c in wrapped]
        for j in range(height):
            cells = [c[j] if j < len(c) else '' for c in wrapped]
            parts = []
            for value, width, align in zip(cells, col_widths, alignments):
                if align == 'L' or (i == 0 and left_align_header):
                    parts.append(value.ljust(width))
                elif align == 'C':
                    parts.append(value.center(width))
                else:
                    parts.append(value.rjust(width))
            line = separator.join(parts)
            if i in row_extra_text:
                line += row_extra_text[i]
            if i == 0 and header_format:
                line = colour(line, header_format)
            if i in row_colour:
                line = colour(line, row_colour[i])
            for text, cname in sub_colour.items():
                line = line.replace(text, colour(text, cname))
            if j < height - 1 and UNDERLINE in line:
                line = re.sub('\033\\[4m', '', line)
            if return_str:
                out += indenter + line + '\n'
            else:
                print(indenter + line, flush=True, file=print_dest)
    if return_str:
        return out


class TrimmerHelpFormatter(argparse.HelpFormatter):
    """Help formatter that appends '(default: X)' to option help and adapts
    to the terminal width (reference misc.py:341-358)."""

    def __init__(self, prog):
        terminal_width = shutil.get_terminal_size().columns
        os.environ['COLUMNS'] = str(terminal_width)
        max_help_position = min(max(24, terminal_width // 3), 40)
        super().__init__(prog, max_help_position=max_help_position)

    def _get_help_string(self, action):
        help_text = action.help
        if (action.default != argparse.SUPPRESS
                and 'default' not in help_text.lower()
                and action.default is not None):
            help_text += ' (default: ' + str(action.default) + ')'
        return help_text
