"""The process's largest resident size during the window (MiB), sampled
from /proc/self/statm every 5 ms from the window's start to its end."""

UNIT = 'MiB'
SOURCE = 'host_clock'


def read(rec):
    peak = rec.get('peak_rss_bytes')
    return None if not peak else peak / 2 ** 20
